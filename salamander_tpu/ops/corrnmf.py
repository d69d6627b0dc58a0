"""Correlated-NMF kernels: exposures, sufficient statistics, ELBO, closed-form
scaling updates, and vmap-batched Newton solves for the embeddings.

Numeric semantics match /root/reference/src/salamander/models/_utils_corrnmf.py:
  compute_exposures        :11-25
  compute_aux              :28-52   aux[k,d] = sum_v x_vd p_vkd without
                                    materializing p
  elbo_corrnmf             :55-100
  update_signature_scalings:103-138 closed form
  update_sample_scalings   :141-179 closed form (data_mat is samples x features
                                    as actually called, the reference docstring
                                    notwithstanding)
  objective/gradient/hessian_embedding + update_embedding :182-410

The reference optimizes each embedding with a separate scipy Newton-CG call
inside a Python loop over rows (models/corrnmf_det.py:103-141) - its dominant
bottleneck. Here a single damped-Newton solver runs for ALL rows at once via
vmap: each step solves an (m,m) SPD system per row (m = dim_embeddings, tiny)
with an Armijo-backtracking line search, honoring scipy's stopping rule
(sum|update| < dim * xtol) and the reference's maxiter=3 cap for sample
embeddings. The surrogate is strictly convex (Hessian = sum_i e_i o_i o_i^T
+ I/var, SPD), so both solvers share the unique optimum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .klnmf import EPSILON, poisson_llh
from .precision import mm, omm

# scipy.optimize's Newton-CG 'avextol' default; threshold is dim * XTOL.
XTOL = 1e-5

# Newton-step products run at full f32 precision. A reduced-precision f32
# matmul (bf16 passes, TF32) has relative error ~1e-3; the embedding
# Hessian is sum_k rates_k o_k o_k^T + I/var with rates ~1e4-1e5, so that
# roundoff swamps the I/var term whenever the rates outer-product sum is
# rank-deficient over the active dims - the computed Hessian then goes
# INDEFINITE (and asymmetric) and every Cholesky-based solve NaNs through
# sqrt. These are (M, m) x (m,) sized products with m = dim_embeddings
# <= ~10, so full precision is cheap.
from .precision import OBJECTIVE_PRECISION as _HIGHEST  # noqa: E402


def compute_exposures(signature_scalings, sample_scalings,
                      signature_embeddings, sample_embeddings):
    """Exposure matrix (n_samples, n_signatures):
    exp(sigma_k + tau_d + <l_k, u_d>), the refactored CorrNMF exposures."""
    logits = (
        signature_scalings[:, None]
        + sample_scalings[None, :]
        + mm(signature_embeddings, sample_embeddings.T)
    )
    return jnp.exp(logits).T


def compute_aux(data_mat, signatures_mat, exposures_mat):
    """Sufficient statistic aux[k,d] = sum_v x_vd p_vkd, (n_signatures, n_samples).

    data_mat: (D,V) counts; signatures_mat: (K,V); exposures_mat: (D,K).
    """
    ratios = data_mat / mm(exposures_mat, signatures_mat)  # (D, V)
    return exposures_mat.T * mm(signatures_mat, ratios.T)  # (K, D)


def elbo_corrnmf(data_mat, signatures_mat, exposures_mat,
                 signature_embeddings, sample_embeddings, variance,
                 penalize_sample_embeddings: bool = True):
    """Evidence lower bound: Poisson likelihood minus Gaussian embedding
    penalties. Sample penalty is optional so multimodal CorrNMF can add the
    shared-sample term exactly once."""
    n_signatures, dim_embeddings = signature_embeddings.shape
    n_samples = sample_embeddings.shape[0]
    log_norm = jnp.log(2.0 * jnp.pi * variance)
    elbo = poisson_llh(data_mat.T, signatures_mat.T, exposures_mat.T)
    elbo -= 0.5 * dim_embeddings * n_signatures * log_norm
    elbo -= jnp.sum(signature_embeddings**2) / (2.0 * variance)
    if penalize_sample_embeddings:
        elbo -= 0.5 * dim_embeddings * n_samples * log_norm
        elbo -= jnp.sum(sample_embeddings**2) / (2.0 * variance)
    return elbo


def update_signature_scalings(aux, sample_scalings,
                              signature_embeddings, sample_embeddings):
    """Closed-form M-step for the signature scalings sigma (K,)."""
    observed = jnp.sum(aux, axis=1)
    predicted = jnp.sum(
        jnp.exp(sample_scalings[None, :]
                + mm(signature_embeddings, sample_embeddings.T)),
        axis=1,
    )
    return jnp.log(observed) - jnp.log(predicted)


def update_sample_scalings(data_mat, signature_scalings,
                           signature_embeddings, sample_embeddings):
    """Closed-form M-step for the sample scalings tau (D,).

    data_mat: (D, V) counts (samples are rows, as in the model layer).
    """
    observed = jnp.sum(data_mat, axis=1)
    predicted = jnp.sum(
        jnp.exp(signature_scalings[:, None]
                + mm(signature_embeddings, sample_embeddings.T)),
        axis=0,
    )
    return jnp.log(observed) - jnp.log(predicted)


def update_variance(signature_embeddings, sample_embeddings):
    """M-step for the shared embedding variance: mean of all squared entries,
    floored at EPSILON (reference models/corrnmf_det.py:60-69)."""
    total = jnp.sum(signature_embeddings**2) + jnp.sum(sample_embeddings**2)
    count = signature_embeddings.size + sample_embeddings.size
    return jnp.maximum(total / count, EPSILON)


def embedding_objective(embedding, embeddings_other, scaling, scalings_other,
                        variance, aux_vector):
    """NEGATIVE surrogate objective of one embedding (reference :182-239).

    'scaling' may be a scalar or, for multimodal sample embeddings, a vector
    aligned with 'scalings_other'.
    """
    products = omm(embeddings_other, embedding)
    value = jnp.dot(products, aux_vector, precision=_HIGHEST)
    value -= jnp.sum(jnp.exp(scaling + scalings_other + products))
    value -= jnp.dot(embedding, embedding, precision=_HIGHEST) / (2.0 * variance)
    return -value


def embedding_gradient(embedding, embeddings_other, scaling, scalings_other,
                       variance, aux_vector):
    """Gradient of the NEGATIVE surrogate objective (reference :242-293)."""
    rates = jnp.exp(scaling + scalings_other + omm(embeddings_other, embedding))
    linear_term = omm(aux_vector, embeddings_other)
    return -linear_term + omm(embeddings_other.T, rates) + embedding / variance


def embedding_hessian(embedding, embeddings_other, scaling, scalings_other,
                      variance, aux_vector=None):
    """Hessian of the NEGATIVE surrogate objective (reference :296-351):
    sum_i e_i o_i o_i^T + I/var - symmetric positive definite."""
    rates = jnp.exp(scaling + scalings_other + omm(embeddings_other, embedding))
    dim = embedding.shape[0]
    return (
        omm((embeddings_other * rates[:, None]).T, embeddings_other)
        + jnp.eye(dim, dtype=embedding.dtype) / variance
    )


# Reference-named twins (models/_utils_corrnmf.py:182-351). The objective
# shares the reference signature exactly; the reference's gradient/hessian
# take PRECOMPUTED per-row terms (summand_grad = aux_vector @
# embeddings_other; outer_prods = per-row o_i o_i^T) because its host EM
# cycle reuses them across Newton iterations - here the fused recompute
# inside embedding_gradient/_hessian avoids materializing a (rows, m, m)
# tensor, so these adapters exist for API parity and porting.
objective_function_embedding = embedding_objective


def gradient_embedding(embedding, embeddings_other, scaling, scalings_other,
                       variance, summand_grad):
    """Reference-convention gradient (models/_utils_corrnmf.py:242-293):
    `summand_grad` is the precomputed linear term aux_vector @
    embeddings_other of this row."""
    rates = jnp.exp(scaling + scalings_other + omm(embeddings_other, embedding))
    return -summand_grad + omm(embeddings_other.T, rates) + embedding / variance


def hessian_embedding(embedding, embeddings_other, scaling, scalings_other,
                      variance, outer_prods_embeddings_other):
    """Reference-convention Hessian (models/_utils_corrnmf.py:296-351):
    `outer_prods_embeddings_other` is the precomputed
    (rows, dim, dim) stack of o_i o_i^T outer products."""
    rates = jnp.exp(scaling + scalings_other + omm(embeddings_other, embedding))
    dim = embedding.shape[0]
    return (
        jnp.einsum("i,ijk->jk", rates, outer_prods_embeddings_other,
                   precision=_HIGHEST)
        + jnp.eye(dim, dtype=embedding.dtype) / variance
    )


def _cholesky_solve_unrolled(hess, grad):
    """SPD solve by a fully UNROLLED scalar Cholesky + two substitutions.

    No linalg custom call: a batch of tiny factorizations as a library
    call is one more kernel per Newton step (see _solve_spd_small), and
    any Cholesky of a not-quite-SPD matrix NaNs through sqrt. The static
    dim is tiny (dim_embeddings, <= ~10), so the unrolled scalar
    arithmetic is branch-free elementwise work that vmaps cleanly.

    Pivots are floored at EPSILON * hess[i, i] (the diagonal is strictly
    positive, >= 1/variance): a Hessian that is SPD in exact arithmetic
    can reach this solve indefinite after finite-precision products (the
    m-padded Newton systems are rank-k + I/var with condition ~1e4-1e5,
    where rank deficiency puts roundoff on the same scale as the smallest
    eigenvalue). A floored pivot yields an inexact but FINITE descent-ish
    direction that the Armijo backtracking then vets - exactly how the
    dim<=3 Cramer solves already degrade."""
    n = grad.shape[0]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = hess[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, EPSILON * hess[i, i]))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = grad[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def _solve_spd_small(hess, grad):
    """Solve hess @ x = grad for the tiny SPD Newton systems.

    jnp.linalg.solve lowers batched 2x2 systems to an LU custom call;
    closed-form Cramer solves for dim <= 3 are branch-free vectorized
    arithmetic that fuses with its neighbours, and larger dims use an
    unrolled custom-call-free Cholesky (the Hessian is SPD by
    construction).
    """
    dim = grad.shape[0]
    if dim == 1:
        return grad / hess[0, 0]
    if dim == 2:
        a, b, c, d = hess[0, 0], hess[0, 1], hess[1, 0], hess[1, 1]
        det = a * d - b * c
        return jnp.stack([
            (d * grad[0] - b * grad[1]) / det,
            (a * grad[1] - c * grad[0]) / det,
        ])
    if dim == 3:
        cofactor_00 = hess[1, 1] * hess[2, 2] - hess[1, 2] * hess[2, 1]
        cofactor_01 = hess[1, 2] * hess[2, 0] - hess[1, 0] * hess[2, 2]
        cofactor_02 = hess[1, 0] * hess[2, 1] - hess[1, 1] * hess[2, 0]
        det = (hess[0, 0] * cofactor_00 + hess[0, 1] * cofactor_01
               + hess[0, 2] * cofactor_02)
        adjugate = jnp.array([
            [cofactor_00,
             hess[0, 2] * hess[2, 1] - hess[0, 1] * hess[2, 2],
             hess[0, 1] * hess[1, 2] - hess[0, 2] * hess[1, 1]],
            [cofactor_01,
             hess[0, 0] * hess[2, 2] - hess[0, 2] * hess[2, 0],
             hess[0, 2] * hess[1, 0] - hess[0, 0] * hess[1, 2]],
            [cofactor_02,
             hess[0, 1] * hess[2, 0] - hess[0, 0] * hess[2, 1],
             hess[0, 0] * hess[1, 1] - hess[0, 1] * hess[1, 0]],
        ])
        return omm(adjugate, grad) / det
    return _cholesky_solve_unrolled(hess, grad)


# Armijo halvings until the serial backtracking's step floor: the reference
# loop shrinks t by 0.5 while t > 1e-12, so t visits 2^0 .. 2^-40 and stops
# at 2^-40 (~9.1e-13) unconditionally.
_N_BACKTRACK = 41

# Newton-step caps at or below this unroll into straight-line masked steps
# instead of an early-exit while_loop. The while_loop synchronizes every
# batched row on the slowest one (and stalls multi-start batching - round-1
# CorrNMF multi-start gained only 1.4x); a short fixed schedule does the same
# masked updates with uniform, fully-batchable work per EM cycle.
_UNROLL_NEWTON_LIMIT = 4


def _newton_update_single(embedding0, embeddings_other, offsets, linear_term,
                          variance, max_iter: int, xtol_total: float):
    """Minimize the negative surrogate for ONE embedding with damped Newton.

    offsets: (M,) = scaling + scalings_other, the exponent constant terms.
    linear_term: (m,) = sum_i aux_i * o_i.
    Stops (scipy-style) when the applied update has sum|update| < xtol_total,
    or after max_iter Newton steps.

    The Armijo backtracking is a VECTORIZED candidate search instead of a
    nested while_loop: all halvings 2^0..2^-40 are evaluated at once (a tiny
    (41, M) batch of exponentials) and the first one satisfying the Armijo
    condition is selected - the same step the serial loop would accept, with
    no data-dependent inner control flow to serialize batched rows.
    """
    dim = embedding0.shape[0]
    eye = jnp.eye(dim, dtype=embedding0.dtype)
    ts = 0.5 ** jnp.arange(_N_BACKTRACK, dtype=embedding0.dtype)

    def step(carry):
        b, done, iteration = carry
        rates = jnp.exp(
            offsets + jnp.matmul(embeddings_other, b, precision=_HIGHEST)
        )  # (M,)
        grad = (
            -linear_term
            + jnp.matmul(embeddings_other.T, rates, precision=_HIGHEST)
            + b / variance
        )
        hess = (
            jnp.matmul((embeddings_other * rates[:, None]).T,
                       embeddings_other, precision=_HIGHEST)
            + eye / variance
        )
        direction = -_solve_spd_small(hess, grad)
        f0 = (-jnp.dot(linear_term, b, precision=_HIGHEST)
              + jnp.sum(rates)
              + jnp.dot(b, b, precision=_HIGHEST) / (2.0 * variance))
        slope = jnp.dot(grad, direction, precision=_HIGHEST)

        candidates = b[None, :] + ts[:, None] * direction[None, :]  # (41, m)
        f_cand = (
            -jnp.matmul(candidates, linear_term, precision=_HIGHEST)
            + jnp.sum(jnp.exp(jnp.matmul(candidates, embeddings_other.T,
                                         precision=_HIGHEST)
                              + offsets[None, :]), axis=1)
            + jnp.sum(candidates * candidates, axis=1) / (2.0 * variance)
        )
        ok = f_cand <= f0 + 1e-4 * ts * slope
        ok = ok.at[-1].set(True)  # the step floor accepts 2^-40 regardless
        t = ts[jnp.argmax(ok)]

        update = t * direction
        b_new = jnp.where(done, b, b + update)
        done_new = done | (jnp.sum(jnp.abs(update)) < xtol_total)
        return b_new, done_new, iteration + 1

    carry = (embedding0, jnp.zeros((), bool), jnp.zeros((), jnp.int32))
    if max_iter <= _UNROLL_NEWTON_LIMIT:
        # fixed masked schedule (e.g. the reference's sample-side maxiter=3):
        # identical results to the early-exit loop, uniform batched work
        for _ in range(max_iter):
            carry = step(carry)
        return carry[0]

    def keep_going(carry):
        _, done, iteration = carry
        return ~done & (iteration < max_iter)

    # Early-exit while_loop: converged rows stop paying for Newton steps
    # (under vmap the loop runs until the slowest row converges, typically
    # ~5-10 steps, instead of a fixed max_iter).
    b, _, _ = jax.lax.while_loop(keep_going, step, carry)
    return b


def update_embeddings_newton_cg(embeddings0, embeddings_other, scalings,
                                scalings_other, variance, aux_mat,
                                max_iter: int | None = None):
    """Host-side scipy Newton-CG twin of update_embeddings for the opt-in
    compatibility mode: per-row scipy.optimize.minimize(method='Newton-CG')
    exactly as the reference runs it (_utils_corrnmf.py:354-410,
    corrnmf_det.py:103-141), including the truncated-CG forcing sequence and
    Wolfe line search scipy applies internally. Slow (a Python loop of scipy
    calls) but auditable: traces match the reference bit-for-bit given the
    same inputs.

    max_iter None = scipy's default (the reference's signature-side call);
    max_iter=3 = the reference's sample-side options={'maxiter': 3}.
    """
    import numpy as np
    from scipy import optimize

    embeddings0 = np.asarray(embeddings0, dtype=float)
    embeddings_other = np.asarray(embeddings_other, dtype=float)
    scalings = np.asarray(scalings, dtype=float)
    scalings_other = np.asarray(scalings_other, dtype=float)
    aux_mat = np.asarray(aux_mat, dtype=float)
    variance = float(variance)
    options = None if max_iter is None else {"maxiter": int(max_iter)}

    outer_prods = np.einsum(
        "Km,Kn->Kmn", embeddings_other, embeddings_other
    )
    result = np.empty_like(embeddings0)
    for row in range(embeddings0.shape[0]):
        scaling = scalings[row]
        aux_vec = aux_mat[row]
        summand_grad = np.sum(aux_vec[:, None] * embeddings_other, axis=0)

        def fun(b):
            products = embeddings_other @ b
            value = np.dot(products, aux_vec)
            value -= np.sum(np.exp(scaling + scalings_other + products))
            value -= np.dot(b, b) / (2.0 * variance)
            return -value

        def grad(b):
            rates = np.exp(scaling + scalings_other + embeddings_other @ b)
            return -summand_grad + embeddings_other.T @ rates + b / variance

        def hess(b):
            rates = np.exp(scaling + scalings_other + embeddings_other @ b)
            return (
                np.sum(rates[:, None, None] * outer_prods, axis=0)
                + np.eye(b.shape[0]) / variance
            )

        solution = optimize.minimize(
            fun=fun, x0=embeddings0[row], method="Newton-CG",
            jac=grad, hess=hess, options=options,
        ).x
        solution[(0 < solution) & (solution < EPSILON)] = EPSILON
        solution[(-EPSILON < solution) & (solution < 0)] = -EPSILON
        result[row] = solution
    return result


def _clamp_away_from_zero(embeddings):
    """Push magnitudes in (0, EPSILON) out to +-EPSILON, keeping exact zeros
    (reference _utils_corrnmf.py:408-409)."""
    tiny_pos = (embeddings > 0) & (embeddings < EPSILON)
    tiny_neg = (embeddings < 0) & (embeddings > -EPSILON)
    return jnp.where(tiny_pos, EPSILON, jnp.where(tiny_neg, -EPSILON, embeddings))


def update_embeddings(embeddings0, embeddings_other, scalings, scalings_other,
                      variance, aux_mat, max_iter: int = 100,
                      xtol_total=None):
    """Batched Newton update of N embeddings at once.

    embeddings0:      (N, m) initial values (rows optimized independently)
    embeddings_other: (M, m) the fixed opposite-side embeddings
    scalings:         (N,) or (N, M) own scaling per row (vector form for the
                      multimodal joint sample update)
    scalings_other:   (M,)
    aux_mat:          (N, M) rows/columns of the sufficient statistic
    max_iter:         Newton-step cap; 3 mirrors the reference's sample-side
                      scipy options {"maxiter": 3}.
    xtol_total:       scipy-style stopping threshold (sum|update| below it
                      stops); defaults to m * XTOL. The m-padded rank scan
                      passes the ACTIVE dimension's threshold as a traced
                      scalar so a padded lane stops exactly where the
                      unpadded program would (zero-padded dims contribute
                      zero to both the update and its 1-norm).
    """
    dim = embeddings0.shape[1]
    if xtol_total is None:
        xtol_total = dim * XTOL
    linear_terms = jnp.matmul(
        aux_mat, embeddings_other, precision=_HIGHEST
    )  # (N, m)
    if scalings.ndim == 1:
        offsets = scalings[:, None] + scalings_other[None, :]
    else:
        offsets = scalings + scalings_other[None, :]

    solve = jax.vmap(
        lambda b0, off, lin: _newton_update_single(
            b0, embeddings_other, off, lin, variance, max_iter, xtol_total
        )
    )
    result = solve(embeddings0, offsets, linear_terms)
    return _clamp_away_from_zero(result)


# --------------------------------------------------------------------- #
# rank-masked twins: several CorrNMF problems of different rank k share
# ONE compiled program of padded rank Kp (the K-padded rank-scan
# mechanism, mirroring klnmf.make_masked_step_functions)
# --------------------------------------------------------------------- #

# Padded signature scalings sit at this value: exp(NEG_PAD_SCALING + x)
# underflows to EXACTLY 0.0 in both float32 (underflow below ~-104) and
# float64 (below ~-745) for any realistic scaling offset x (scalings are
# log-scale, |x| << 100), which makes the padded signatures' exposures,
# aux rows and rate terms exact zeros - so the sample-scaling, exposure,
# aux and BOTH embedding updates need no masking of their own (padded
# embedding rows start at 0 and their Newton gradient is identically 0
# there). Deliberately NOT an extreme value like -1e30: transcendental
# approximations that extract 2^x exponents through integer arithmetic
# turn magnitudes beyond int32 range into NaNs; -1e4 has the same
# exact-zero guarantee with ~100x margin and stays in every backend's
# safe range.
NEG_PAD_SCALING = -1e4


def update_variance_masked(signature_embeddings, sample_embeddings, mask,
                           m_mask=None):
    """update_variance counting only the active signatures' embeddings and
    (for m-padded lanes) only the active embedding dimensions - padded rows
    AND columns are exact zeros, so only the DENOMINATOR needs the masks."""
    total = jnp.sum(signature_embeddings**2) + jnp.sum(sample_embeddings**2)
    dim = (
        signature_embeddings.shape[1] if m_mask is None else jnp.sum(m_mask)
    )
    count = (jnp.sum(mask) + sample_embeddings.shape[0]) * dim
    return jnp.maximum(total / count, EPSILON)


def elbo_corrnmf_masked(data_mat, signatures_mat, exposures_mat,
                        signature_embeddings, sample_embeddings, variance,
                        mask, m_mask=None):
    """elbo_corrnmf with the Gaussian normalization counting only active
    signatures (and, for m-padded lanes, active embedding dimensions); all
    data and quadratic terms are exact because padded exposure columns and
    padded embedding rows/columns are exact zeros."""
    dim_embeddings = (
        signature_embeddings.shape[1] if m_mask is None else jnp.sum(m_mask)
    )
    n_samples = sample_embeddings.shape[0]
    n_active = jnp.sum(mask)
    log_norm = jnp.log(2.0 * jnp.pi * variance)
    elbo = poisson_llh(data_mat.T, signatures_mat.T, exposures_mat.T)
    elbo -= 0.5 * dim_embeddings * n_active * log_norm
    elbo -= jnp.sum(signature_embeddings**2) / (2.0 * variance)
    elbo -= 0.5 * dim_embeddings * n_samples * log_norm
    elbo -= jnp.sum(sample_embeddings**2) / (2.0 * variance)
    return elbo


def pad_rank_corrnmf(params, n_padded: int, dim_padded: int | None = None):
    """Pad a rank-k, dim-m CorrNMF parameter pytree (CorrNMFDet._device_state
    layout) to rank n_padded (and optionally embedding dimension dim_padded):
    uniform dummy signature rows, NEG_PAD_SCALING scalings, zero embedding
    rows/columns, zero exposure columns; adds the (Kp,) rank mask and the
    (mp,) dimension mask 'm_mask' (all-true when dim_padded is None).

    m-padding is exact under zero initialization: a zero-padded embedding
    dimension has identically zero gradient (its linear term, rate
    contraction and prior term all vanish), a block-diagonal Hessian row
    (I/variance), and therefore a zero Newton direction - it stays exactly
    zero forever, and every contraction over the embedding axis equals its
    m-dimensional value. This is what lets one compiled program serve an
    (n_signatures x dim_embeddings) model-selection grid
    (reference axis: /root/reference/src/salamander/models/corrnmf.py:60-63).
    """
    signatures = params["signatures"]                    # (k, V)
    k, n_features = signatures.shape
    if n_padded < k:
        raise ValueError(f"n_padded={n_padded} below rank {k}")
    extra = n_padded - k
    dtype = signatures.dtype
    dim = params["signature_embeddings"].shape[1]
    if dim_padded is None:
        dim_padded = dim
    if dim_padded < dim:
        raise ValueError(f"dim_padded={dim_padded} below dim {dim}")
    extra_dim = dim_padded - dim
    n_samples = params["sample_embeddings"].shape[0]
    padded = dict(params)
    padded["signatures"] = jnp.concatenate(
        [signatures, jnp.full((extra, n_features), 1.0 / n_features, dtype)]
    )
    padded["signature_scalings"] = jnp.concatenate(
        [params["signature_scalings"],
         jnp.full((extra,), NEG_PAD_SCALING, dtype)]
    )
    sig_emb = jnp.concatenate(
        [params["signature_embeddings"], jnp.zeros((extra, dim), dtype)]
    )
    smp_emb = params["sample_embeddings"]
    if extra_dim:
        sig_emb = jnp.concatenate(
            [sig_emb, jnp.zeros((n_padded, extra_dim), dtype)], axis=1
        )
        smp_emb = jnp.concatenate(
            [smp_emb, jnp.zeros((n_samples, extra_dim), dtype)], axis=1
        )
    padded["signature_embeddings"] = sig_emb
    padded["sample_embeddings"] = smp_emb
    padded["exposures"] = jnp.concatenate(
        [params["exposures"], jnp.zeros((n_samples, extra), dtype)], axis=1
    )
    padded["mask"] = jnp.arange(n_padded) < k
    padded["m_mask"] = jnp.arange(dim_padded) < dim
    return padded


def make_masked_corrnmf_step(signature_newton_iters: int = 100,
                             sample_newton_iters: int = 3):
    """Rank-masked CorrNMFDet EM cycle + ELBO for K-padded rank scans.

    params carry the CorrNMFDet._device_state pytree padded by
    pad_rank_corrnmf (plus 'mask'); each active lane computes the rank-k
    update with the order of CorrNMFDet._build_step (reference
    corrnmf_det.py:157-169). Padded exposures/aux/rates are EXACT zeros
    (see NEG_PAD_SCALING), so the equations are the rank-k ones - but XLA
    selects different fma/reduction kernels for different contraction
    widths, so padded and unpadded trajectories agree to ~1e-9 per cycle
    rather than bitwise, and the branchy Newton amplifies that over long
    horizons. Convergence-level equivalence (final ELBO) is pinned by
    tests/test_rank_padding.py.
    """

    def update_fn(params, data):
        X = data["X"]
        signatures = params["signatures"]
        sig_scal = params["signature_scalings"]
        sig_emb = params["signature_embeddings"]
        smp_emb = params["sample_embeddings"]
        variance = params["variance"]
        mask = params["mask"]
        m_mask = params.get("m_mask")
        # scipy-style Newton stop threshold of the ACTIVE dimension, so an
        # m-padded lane stops exactly where the unpadded program would
        xtol_total = (
            None if m_mask is None else jnp.sum(m_mask) * XTOL
        )

        smp_scal = update_sample_scalings(X, sig_scal, sig_emb, smp_emb)
        exposures = compute_exposures(sig_scal, smp_scal, sig_emb, smp_emb)
        aux = compute_aux(X, signatures, exposures)
        sig_scal = jnp.where(
            mask,
            update_signature_scalings(aux, smp_scal, sig_emb, smp_emb),
            NEG_PAD_SCALING,
        )
        sig_emb = update_embeddings(
            sig_emb, smp_emb, sig_scal, smp_scal, variance, aux,
            max_iter=signature_newton_iters, xtol_total=xtol_total,
        )
        smp_emb = update_embeddings(
            smp_emb, sig_emb, smp_scal, sig_scal, variance, aux.T,
            max_iter=sample_newton_iters, xtol_total=xtol_total,
        )
        variance = update_variance_masked(sig_emb, smp_emb, mask, m_mask)

        # KL signature update with zero-exposure padded columns guarded
        # (klnmf.update_W semantics; padded columns pass through unchanged)
        W, H = signatures.T, exposures.T
        aux_w = X.T / mm(W, H)
        W_new = W * mm(aux_w, H.T)
        W_new = W_new / jnp.where(mask, jnp.sum(W_new, axis=0), 1.0)
        W_new = jnp.maximum(W_new, EPSILON)
        signatures = jnp.where(mask[:, None], W_new.T, signatures)

        out = {
            "signatures": signatures,
            "signature_scalings": sig_scal,
            "sample_scalings": smp_scal,
            "signature_embeddings": sig_emb,
            "sample_embeddings": smp_emb,
            "variance": variance,
            "exposures": exposures,
            "mask": mask,
        }
        if m_mask is not None:
            out["m_mask"] = m_mask
        return out

    def objective_fn(params, data):
        return elbo_corrnmf_masked(
            data["X"],
            params["signatures"],
            params["exposures"],
            params["signature_embeddings"],
            params["sample_embeddings"],
            params["variance"],
            params["mask"],
            params.get("m_mask"),
        )

    return update_fn, objective_fn

"""Minimum-volume NMF kernels: volume-regularized objective, unconstrained
W update, and a backtracking line search compiled as a lax.while_loop.

Numeric semantics match the reference's numba kernels in
/root/reference/src/salamander/models/mvnmf.py:
  volume_logdet          :19-24   log det(W^T W + delta I)
  kl_divergence_penalized:27-34   KL + lam * volume
  update_W_unconstrained :37-66   Leplat-Gillis-Ang closed-form MU step with
                                  the (K,K) inverse Y = (W^T W + delta I)^-1
  line_search            :69-92   shrink gamma by 0.8 while the objective is
                                  worse (floor 1e-16), first trial is the full
                                  unconstrained step; afterwards gamma is
                                  relaxed to min(1, 1.2*gamma)

The data-dependent backtracking loop - a Python while in the reference -
compiles to a jax.lax.while_loop so the whole MvNMF iteration stays on
device. The (K,K) inverse is a trivial on-device solve (K <= ~20).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .klnmf import EPSILON, kl_divergence, normalize_wh
from .precision import mm, omm


# Largest rank for which the Gram factorizations run as UNROLLED scalar
# arithmetic instead of linalg custom calls. A tiny LU/Cholesky custom
# call is one more kernel launch per MvNMF step; the unrolled forms are
# branch-free elementwise work that fuses and vmaps cleanly (same
# rationale as ops/corrnmf._cholesky_solve_unrolled). Beyond this rank the
# unrolled code size grows as K^3 and the custom call amortizes.
_UNROLL_MAX_RANK = 24


def _chol_unrolled(gram, n: int):
    """Fully unrolled scalar Cholesky of an SPD (n, n) matrix.

    Pivots floored at EPSILON * diag (the Gram diagonal is >= delta > 0):
    finite-precision products can leave a barely-indefinite matrix whose
    sqrt would NaN; the floor keeps the factor finite, exactly like
    ops/corrnmf._cholesky_solve_unrolled."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = gram[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, EPSILON * gram[i, i]))
            else:
                L[i][j] = s / L[j][j]
    return L


def _logdet_spd_unrolled(gram, n: int):
    """log det of SPD gram via the unrolled Cholesky: 2 sum log diag(L)."""
    L = _chol_unrolled(gram, n)
    logdet = jnp.log(L[0][0])
    for i in range(1, n):
        logdet = logdet + jnp.log(L[i][i])
    return 2.0 * logdet


def _spd_inverse_unrolled(gram, n: int):
    """Inverse of SPD gram via the unrolled Cholesky:
    gram^-1 = L^-T L^-1 with L^-1 by unrolled forward substitution."""
    L = _chol_unrolled(gram, n)
    # M = L^-1 (lower triangular), column by column
    M = [[None] * n for _ in range(n)]
    for j in range(n):
        M[j][j] = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = L[i][j] * M[j][j]
            for k in range(j + 1, i):
                s = s + L[i][k] * M[k][j]
            M[i][j] = -s / L[i][i]
    # inv[a, b] = sum_{k >= max(a, b)} M[k][a] * M[k][b]
    rows = []
    for a in range(n):
        row = []
        for b in range(n):
            lo = max(a, b)
            s = M[lo][a] * M[lo][b]
            for k in range(lo + 1, n):
                s = s + M[k][a] * M[k][b]
            row.append(s)
        rows.append(jnp.stack(row))
    return jnp.stack(rows)


def _gram_logdet(gram, n: int):
    if n <= _UNROLL_MAX_RANK:
        return _logdet_spd_unrolled(gram, n)
    _, logdet = jnp.linalg.slogdet(gram)
    return logdet


def _gram_inverse(gram, n: int):
    if n <= _UNROLL_MAX_RANK:
        return _spd_inverse_unrolled(gram, n)
    eye = jnp.eye(n, dtype=gram.dtype)
    chol = jax.scipy.linalg.cho_factor(gram)
    return jax.scipy.linalg.cho_solve(chol, eye)


def volume_logdet(W, delta: float):
    """log det(W^T W + delta I) - the signature-simplex volume surrogate."""
    gram = omm(W.T, W) + delta * jnp.eye(W.shape[1], dtype=W.dtype)
    return _gram_logdet(gram, W.shape[1])


def kl_divergence_penalized(X, W, H, lam: float, delta: float):
    """The MvNMF objective: generalized KL plus lam * volume."""
    return kl_divergence(X, W, H) + lam * volume_logdet(W, delta)


def update_W_unconstrained(X, W, H, lam: float, delta: float,
                           n_given_signatures: int = 0):
    """Closed-form minimum-volume multiplicative W step (before the
    normalization line search). Given columns are frozen and left unclipped.
    """
    n_signatures = W.shape[1]
    # (W^T W + delta I) is SPD: invert via the unrolled Cholesky (the
    # reference's numba kernel uses np.linalg.inv, mvnmf.py:44; see
    # _UNROLL_MAX_RANK for why no linalg custom call)
    eye = jnp.eye(n_signatures, dtype=W.dtype)
    Y = _gram_inverse(omm(W.T, W) + delta * eye, n_signatures)
    Y_minus = jnp.maximum(0.0, -Y)
    Y_abs = jnp.abs(Y)
    WY_minus = mm(W, Y_minus)
    WY_abs = mm(W, Y_abs)

    rowsums_H = jnp.sum(H, axis=1)
    linear = rowsums_H - 4.0 * lam * WY_minus
    disc_ratio = 8.0 * lam * WY_abs * mm(X / mm(W, H), H.T)
    root = jnp.sqrt(linear**2 + disc_ratio)
    # numerator = sqrt(linear^2 + d) - linear. The reference evaluates this
    # literally (mvnmf.py:56-60), which catastrophically cancels in float32
    # when d << linear^2 (measured: 5-10% objective oscillations on PCAWG);
    # for positive `linear` use the equivalent d / (sqrt(linear^2+d)+linear),
    # which is cancellation-free. Identical in exact arithmetic.
    numerator = jnp.where(
        linear > 0.0,
        disc_ratio / (root + jnp.abs(linear)),
        root - linear,
    )
    denominator = 4.0 * lam * WY_abs
    W_new = W * numerator / denominator

    clipped = jnp.maximum(W_new, EPSILON)
    if n_given_signatures > 0:
        given = jnp.arange(n_signatures) < n_given_signatures
        return jnp.where(given[None, :], W, clipped)
    return clipped


def _renormalized_objective(X, W_trial, H, lam, delta):
    """Normalize the trial W (pushing scale into H), clip, and evaluate."""
    W_new, H_new = normalize_wh(W_trial, H)
    W_new = jnp.maximum(W_new, EPSILON)
    H_new = jnp.maximum(H_new, EPSILON)
    return W_new, H_new, kl_divergence_penalized(X, W_new, H_new, lam, delta)


def line_search(X, W, H, lam: float, delta: float, gamma, W_unconstrained,
                trial_batch: int = 1):
    """Backtracking line search on the interpolation parameter gamma.

    Carries gamma across outer iterations (the caller persists it). Returns
    (W_new, H_new, gamma_new). Fully jittable: the data-dependent
    backtracking is a lax.while_loop with carry (W, H, objective, gamma).

    trial_batch > 1 evaluates that many shrink candidates per while
    iteration as ONE batched objective pass and accepts the first trial
    satisfying the serial loop's exit rule (objective not worse, or gamma
    at the 1e-16 floor). The gamma chain is an iterated-multiply scan,
    bitwise the serial g *= 0.8, and away from accept-boundary ties the
    accepted (W, H, gamma) are bitwise the serial result; exactly AT a tie
    (a trial objective within an ulp of the previous objective - routine
    once gamma is tiny near convergence) the batched evaluation's fusion
    ulps can flip the accept by a shrink step, the same ulp class as
    separately-jitted evals of one expression. Batching removes the
    serialized per-trial objective passes (reference mvnmf.py:69-92
    re-evaluates KL per trial) at trial_batch x the FLOPs; on an
    accelerator it can land on a different f32 convergence stop, so the
    model layer defaults to serial (models/mvnmf.py).
    """
    if trial_batch <= 1:
        prev_objective = kl_divergence_penalized(X, W, H, lam, delta)
        W0, H0, of0 = _renormalized_objective(
            X, W_unconstrained, H, lam, delta
        )

        def cond(carry):
            _, _, of_value, g = carry
            return (of_value > prev_objective) & (g > 1e-16)

        def body(carry):
            _, _, _, g = carry
            g = g * 0.8
            W_trial = (1.0 - g) * W + g * W_unconstrained
            W_new, H_new, of_value = _renormalized_objective(
                X, W_trial, H, lam, delta
            )
            return W_new, H_new, of_value, g

        W_new, H_new, _, gamma = jax.lax.while_loop(
            cond, body, (W0, H0, of0, gamma)
        )
        gamma = jnp.minimum(1.0, 1.2 * gamma)
        return W_new, H_new, gamma

    # ---- batched trials -------------------------------------------------
    # The first candidate (the full unconstrained step) shares the batched
    # evaluation with the current objective and the first chunk of shrink
    # trials, so the common accept-immediately/1-2-trial case costs ONE
    # objective pass on the critical path instead of 3-4 serialized ones.
    def _shrink_chain(g):
        # bitwise-identical to the serial loop's repeated g *= 0.8
        def step(g, _):
            g = g * 0.8
            return g, g
        return jax.lax.scan(step, g, None, length=trial_batch)

    def _eval_trial(g):
        W_trial = (1.0 - g) * W + g * W_unconstrained
        return _renormalized_objective(X, W_trial, H, lam, delta)

    gamma = jnp.asarray(gamma, dtype=W.dtype)
    _, gs0 = _shrink_chain(gamma)
    W0, H0, of0 = _renormalized_objective(X, W_unconstrained, H, lam, delta)
    Ws0, Hs0, ofs0 = jax.vmap(_eval_trial)(gs0)
    prev_objective = kl_divergence_penalized(X, W, H, lam, delta)

    def _select(found_prior, W_prior, H_prior, g_prior,
                gs, Ws, Hs, ofs):
        """First-accept among this chunk's trials; prior result wins if
        the search already ended before the chunk."""
        ok = (ofs <= prev_objective) | (gs <= 1e-16)
        found = jnp.any(ok)
        idx = jnp.argmax(ok)  # first True (0 if none; masked by `found`)
        W_sel = jnp.where(found_prior, W_prior, jnp.take(Ws, idx, axis=0))
        H_sel = jnp.where(found_prior, H_prior, jnp.take(Hs, idx, axis=0))
        g_sel = jnp.where(found_prior, g_prior, jnp.take(gs, idx))
        # carry the chain forward from the chunk's last gamma when nothing
        # accepted yet (bitwise the serial loop's running g)
        g_next = jnp.where(found_prior | found, g_sel, gs[-1])
        return found_prior | found, W_sel, H_sel, g_next

    # the serial cond never runs a trial when the full step already
    # satisfies it (objective not worse) or gamma starts at the floor
    found0 = (of0 <= prev_objective) | (gamma <= 1e-16)
    carry = _select(found0, W0, H0, gamma, gs0, Ws0, Hs0, ofs0)

    def cond(carry):
        found, _, _, _ = carry
        return ~found

    def body(carry):
        found, W_cur, H_cur, g = carry
        _, gs = _shrink_chain(g)
        Ws, Hs, ofs = jax.vmap(_eval_trial)(gs)
        return _select(found, W_cur, H_cur, g, gs, Ws, Hs, ofs)

    _, W_new, H_new, gamma = jax.lax.while_loop(cond, body, carry)
    gamma = jnp.minimum(1.0, 1.2 * gamma)
    return W_new, H_new, gamma


# ---------------------------------------------------------------------------
# rank-masked twins: several MvNMF problems of different rank k share ONE
# compiled program of padded rank Kp (the K-padded rank-scan mechanism,
# mirroring klnmf.make_masked_step_functions). Padded H rows are exact
# zeros and padded W columns pass through unchanged; the volume term and
# the (Kp, Kp) inverse see an identity-padded Gram matrix, so the active
# block's logdet/inverse equal the rank-k values exactly (block-diagonal
# determinant/inverse). Reference semantics:
# /root/reference/src/salamander/models/mvnmf.py:19-92.
# ---------------------------------------------------------------------------


def _masked_gram(W, delta, mask):
    """(W^T W + delta I) with padded rows/columns replaced by identity:
    blockdiag(active Gram + delta I, I) - its logdet and inverse restrict
    exactly to the active block."""
    n_signatures = W.shape[1]
    eye = jnp.eye(n_signatures, dtype=W.dtype)
    gram = omm(W.T, W) + delta * eye
    both = mask[:, None] & mask[None, :]
    return jnp.where(both, gram, eye)


def volume_logdet_masked(W, delta, mask):
    """log det of the ACTIVE signatures' Gram block (identity padding
    contributes log det I = 0)."""
    return _gram_logdet(_masked_gram(W, delta, mask), W.shape[1])


def kl_divergence_penalized_masked(X, W, H, lam, delta, mask):
    """Rank-k MvNMF objective evaluated through the Kp-padded arrays:
    padded H rows are exact zeros (KL term exact), padded Gram rows are
    identity (volume term exact)."""
    return kl_divergence(X, W, H) + lam * volume_logdet_masked(
        W, delta, mask
    )


def update_W_unconstrained_masked(X, W, H, lam, delta, mask,
                                  n_given_signatures: int = 0):
    """update_W_unconstrained through the identity-padded Gram inverse.

    Y = blockdiag((Wa^T Wa + delta I)^-1, I): padded columns of Y are unit
    vectors, so active columns of W @ |Y| / W @ max(0, -Y) never see padded
    contributions and compute their exact rank-k update; padded W columns
    are restored unchanged."""
    n_signatures = W.shape[1]
    Y = _gram_inverse(_masked_gram(W, delta, mask), n_signatures)
    Y_minus = jnp.maximum(0.0, -Y)
    Y_abs = jnp.abs(Y)
    WY_minus = mm(W, Y_minus)
    WY_abs = mm(W, Y_abs)

    rowsums_H = jnp.sum(H, axis=1)
    linear = rowsums_H - 4.0 * lam * WY_minus
    disc_ratio = 8.0 * lam * WY_abs * mm(X / mm(W, H), H.T)
    root = jnp.sqrt(linear**2 + disc_ratio)
    # cancellation-free form, as update_W_unconstrained (REQUIRED for f32)
    numerator = jnp.where(
        linear > 0.0,
        disc_ratio / (root + jnp.abs(linear)),
        root - linear,
    )
    denominator = 4.0 * lam * WY_abs
    W_new = W * numerator / denominator

    clipped = jnp.maximum(W_new, EPSILON)
    if n_given_signatures > 0:
        given = jnp.arange(n_signatures) < n_given_signatures
        clipped = jnp.where(given[None, :], W, clipped)
    return jnp.where(mask[None, :], clipped, W)


def _renormalized_objective_masked(X, W_trial, H, lam, delta, mask):
    """normalize + clip + evaluate, keeping padded lanes EXACTLY inert:
    padded H rows stay exact zeros (the unmasked twin's EPSILON clip would
    lift them and perturb W @ H) and padded W columns bypass the
    normalization (dividing the uniform dummies by their ~1.0 float sum
    would walk them by an ulp per line-search trial)."""
    W_new, H_new = normalize_wh(W_trial, H)
    W_new = jnp.where(
        mask[None, :], jnp.maximum(W_new, EPSILON), W_trial
    )
    H_new = jnp.where(mask[:, None], jnp.maximum(H_new, EPSILON), 0.0)
    return W_new, H_new, kl_divergence_penalized_masked(
        X, W_new, H_new, lam, delta, mask
    )


def line_search_masked(X, W, H, lam, delta, gamma, W_unconstrained, mask):
    """line_search through the masked objective/renormalization. Padded W
    columns are identical in W and W_unconstrained (update_W_..._masked
    restores them), so every trial interpolation leaves them fixed; their
    column sums are 1 (uniform dummies), so normalization is a no-op on
    padded H rows too."""
    prev_objective = kl_divergence_penalized_masked(X, W, H, lam, delta, mask)
    W0, H0, of0 = _renormalized_objective_masked(
        X, W_unconstrained, H, lam, delta, mask
    )

    def cond(carry):
        _, _, of_value, g = carry
        return (of_value > prev_objective) & (g > 1e-16)

    def body(carry):
        _, _, _, g = carry
        g = g * 0.8
        W_trial = (1.0 - g) * W + g * W_unconstrained
        W_new, H_new, of_value = _renormalized_objective_masked(
            X, W_trial, H, lam, delta, mask
        )
        return W_new, H_new, of_value, g

    W_new, H_new, _, gamma = jax.lax.while_loop(
        cond, body, (W0, H0, of0, gamma)
    )
    gamma = jnp.minimum(1.0, 1.2 * gamma)
    return W_new, H_new, gamma


def make_masked_step_functions(lam: float, delta: float,
                               n_given_signatures: int = 0):
    """Rank-masked MvNMF engine step for K-padded rank scans.

    params = {"W": (V, Kp), "H": (Kp, D), "gamma": scalar, "mask": (Kp,)};
    data = {"X": (V, D)}. Each active lane computes the rank-k MvNMF
    iteration (H multiplicative update, then the min-vol W update with
    backtracking line search and per-lane persistent gamma); padded lanes
    are inert. One compiled program serves every rank of a bucket
    (parallel/restarts.py rank_scan_mvnmf)."""
    from . import klnmf as klops

    def update_fn(params, data):
        X = data["X"]
        W, H, mask = params["W"], params["H"], params["mask"]
        aux = X / mm(W, H)
        H = jnp.where(
            mask[:, None],
            jnp.maximum(H * mm(W.T, aux), klops.EPSILON),
            0.0,
        )
        W_unconstrained = update_W_unconstrained_masked(
            X, W, H, lam, delta, mask, n_given_signatures
        )
        W, H, gamma = line_search_masked(
            X, W, H, lam, delta, params["gamma"], W_unconstrained, mask
        )
        return {"W": W, "H": H, "gamma": gamma, "mask": mask}

    def objective_fn(params, data):
        return kl_divergence_penalized_masked(
            data["X"], params["W"], params["H"], lam, delta, params["mask"]
        )

    return update_fn, objective_fn

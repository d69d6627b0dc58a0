"""ARD-NMF kernels: KL-divergence NMF with automatic relevance determination.

Beyond-reference capability (the reference selects the signature count with
manual rank scans - its tutorial loops ``KLNMF(n_signatures=k)`` over a k
grid, tutorial.ipynb cell 70): ARD-NMF starts from an over-complete rank
``K_max`` and shrinks irrelevant components to zero during ONE fit, so the
active component count is inferred from the data instead of scanned for.

Algorithm: Tan & Fevotte, "Automatic relevance determination in nonnegative
matrix factorization with the beta-divergence" (IEEE TPAMI 2013), for the
beta=1 (generalized KL) case used throughout this package. Each component k
carries a relevance parameter lambda_k tying column w_k and row h_k through
either exponential (``prior='L1'``) or half-normal (``prior='L2'``) priors
with scale lambda_k, and lambda_k itself carries an inverse-gamma(a, b)
hyperprior. The MAP objective (to MINIMIZE) is

    C(W, H, lam) = D_KL(X | WH)
                   + sum_k (f(w_k) + f(h_k) + b) / lam_k
                   + c * sum_k log lam_k

with, per prior:
    L1: f(u) = sum(u)          c = V + D + a + 1
    L2: f(u) = 0.5 * sum(u^2)  c = (V + D) / 2 + a + 1

(V = n_features, D = n_samples). Sequential majorize-minimize updates
(H, then W, then the closed-form lambda) each decrease C monotonically.
Components the data does not support collapse: their w_k/h_k shrink to the
EPSILON floor and lambda_k -> b / c, the prior's resting value - counting
the lambda_k above that floor recovers the effective rank.

Conventions match ops/klnmf.py: X (V, D), W (V, K), H (K, D), lam (K,); all
functions are pure and jittable, batching over restarts is vmap over the
params pytree. The inverse-gamma hyperparameters ride in the data pytree as
``ard_ab = [a, b]`` so that one compiled program serves every (a, b) value.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .precision import mm

EPSILON = float(np.finfo(np.float32).eps)

PRIORS = ("L1", "L2")


def prior_constant(prior: str, n_features: int, n_samples: int, a):
    """The log-lambda coefficient c of the MAP objective (see module doc)."""
    if prior == "L1":
        return n_features + n_samples + a + 1.0
    if prior == "L2":
        return (n_features + n_samples) / 2.0 + a + 1.0
    raise ValueError(f"Unknown ARD prior {prior!r}: use one of {PRIORS}.")


def default_b(prior: str, mean_x: float, n_signatures: int, a: float) -> float:
    """Data-driven inverse-gamma scale b (Tan & Fevotte's moment matching):
    choose b so the prior expectation of each reconstructed entry
    E[(WH)_vd] equals the empirical mean of X.

    L1 (exponential priors, E[w h | lam] = lam^2, E[lam^2] = b^2/((a-1)(a-2))):
        K * b^2 / ((a-1)(a-2)) = mean(X)  =>  b = sqrt((a-1)(a-2) mean(X) / K)
        (requires a > 2)
    L2 (half-normal priors, E[w h | lam] = 2 lam / pi, E[lam] = b/(a-1)):
        K * 2 b / (pi (a-1)) = mean(X)    =>  b = pi (a-1) mean(X) / (2 K)
        (requires a > 1)
    """
    if prior == "L1":
        if a <= 2.0:
            raise ValueError(
                "The default b for prior='L1' needs a > 2 (finite prior "
                f"second moment); got a={a}. Pass b explicitly."
            )
        return float(np.sqrt((a - 1.0) * (a - 2.0) * mean_x / n_signatures))
    if prior == "L2":
        if a <= 1.0:
            raise ValueError(
                "The default b for prior='L2' needs a > 1 (finite prior "
                f"mean); got a={a}. Pass b explicitly."
            )
        return float(np.pi * (a - 1.0) * mean_x / (2.0 * n_signatures))
    raise ValueError(f"Unknown ARD prior {prior!r}: use one of {PRIORS}.")


def _f_norms(W, H, prior: str):
    """f(w_k) + f(h_k) per component, shape (K,)."""
    if prior == "L1":
        return jnp.sum(W, axis=0) + jnp.sum(H, axis=1)
    return 0.5 * (jnp.sum(W**2, axis=0) + jnp.sum(H**2, axis=1))


def update_lambda(W, H, ard_ab, prior: str):
    """Closed-form exact minimizer of C in lam: (f(w)+f(h)+b) / c."""
    a, b = ard_ab[0], ard_ab[1]
    c = prior_constant(prior, W.shape[0], H.shape[1], a)
    return (_f_norms(W, H, prior) + b) / c


def ard_objective(X, W, H, lam, ard_ab, prior: str):
    """The MAP objective C(W, H, lam) to minimize (module docstring).

    The KL term matches ops/klnmf.kl_divergence (X==0 terms contribute only
    +WH) so ARD fits share the package's divergence semantics exactly.
    """
    from .klnmf import kl_divergence

    a, b = ard_ab[0], ard_ab[1]
    c = prior_constant(prior, W.shape[0], H.shape[1], a)
    penalty = jnp.sum((_f_norms(W, H, prior) + b) / lam)
    return kl_divergence(X, W, H) + penalty + c * jnp.sum(jnp.log(lam))


def update_H(X, W, H, lam, prior: str):
    """MM update of H at fixed W, lam (Tan & Fevotte Alg. 1, beta=1).

    L1: H <- H * (W^T (X/WH)) / (colsum(W) + 1/lam)          (exponent 1)
    L2: H <- H * sqrt((W^T (X/WH)) / (colsum(W) + H/lam))    (exponent 1/2)
    """
    numerator = mm(W.T, X / mm(W, H))
    col_w = jnp.sum(W, axis=0)[:, None]
    if prior == "L1":
        H_new = H * numerator / (col_w + (1.0 / lam)[:, None])
    else:
        H_new = H * jnp.sqrt(numerator / (col_w + H / lam[:, None]))
    return jnp.maximum(H_new, EPSILON)


def update_W(X, W, H, lam, prior: str, n_given_signatures: int = 0):
    """MM update of W at fixed H, lam; leading given columns frozen exactly
    (same freeze semantics as ops/klnmf.update_W - no renormalization here:
    ARD signatures carry their scale, which is what lambda measures)."""
    n_signatures = W.shape[1]
    if n_given_signatures == n_signatures:
        return W
    numerator = mm(X / mm(W, H), H.T)
    row_h = jnp.sum(H, axis=1)[None, :]
    if prior == "L1":
        W_new = W * numerator / (row_h + (1.0 / lam)[None, :])
    else:
        W_new = W * jnp.sqrt(numerator / (row_h + W / lam[None, :]))
    W_new = jnp.maximum(W_new, EPSILON)
    if n_given_signatures > 0:
        given = jnp.arange(n_signatures) < n_given_signatures
        return jnp.where(given[None, :], W, W_new)
    return W_new


def update_whl(X, W, H, lam, ard_ab, prior: str, n_given_signatures: int = 0):
    """One full ARD iteration: H, then W (fresh ratio), then lambda.

    Sequential updates keep the MM monotonicity guarantee (each step
    decreases C at the others fixed; lambda's update is its exact
    minimizer) - pinned by tests/test_model_ardnmf.py."""
    H = update_H(X, W, H, lam, prior)
    W = update_W(X, W, H, lam, prior, n_given_signatures)
    lam = update_lambda(W, H, ard_ab, prior)
    return W, H, lam


def init_params(W, H, ard_ab, prior: str, n_given_signatures: int = 0):
    """Build the ARD parameter pytree from any (W, H) initialization.

    Rebalances each free component's W/H scales (WH-invariant: w_k *= s_k,
    h_k /= s_k with s_k chosen so f(w_k) = f(h_k)): the package's shared
    initializers return sum-one signature columns and count-scaled exposure
    rows, which starts the ARD penalty far from its per-component optimum.
    Given (frozen) leading columns are user data and pass through unscaled.
    Returns {"W", "H", "lam"} with the closed-form lambda at the rebalanced
    point. Pure/jittable; vmap for batched multi-start init."""
    if prior == "L1":
        fw, fh = jnp.sum(W, axis=0), jnp.sum(H, axis=1)
        power = 0.5
    else:
        fw, fh = 0.5 * jnp.sum(W**2, axis=0), 0.5 * jnp.sum(H**2, axis=1)
        power = 0.25
    scale = (fh / jnp.maximum(fw, EPSILON)) ** power
    if n_given_signatures > 0:
        scale = jnp.where(
            jnp.arange(scale.shape[0]) < n_given_signatures, 1.0, scale
        )
    W = jnp.maximum(W * scale[None, :], EPSILON)
    H = jnp.maximum(H / scale[:, None], EPSILON)
    return {"W": W, "H": H, "lam": update_lambda(W, H, ard_ab, prior)}


def make_step_functions(prior: str, n_given_signatures: int = 0):
    """Engine step functions for the ARDNMF family.

    params = {"W": (V,K), "H": (K,D), "lam": (K,)};
    data = {"X": (V,D), "ard_ab": (2,) array [a, b]}.
    `prior` is static (two compiled programs at most); a and b are data.
    """
    if prior not in PRIORS:
        raise ValueError(f"Unknown ARD prior {prior!r}: use one of {PRIORS}.")

    def update_fn(params, data):
        W, H, lam = update_whl(
            data["X"], params["W"], params["H"], params["lam"],
            data["ard_ab"], prior, n_given_signatures,
        )
        return {"W": W, "H": H, "lam": lam}

    def objective_fn(params, data):
        return ard_objective(
            data["X"], params["W"], params["H"], params["lam"],
            data["ard_ab"], prior,
        )

    return update_fn, objective_fn


def relevance_excess(lam, ard_ab, prior: str, n_features: int,
                     n_samples: int) -> np.ndarray:
    """Per-component relevance above the prior's resting value, normalized:

        e_k = (c * lam_k - b) / b = (f(w_k) + f(h_k)) / b

    A pruned component's W/H sit at the EPSILON floor, so e_k ~ (V+D)*eps/b
    (orders of magnitude below any data-supported component's e_k).

    HOST path on purpose (plain numpy, K-element inputs): rank readout runs
    post-fit on container data, and eager jnp on an accelerator pays a
    dispatch and a transfer per op."""
    lam = np.asarray(lam)
    a, b = float(np.asarray(ard_ab)[0]), float(np.asarray(ard_ab)[1])
    c = prior_constant(prior, n_features, n_samples, a)
    return (c * lam - b) / b


def active_components(lam, ard_ab, prior: str, n_features: int,
                      n_samples: int, active_tol: float = 1e-2) -> np.ndarray:
    """Boolean (K,) mask of data-supported components: relevance excess at
    least `active_tol` times the largest component's. Host/numpy path."""
    excess = relevance_excess(lam, ard_ab, prior, n_features, n_samples)
    return excess >= active_tol * np.max(excess)

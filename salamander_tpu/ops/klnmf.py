"""KL-divergence NMF kernels (objectives + Lee-Seung multiplicative updates).

Numeric semantics match the reference numba kernels in
/root/reference/src/salamander/models/_utils_klnmf.py:
  kl_divergence            :11-55   (zero entries of X skipped, not clipped)
  samplewise_kl_divergence :58-97   (X==0 masked to EPSILON in the log term)
  poisson_llh              :100-161
  update_W                 :164-217 (given columns frozen, only free clipped)
  update_H                 :220-278 (optional weighted-KL + l1/2 closed form)
  update_WH                :281-361 (aux computed ONCE from the old W,H and
                                     reused by both updates; whole W clipped)

Conventions (kernel orientation, transposed wrt the container layer):
  X: (n_features V, n_samples D) counts
  W: (V, n_signatures K) signatures, columns sum to one
  H: (K, D) exposures
  weights_*: (D,) per-sample weights or None
  n_given_signatures: static int - leading columns of W held fixed.

All functions are pure and jittable; batching over restarts is `vmap` over
W/H (X broadcasts). Under a `jax.sharding.Mesh`, shard D; the reductions over
D inside the W update and the objectives become XLA all-reduces automatically.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln

from .precision import OBJECTIVE_PRECISION, mm, omm

EPSILON = float(np.finfo(np.float32).eps)


def kl_divergence(X, W, H, weights=None):
    r"""Generalized KL divergence D(X || WH) = sum X ln(X/WH) - X + WH.

    Terms with X==0 contribute only their +WH part (the x ln x limit), exactly
    as the reference's explicit loop skips them.
    """
    WH = omm(W, H)
    nonzero = X != 0
    safe_ratio = jnp.where(nonzero, X / jnp.where(nonzero, WH, 1.0), 1.0)
    summands = jnp.where(nonzero, X * jnp.log(safe_ratio) - X, 0.0) + WH
    per_sample = jnp.sum(summands, axis=0)
    if weights is not None:
        per_sample = per_sample * weights
    return jnp.sum(per_sample)


def samplewise_kl_divergence(X, W, H, weights=None):
    """Per-sample generalized KL divergence, shape (D,).

    Mirrors the reference's EPSILON-masking formulation: where X==0, both X
    and WH are replaced by EPSILON inside the log ratio (making that term
    vanish), while the linear terms use the raw matrices.
    """
    zero = X == 0
    X_safe = jnp.where(zero, EPSILON, X.astype(jnp.result_type(X, jnp.float32)))
    WH_safe = jnp.where(zero, EPSILON, omm(W, H))
    log_term = jnp.einsum("vd,vd->d", X_safe, jnp.log(X_safe / WH_safe),
                          precision=OBJECTIVE_PRECISION)
    errors = log_term - jnp.sum(X, axis=0) + omm(H.T, jnp.sum(W, axis=0))
    if weights is not None:
        errors = errors * weights
    return errors


def poisson_llh_wo_factorial(X, W, H):
    """sum X ln(WH) - WH, skipping WH==0 log terms (reference :100-135)."""
    WH = omm(W, H)
    nonzero = WH != 0
    log_wh = jnp.log(jnp.where(nonzero, WH, 1.0))
    return jnp.sum(jnp.where(nonzero, X * log_wh, 0.0) - WH)


def poisson_llh(X, W, H):
    """Poisson log-likelihood generalized to real-valued X (reference :138-161)."""
    return poisson_llh_wo_factorial(X, W, H) - jnp.sum(gammaln(1.0 + X))


def _freeze_given_columns(W_new, W_old, n_given: int):
    """Restore the first 'n_given' columns of W_old into W_new."""
    if n_given == 0:
        return W_new
    given = jnp.arange(W_new.shape[1]) < n_given
    return jnp.where(given[None, :], W_old, W_new)


def update_W(X, W, H, weights_kl=None, n_given_signatures: int = 0):
    """Multiplicative W update under column-normalization (reference :164-217).

    Only the free (non-given) columns are clipped to EPSILON, so given
    signatures pass through bit-exactly.
    """
    n_signatures = W.shape[1]
    if n_given_signatures == n_signatures:
        return W

    aux = X / mm(W, H)
    if weights_kl is not None:
        aux = aux * weights_kl
    W_new = W * mm(aux, H.T)
    W_new = W_new / jnp.sum(W_new, axis=0)
    clipped = jnp.maximum(W_new, EPSILON)
    if n_given_signatures > 0:
        given = jnp.arange(n_signatures) < n_given_signatures
        return jnp.where(given[None, :], W, clipped)
    return clipped


def _update_H_from_aux(H, W, aux, weights_kl=None, weights_lhalf=None):
    """Shared H update given the precomputed ratio aux = X / (W @ H)."""
    WtAux = mm(W.T, aux)
    if weights_lhalf is None:
        return jnp.maximum(H * WtAux, EPSILON)

    quad = 4.0 * H * WtAux
    if weights_kl is not None:
        quad = quad * weights_kl**2
    half_weight = weights_lhalf / 2.0
    root = jnp.sqrt(half_weight**2 + quad)
    # (w/2 - root)^2 with root = sqrt((w/2)^2 + quad): the reference's
    # literal form (_utils_klnmf.py:266-270) cancels catastrophically in
    # float32 when quad << w^2; root - w/2 = quad / (root + w/2) is the
    # exact cancellation-free rewrite.
    H_new = 0.25 * (quad / (root + half_weight)) ** 2
    if weights_kl is not None:
        H_new = H_new / weights_kl**2
    return jnp.maximum(H_new, EPSILON)


def update_H(X, W, H, weights_kl=None, weights_lhalf=None):
    """Multiplicative H update with optional weighted KL and l1/2 sparsity
    closed form (reference :220-278)."""
    aux = X / mm(W, H)
    return _update_H_from_aux(H, W, aux, weights_kl, weights_lhalf)


def update_WH(
    X, W, H, weights_kl=None, weights_lhalf=None, n_given_signatures: int = 0
):
    """Joint W,H update sharing one aux = X/(WH) computed from the OLD W,H.

    The per-iteration hot path of KLNMF (reference :281-361). Note the
    asymmetry wrt update_W: here the whole updated W - including restored
    given columns - is clipped to EPSILON, as in the reference.
    """
    n_signatures = W.shape[1]
    aux = X / mm(W, H)

    if n_given_signatures == n_signatures:
        W_new = W
    else:
        scaled_aux = aux if weights_kl is None else weights_kl * aux
        W_new = W * mm(scaled_aux, H.T)
        W_new = W_new / jnp.sum(W_new, axis=0)
        W_new = _freeze_given_columns(W_new, W, n_given_signatures)
        W_new = jnp.maximum(W_new, EPSILON)

    H_new = _update_H_from_aux(H, W, aux, weights_kl, weights_lhalf)
    return W_new, H_new


def normalize_wh(W, H):
    """Rescale W columns to sum one, pushing the factor into H rows."""
    scale = jnp.sum(W, axis=0)
    return W / scale, H * scale[:, None]


def lhalf_penalty(H, weights_lhalf):
    """The sparsity penalty term sum_d w_d * sum_k sqrt(H_kd)."""
    return jnp.dot(weights_lhalf, jnp.sum(jnp.sqrt(H), axis=0),
                   precision=OBJECTIVE_PRECISION)


def klnmf_objective(X, W, H, weights_kl=None, weights_lhalf=None):
    """Full KLNMF objective: weighted KL + optional l1/2 penalty
    (reference models/klnmf.py:64-80)."""
    value = kl_divergence(X, W, H, weights_kl)
    if weights_lhalf is not None:
        value = value + lhalf_penalty(H, weights_lhalf)
    return value


def make_step_functions(n_given_signatures: int = 0):
    """The canonical engine step functions for the KLNMF family (single
    source of truth for the model layer, the restart runner and the
    bootstrap driver).

    Both take (params, data) with params = {"W": (V,K), "H": (K,D)} and
    data = {"X": (V,D)} plus optional 'weights_kl'/'weights_lhalf' entries
    (their presence in the data pytree is part of the jit signature).
    """

    def update_fn(params, data):
        W, H = update_WH(
            data["X"],
            params["W"],
            params["H"],
            data.get("weights_kl"),
            data.get("weights_lhalf"),
            n_given_signatures,
        )
        return {"W": W, "H": H}

    def objective_fn(params, data):
        return klnmf_objective(
            data["X"],
            params["W"],
            params["H"],
            data.get("weights_kl"),
            data.get("weights_lhalf"),
        )

    return update_fn, objective_fn


def make_masked_step_functions(n_given_signatures: int = 0):
    """Rank-masked twin of make_step_functions for K-padded batching.

    Several problems of different rank k share ONE compiled program of padded
    rank K: params carry a per-problem boolean 'mask' (K,) marking the active
    leading signatures. Masked-off entries are inert: their H rows are held
    at exact zero (so W @ H, every aux ratio and every objective value equal
    the unpadded rank-k computation - adding exact zeros to a contraction is
    exact), and their W columns pass through unchanged. This is what lets a
    rank scan amortize one XLA compilation over many ranks (rank-scan
    driver: parallel/restarts.py).
    """

    def update_fn(params, data):
        X = data["X"]
        W, H, mask = params["W"], params["H"], params["mask"]
        weights_kl = data.get("weights_kl")
        weights_lhalf = data.get("weights_lhalf")
        n_signatures = W.shape[1]

        aux = X / mm(W, H)
        if n_given_signatures == n_signatures:
            W_new = W
        else:
            scaled_aux = aux if weights_kl is None else weights_kl * aux
            W_new = W * mm(scaled_aux, H.T)
            # padded columns have all-zero numerators; keep their sum at 1
            W_new = W_new / jnp.where(mask, jnp.sum(W_new, axis=0), 1.0)
            W_new = _freeze_given_columns(W_new, W, n_given_signatures)
            W_new = jnp.maximum(W_new, EPSILON)
            W_new = jnp.where(mask[None, :], W_new, W)

        H_new = _update_H_from_aux(H, W, aux, weights_kl, weights_lhalf)
        H_new = jnp.where(mask[:, None], H_new, 0.0)
        return {"W": W_new, "H": H_new, "mask": mask}

    def objective_fn(params, data):
        # padded H rows are exactly zero, so the objective equals the
        # unpadded rank-k value without any masking of its own
        return klnmf_objective(
            data["X"],
            params["W"],
            params["H"],
            data.get("weights_kl"),
            data.get("weights_lhalf"),
        )

    return update_fn, objective_fn


def pad_rank(W, H, n_padded: int):
    """Pad a rank-k problem to rank n_padded for the masked step functions.

    W: (..., V, k) -> (..., V, n_padded) with uniform dummy columns;
    H: (..., k, D) -> (..., n_padded, D) with exact-zero dummy rows;
    also returns the (n_padded,) activity mask.
    """
    k = W.shape[-1]
    if n_padded < k:
        raise ValueError(f"n_padded={n_padded} below rank {k}")
    extra = n_padded - k
    V = W.shape[-2]
    W_pad = jnp.concatenate(
        [W, jnp.full(W.shape[:-1] + (extra,), 1.0 / V, W.dtype)], axis=-1
    )
    H_pad = jnp.concatenate(
        [H, jnp.zeros(H.shape[:-2] + (extra,) + H.shape[-1:], H.dtype)],
        axis=-2,
    )
    mask = jnp.arange(n_padded) < k
    return W_pad, H_pad, mask

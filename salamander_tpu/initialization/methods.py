"""The seven initialization methods.

Parity notes (reference initialization/methods.py):
  init_custom      :27-55  shape/type checks only
  init_flat        :58-66  uniform signatures, rowsum/k exposures
  init_nndsvd      :69-86  delegates to sklearn's private _initialize_nmf -
                           we do the same when sklearn is present (it is the
                           only way to reproduce the reference's exact draws,
                           including nndsvdar's randomized fill-in), with a
                           self-contained SVD fallback otherwise
  init_random      :89-109 Dirichlet draws on the simplex via the GLOBAL
                           numpy RNG after np.random.seed(seed) - kept
                           verbatim in semantics for golden parity
  init_separableNMF:112-135 Gillis-Vavasis successive projection; exposures
                           delegated to init_random with the same seed

These run host-side on numpy: they execute once per fit on tiny matrices and
must replicate numpy RNG streams bit-for-bit. The device-scale batched
initializer (random_init_batch) lives at the bottom and uses jax.random.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from ..utils import shape_checker, type_checker

EPSILON = float(np.finfo(np.float32).eps)

INIT_METHODS = (
    "custom",
    "flat",
    "nndsvd",
    "nndsvda",
    "nndsvdar",
    "random",
    "separableNMF",
)


def init_custom(
    data_mat: np.ndarray,
    n_signatures: int,
    signatures_mat: np.ndarray,
    exposures_mat: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Validate user-provided signature and exposure matrices.

    data_mat: (n_samples, n_features); signatures_mat: (n_signatures,
    n_features); exposures_mat: (n_samples, n_signatures).
    """
    type_checker("signatures_mat", signatures_mat, np.ndarray)
    type_checker("exposures_mat", exposures_mat, np.ndarray)
    n_samples, n_features = data_mat.shape
    shape_checker("signatures_mat", signatures_mat, (n_signatures, n_features))
    shape_checker("exposures_mat", exposures_mat, (n_samples, n_signatures))
    return signatures_mat, exposures_mat


def init_flat(data_mat: np.ndarray, n_signatures: int):
    """Uniform signatures; every sample's counts split evenly across them."""
    n_features = data_mat.shape[1]
    signatures_mat = np.full((n_signatures, n_features), 1.0 / n_features)
    per_signature = np.sum(data_mat, axis=1) / n_signatures
    exposures_mat = np.tile(per_signature, (n_signatures, 1)).T
    return signatures_mat, exposures_mat


def _nndsvd_numpy(data_mat: np.ndarray, n_signatures: int,
                  variant: str, seed: int | None):
    """Self-contained NNDSVD(+a/ar) fallback (Boutsidis & Gallopoulos 2008),
    used only when sklearn is unavailable."""
    U, S, Vt = np.linalg.svd(data_mat, full_matrices=False)
    E = np.zeros((data_mat.shape[0], n_signatures))
    F = np.zeros((n_signatures, data_mat.shape[1]))
    E[:, 0] = np.sqrt(S[0]) * np.abs(U[:, 0])
    F[0, :] = np.sqrt(S[0]) * np.abs(Vt[0, :])
    for j in range(1, n_signatures):
        u, v = U[:, j], Vt[j, :]
        u_pos, v_pos = np.maximum(u, 0), np.maximum(v, 0)
        u_neg, v_neg = np.maximum(-u, 0), np.maximum(-v, 0)
        norm_pos = np.linalg.norm(u_pos) * np.linalg.norm(v_pos)
        norm_neg = np.linalg.norm(u_neg) * np.linalg.norm(v_neg)
        if norm_pos >= norm_neg:
            scale = norm_pos
            uu = u_pos / np.linalg.norm(u_pos)
            vv = v_pos / np.linalg.norm(v_pos)
        else:
            scale = norm_neg
            uu = u_neg / np.linalg.norm(u_neg)
            vv = v_neg / np.linalg.norm(v_neg)
        E[:, j] = np.sqrt(S[j] * scale) * uu
        F[j, :] = np.sqrt(S[j] * scale) * vv
    if variant == "nndsvda":
        mean = data_mat.mean()
        E[E == 0] = mean
        F[F == 0] = mean
    elif variant == "nndsvdar":
        rng = np.random.mtrand._rand
        mean = data_mat.mean()
        E[E == 0] = mean * rng.standard_normal(size=(E == 0).sum()) / 100.0
        F[F == 0] = mean * rng.standard_normal(size=(F == 0).sum()) / 100.0
    return F, E  # (signatures, exposures)


def init_nndsvd(
    data_mat: np.ndarray,
    n_signatures: int,
    method: Literal["nndsvd", "nndsvda", "nndsvdar"] = "nndsvd",
    seed: int | None = None,
):
    """Non-negative double SVD initialization.

    Matches the reference by delegating to sklearn's implementation when
    available (reference methods.py:69-86 uses the same private API); the
    global numpy RNG is seeded first so 'nndsvdar' reproduces the exact
    random fill-in of the golden fixtures.
    """
    if seed is not None:
        np.random.seed(seed)
    try:
        from sklearn.decomposition import _nmf as sklearn_nmf

        exposures_mat, signatures_mat = sklearn_nmf._initialize_nmf(
            data_mat, n_signatures, init=method
        )
    except ImportError:  # pragma: no cover - sklearn is normally present
        signatures_mat, exposures_mat = _nndsvd_numpy(
            data_mat, n_signatures, method, seed
        )
    return signatures_mat, exposures_mat


def init_random(data_mat: np.ndarray, n_signatures: int, seed: int | None = None):
    """Dirichlet draws on the simplex: uniform random signatures, and
    per-sample exposures scaled to the sample's total count."""
    if seed is not None:
        np.random.seed(seed)
    n_samples, n_features = data_mat.shape
    signatures_mat = np.random.dirichlet(np.ones(n_features), size=n_signatures)
    totals = np.sum(data_mat, axis=1)
    exposures_mat = totals[:, None] * np.random.dirichlet(
        np.ones(n_signatures), size=n_samples
    )
    return signatures_mat, exposures_mat


def init_separable_nmf(data_mat: np.ndarray, n_signatures: int,
                       seed: int | None = None):
    """Successive projection (SPA): greedily pick the data rows with the
    largest residual column norm as anchor signatures (Gillis & Vavasis 2013,
    Algorithm 1 with f = ||.||^2); exposures from init_random."""
    chosen = np.empty(n_signatures, dtype=int)
    residual = data_mat.T / np.sum(data_mat.T, axis=0)
    for k in range(n_signatures):
        norms = np.sum(residual**2, axis=0)
        anchor = int(np.argmax(norms))
        u = residual[:, anchor]
        projector = np.identity(residual.shape[0]) - np.outer(u, u) / norms[anchor]
        residual = projector @ residual
        chosen[k] = anchor
    signatures_mat = data_mat[chosen, :].astype(float)
    signatures_mat /= signatures_mat.sum(axis=1)[:, None]
    _, exposures_mat = init_random(data_mat, n_signatures, seed=seed)
    return signatures_mat, exposures_mat


# backwards-compatible alias matching the reference's camel-case name
init_separableNMF = init_separable_nmf


# ---------------------------------------------------------------------------
# Device-scale batched initialization (jax.random) for the multi-start driver.
# ---------------------------------------------------------------------------

def random_init_batch(key, data_mat, n_signatures: int, n_restarts: int,
                      dtype=None):
    """Initialize (W, H) for many restarts at once on device.

    Returns W: (n_restarts, V, K) column-stochastic and H: (n_restarts, K, D)
    scaled to per-sample totals - the jax.random counterpart of init_random,
    batched over restarts. data_mat is (V, D) in kernel orientation.
    """
    import jax
    import jax.numpy as jnp

    if dtype is None:
        dtype = data_mat.dtype
    n_features, n_samples = data_mat.shape
    key_w, key_h = jax.random.split(key)
    # Dirichlet(1,...,1) == normalized iid Exponential(1) draws - identical
    # distribution, but exponential sampling is a branch-free program where
    # jax.random.dirichlet's gamma rejection sampler (nested while_loops)
    # compiles slowly, once per shape, at rank-scan sizes.
    draws_w = jax.random.exponential(
        key_w, (n_restarts, n_signatures, n_features), dtype
    )
    W = (draws_w / jnp.sum(draws_w, axis=-1, keepdims=True)).transpose(0, 2, 1)
    draws_h = jax.random.exponential(
        key_h, (n_restarts, n_samples, n_signatures), dtype
    )
    exposures = (
        draws_h / jnp.sum(draws_h, axis=-1, keepdims=True)
    ).transpose(0, 2, 1)
    totals = jnp.sum(data_mat, axis=0)
    H = exposures * totals[None, None, :]
    W = jnp.maximum(W, EPSILON)
    H = jnp.maximum(H, EPSILON)
    return W, H


def corrnmf_init_batch(key, data_mat, n_signatures: int, dim_embeddings: int,
                       n_restarts: int, dtype=None):
    """Initialize a batch of CorrNMF parameter pytrees on device.

    The jax.random counterpart of initialize_corrnmf with init_method
    'random' (reference initialization/initialize.py:319-384): Dirichlet
    signatures, zero scalings, standard-normal embeddings, unit variance;
    exposures derived from the scalings/embeddings. data_mat is (D, V) with
    samples as rows (model orientation). Returns the params pytree of
    CorrNMFDet._device_state with a leading restart axis.
    """
    import jax
    import jax.numpy as jnp

    from ..ops.corrnmf import compute_exposures

    if dtype is None:
        dtype = data_mat.dtype
    n_samples, n_features = data_mat.shape
    key_sig, key_sig_emb, key_smp_emb = jax.random.split(key, 3)
    # Dirichlet(1,..,1) via normalized exponentials (see random_init_batch)
    draws = jax.random.exponential(
        key_sig, (n_restarts, n_signatures, n_features), dtype
    )
    signatures = draws / jnp.sum(draws, axis=-1, keepdims=True)
    signatures = jnp.maximum(signatures, EPSILON)
    signature_embeddings = jax.random.normal(
        key_sig_emb, (n_restarts, n_signatures, dim_embeddings), dtype
    )
    sample_embeddings = jax.random.normal(
        key_smp_emb, (n_restarts, n_samples, dim_embeddings), dtype
    )
    signature_scalings = jnp.zeros((n_restarts, n_signatures), dtype)
    sample_scalings = jnp.zeros((n_restarts, n_samples), dtype)
    exposures = jax.vmap(compute_exposures)(
        signature_scalings, sample_scalings,
        signature_embeddings, sample_embeddings,
    )
    return {
        "signatures": signatures,
        "signature_scalings": signature_scalings,
        "sample_scalings": sample_scalings,
        "signature_embeddings": signature_embeddings,
        "sample_embeddings": sample_embeddings,
        "variance": jnp.ones((n_restarts,), dtype),
        "exposures": exposures,
    }


def mm_corrnmf_init_batch(key, data_mats, mod_names, ns_signatures,
                          dim_embeddings: int, n_restarts: int, dtype=None):
    """Initialize a batch of MultimodalCorrNMF parameter pytrees on device.

    The multimodal twin of corrnmf_init_batch: per-modality Dirichlet
    signatures, zero scalings and standard-normal signature embeddings, ONE
    shared standard-normal sample-embedding matrix across modalities, unit
    variance; exposures derived per modality. data_mats is {mod: (D, V_i)}
    (model orientation). Returns the MultimodalCorrNMF._device_state params
    pytree with a leading restart axis - used by fit_best_of's device-side
    multi-start init so multimodal restarts need no host init loop (and no
    np.random.seed mutation).
    """
    import jax
    import jax.numpy as jnp

    from ..ops.corrnmf import compute_exposures

    mod_names = list(mod_names)
    first = data_mats[mod_names[0]]
    if dtype is None:
        dtype = first.dtype
    n_samples = first.shape[0]
    key_shared, key_mods = jax.random.split(key)
    sample_embeddings = jax.random.normal(
        key_shared, (n_restarts, n_samples, dim_embeddings), dtype
    )
    sample_scalings = jnp.zeros((n_restarts, n_samples), dtype)
    mods = {}
    for index, (name, n_signatures) in enumerate(
        zip(mod_names, ns_signatures)
    ):
        key_mod = jax.random.fold_in(key_mods, index)
        key_sig, key_emb = jax.random.split(key_mod)
        n_features = data_mats[name].shape[1]
        draws = jax.random.exponential(
            key_sig, (n_restarts, n_signatures, n_features), dtype
        )
        signatures = draws / jnp.sum(draws, axis=-1, keepdims=True)
        signatures = jnp.maximum(signatures, EPSILON)
        signature_embeddings = jax.random.normal(
            key_emb, (n_restarts, n_signatures, dim_embeddings), dtype
        )
        signature_scalings = jnp.zeros((n_restarts, n_signatures), dtype)
        exposures = jax.vmap(compute_exposures)(
            signature_scalings, sample_scalings,
            signature_embeddings, sample_embeddings,
        )
        mods[name] = {
            "signatures": signatures,
            "signature_scalings": signature_scalings,
            "sample_scalings": sample_scalings,
            "signature_embeddings": signature_embeddings,
            "exposures": exposures,
        }
    return {
        "mods": mods,
        "sample_embeddings": sample_embeddings,
        "variance": jnp.ones((n_restarts,), dtype),
    }

"""Bootstrap stability analysis for signatures.

A standard question the reference cannot answer efficiently: how stable are
the extracted signatures under resampling of the cohort? Here B bootstrap
replicates (samples drawn with replacement) are fitted SIMULTANEOUSLY - the
per-replicate count matrices ride a batched data axis through the lockstep
engine - and each replicate's signatures are Hungarian-matched back to the
full-data fit to produce per-signature cosine-stability distributions
(the SigProfiler-style stability score).

Every family refits under its OWN update rule and objective: the replicate
fits reuse the model's engine step functions (KLNMF's weighted MU, MvNMF's
volume-penalized line search, CorrNMFDet's variational EM), so the stability
numbers mean what they claim for every model class.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import pandas as pd

from .. import containers
from ..engine import FitConfig, make_fit_function
from ..engine.transfer import fetch_pytree
from ..utils import match_signatures_pair

_SUPPORTED = ("KLNMF", "MvNMF", "ARDNMF", "CorrNMFDet", "MultimodalCorrNMF")


class BootstrapResult(NamedTuple):
    """Per-signature stability of a fitted model under cohort resampling."""

    stability: pd.Series        # mean matched cosine per signature
    similarities: pd.DataFrame  # (n_bootstraps, n_signatures) matched cosines
    signatures: np.ndarray      # (B, K, V) matched bootstrap signatures in
    # the MODEL's row orientation (signatures x features, aligned to
    # model.signatures) - already Hungarian-matched, with per-replicate
    # cosines in `similarities`. NOT the raw (R, V, K) restart stacks
    # that RestartResult.W / CorrScanResult.signatures /
    # MultiStartSummary.signatures feed into tl.signature_stability.
                                # (multimodal: {mod_name: (B, K_mod, V_mod)})
    losses: np.ndarray          # (B,) final objective per replicate


def _cosine(u, v):
    return float(np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v)))


def _stack(trees):
    return jax.tree.map(lambda *leaves: np.stack(leaves), *trees)


def _match_replicates(reference_signatures, W_boot, names):
    """Hungarian-match each replicate's signatures to the reference frame;
    returns (matched (B,K,V), similarities DataFrame)."""
    n_bootstraps, n_signatures, n_features = W_boot.shape
    matched = np.empty((n_bootstraps, n_signatures, n_features))
    similarities = np.empty((n_bootstraps, n_signatures))
    for b in range(n_bootstraps):
        replicate = pd.DataFrame(
            W_boot[b], columns=reference_signatures.columns
        )
        order = match_signatures_pair(reference_signatures, replicate)
        matched[b] = W_boot[b][order]
        for k in range(n_signatures):
            similarities[b, k] = _cosine(
                reference_signatures.values[k], matched[b, k]
            )
    return matched, pd.DataFrame(similarities, columns=names)


def bootstrap_stability(
    model,
    n_bootstraps: int = 50,
    seed: int = 0,
    config: FitConfig | None = None,
) -> BootstrapResult:
    """Assess signature stability of a FITTED model under cohort resampling.

    Draws `n_bootstraps` resampled cohorts (samples with replacement), fits
    all of them in one device program using the model's own step functions
    (fresh initialization per replicate with the model's init_method),
    matches each replicate's signatures to the model's, and reports matched
    cosine similarities. Stability near 1 = robust signature; low mean
    stability flags overfitting / rank too high.

    MultimodalCorrNMF resamples the shared sample axis (the same bootstrap
    indices across all modalities), refits the joint model, and matches
    per modality; `signatures` is then a per-modality dict.

    ARDNMF replicates refit at the model's CURRENT n_signatures with the
    per-replicate moment-matched b (each resampled cohort sets its own
    prior scale, like the original fit did) - call `model.prune()` first
    so replicates run at the inferred rank. On an unpruned model, pruned
    components sit at the constant EPSILON floor in every replicate and
    therefore match each other at cosine ~1: read their "stability" as
    'consistently pruned', not as signature evidence.
    """
    class_name = type(model).__name__
    if class_name not in _SUPPORTED:
        raise ValueError(
            f"bootstrap_stability supports {_SUPPORTED}; got {class_name}."
        )
    if not getattr(model, "_is_fitted", False):
        raise ValueError("bootstrap_stability() requires a fitted model.")
    from ..io import _HYPERPARAM_KEYS

    config = config or FitConfig(
        min_iterations=model.min_iterations,
        max_iterations=model.max_iterations,
        conv_test_freq=model.conv_test_freq,
        tol=model.tol,
    )
    if class_name == "MultimodalCorrNMF":
        return _bootstrap_multimodal(model, n_bootstraps, seed, config)
    n_samples = model.adata.n_obs
    rng = np.random.default_rng(seed)
    sample_indices = rng.integers(0, n_samples, size=(n_bootstraps, n_samples))
    X = np.asarray(model.adata.X)  # (D, V), samples as rows

    # one throwaway clone drives per-replicate init + device-state assembly
    hyperparameters = {
        key: getattr(model, key) for key in _HYPERPARAM_KEYS[class_name]
    }
    clone = type(model)(**hyperparameters)
    stochastic_init = clone.init_method in ("random", "separableNMF", "nndsvdar")

    params_per_replicate, data_per_replicate = [], []
    # pin the per-replicate _device_state arrays to the host CPU backend:
    # uploading then fetching every leaf (including each full X
    # replicate!) per bootstrap pays a round trip per leaf; the stacked
    # pytrees upload ONCE below
    with jax.default_device(jax.devices("cpu")[0]):
        for b in range(n_bootstraps):
            indices = sample_indices[b]
            adata_b = containers.AnnData(X[indices])
            np.random.seed(seed + b)  # drives unseeded embedding draws
            clone._setup_adata(adata_b)
            init_kwargs = {"seed": seed + b} if stochastic_init else None
            clone._initialize(None, init_kwargs)
            clone._setup_fitting_parameters(None)
            # per-sample loss weights follow their samples into the replicate
            for attr in ("weights_kl", "weights_lhalf"):
                weights = getattr(model, attr, None)
                if weights is not None:
                    setattr(clone, attr, np.asarray(weights)[indices])
            params_b, data_b = clone._device_state()
            params_per_replicate.append(jax.tree.map(np.asarray, params_b))
            data_per_replicate.append(jax.tree.map(np.asarray, data_b))

    params0 = _stack(params_per_replicate)
    data = _stack(data_per_replicate)
    update_fn, objective_fn = clone._build_step(None)
    from ..models.signature_nmf import promote_objective

    objective_fn = promote_objective(
        objective_fn, jax.tree.map(lambda leaf: leaf[0], params0)
    )
    run = make_fit_function(
        update_fn, objective_fn, config, batched=True, batched_data=True,
        unroll=getattr(clone, "_unroll_blocks", False),
    )
    result = run(params0, data)
    losses_device = jax.jit(jax.vmap(objective_fn, in_axes=(0, 0)))(
        result.params, data
    )
    # one batched device->host transfer (engine/transfer.py)
    result, losses = fetch_pytree((result, losses_device))
    losses = np.asarray(losses)
    if "W" in result.params:  # KLNMF/MvNMF kernel orientation (B, V, K)
        W_boot = np.transpose(np.asarray(result.params["W"]), (0, 2, 1))
    else:  # CorrNMFDet carries (B, K, V) signatures directly
        W_boot = np.asarray(result.params["signatures"])

    matched, similarity_frame = _match_replicates(
        model.signatures, W_boot, list(model.signature_names)
    )
    return BootstrapResult(
        stability=similarity_frame.mean(axis=0),
        similarities=similarity_frame,
        signatures=matched,
        losses=losses,
    )


def _bootstrap_multimodal(model, n_bootstraps: int, seed: int,
                          config: FitConfig) -> BootstrapResult:
    """Joint multimodal bootstrap: one resampled sample set per replicate
    shared by all modalities, refit with the model's own joint EM."""
    from ..io import _HYPERPARAM_KEYS
    from ..models.signature_nmf import promote_objective

    hyperparameters = {
        key: getattr(model, key)
        for key in _HYPERPARAM_KEYS["MultimodalCorrNMF"]
    }
    clone = type(model)(**hyperparameters)
    stochastic_init = clone.init_method in ("random", "separableNMF", "nndsvdar")
    mod_names = model.mod_names
    X = {name: np.asarray(model.mdata[name].X) for name in mod_names}
    n_samples = model.mdata.n_obs
    rng = np.random.default_rng(seed)
    sample_indices = rng.integers(0, n_samples, size=(n_bootstraps, n_samples))

    params_per_replicate, data_per_replicate = [], []
    # CPU-pinned for the same round-trip reason as the
    # single-modality loop above
    with jax.default_device(jax.devices("cpu")[0]):
        for b in range(n_bootstraps):
            indices = sample_indices[b]
            mdata_b = containers.MuData({
                name: containers.AnnData(X[name][indices])
                for name in mod_names
            })
            np.random.seed(seed + b)  # drives unseeded embedding draws
            clone._setup_mdata(mdata_b)
            init_kwargs = {"seed": seed + b} if stochastic_init else None
            clone._initialize(None, init_kwargs)
            params_b, data_b = clone._device_state()
            params_per_replicate.append(jax.tree.map(np.asarray, params_b))
            data_per_replicate.append(jax.tree.map(np.asarray, data_b))

    params0 = _stack(params_per_replicate)
    data = _stack(data_per_replicate)
    update_fn, objective_fn = clone._build_step(None)
    objective_fn = promote_objective(
        objective_fn, jax.tree.map(lambda leaf: leaf[0], params0)
    )
    run = make_fit_function(
        update_fn, objective_fn, config, batched=True, batched_data=True,
        unroll=False,
    )
    result = run(params0, data)
    losses_device = jax.jit(jax.vmap(objective_fn, in_axes=(0, 0)))(
        result.params, data
    )
    result, losses = fetch_pytree((result, losses_device))
    losses = np.asarray(losses)

    matched_by_mod = {}
    similarity_frames = []
    for name in mod_names:
        W_boot = np.asarray(result.params["mods"][name]["signatures"])
        matched, frame = _match_replicates(
            model.signatures[name], W_boot, model.signature_names[name]
        )
        matched_by_mod[name] = matched
        similarity_frames.append(frame)
    similarity_frame = pd.concat(similarity_frames, axis=1)
    return BootstrapResult(
        stability=similarity_frame.mean(axis=0),
        similarities=similarity_frame,
        signatures=matched_by_mod,
        losses=losses,
    )

"""Generic batched multi-start for ANY model family.

The reference tutorial runs restarts as a serial Python loop of full fits;
fit_best_of runs them as ONE device program: per-restart initial parameter
pytrees are stacked on a leading axis, the model's own (update, objective)
step functions are vmapped inside the jitted convergence engine, and the
best restart (by the model's objective direction) is absorbed back into the
model's containers. Works for KLNMF, MvNMF, ARDNMF, CorrNMFDet and - because the
parameters are just pytrees - MultimodalCorrNMF.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import numpy as np

from ..engine.transfer import fetch_pytree

from ..engine import make_fit_function


class MultiStartSummary(NamedTuple):
    losses: np.ndarray        # (R,) final objective per restart
    n_iterations: np.ndarray  # (R,)
    best_index: int
    history: np.ndarray       # (R, max_evals) objective traces (NaN-padded)
    n_evals: np.ndarray       # (R,)
    signatures: Any = None    # (R, n_features, k) every restart's signature
    # matrix ({mod: stack} for MultimodalCorrNMF) - feeds
    # tools.signature_stability directly


def _signature_stack(params) -> Any:
    """Every restart's signature matrix as (R, n_features, k), from the
    fetched multi-start result pytree: W/H families store W as (R, V, K);
    CorrNMF stores signatures as (R, K, V) rows; multimodal nests
    per-modality dicts."""
    if "W" in params:
        return np.asarray(params["W"])
    if "signatures" in params:
        return np.asarray(params["signatures"]).transpose(0, 2, 1)
    if "mods" in params:
        return {
            name: np.asarray(mod["signatures"]).transpose(0, 2, 1)
            for name, mod in params["mods"].items()
        }
    return None


def _stack_pytrees(trees):
    return jax.tree.map(lambda *leaves: np.stack(leaves), *trees)


def _index_pytree(tree, index: int):
    return jax.tree.map(lambda leaf: leaf[index], tree)


# families with a device-side batched 'random' initializer
_DEVICE_INIT_FAMILIES = (
    "KLNMF", "MvNMF", "CorrNMFDet", "MultimodalCorrNMF", "ARDNMF",
)

# compacting runners shared across fit_best_of calls (FIFO-bounded; each
# runner caches its per-lane-count jitted segment programs)
_RUNNER_CACHE: dict = {}


def _device_init_batch(model, data, n_restarts: int, base_seed: int):
    """Build the batched params0 pytree directly on device with jax.random
    (no host loop, no global numpy RNG)."""
    import jax.numpy as jnp

    from ..initialization.methods import (
        corrnmf_init_batch,
        mm_corrnmf_init_batch,
        random_init_batch,
    )

    key = jax.random.PRNGKey(base_seed)
    name = type(model).__name__
    if name in ("KLNMF", "MvNMF", "ARDNMF"):
        X = data["X"]  # (V, D) kernel orientation
        W0, H0 = random_init_batch(key, X, model.n_signatures, n_restarts,
                                   X.dtype)
        if name == "ARDNMF":
            from ..ops.ardnmf import init_params

            return jax.vmap(
                lambda w, h: init_params(w, h, data["ard_ab"], model.prior)
            )(W0, H0)
        params = {"W": W0, "H": H0}
        if name == "MvNMF":
            params["gamma"] = jnp.ones((n_restarts,), X.dtype)
        return params
    if name == "MultimodalCorrNMF":
        return mm_corrnmf_init_batch(
            key, data["X"], model.mod_names, model.ns_signatures,
            model.dim_embeddings, n_restarts,
        )
    return corrnmf_init_batch(
        key, data["X"], model.n_signatures, model.dim_embeddings, n_restarts
    )


def _best_of_store(checkpoint_dir, model, is_multimodal: bool,
                   n_restarts: int, base_seed: int, config,
                   restart_chunk, mesh):
    """ChunkStore for a fit_best_of run: identity = counts (+ weights)
    fingerprint, model class + constructor hyperparameters, restart
    layout. Fingerprints come from the HOST containers (no device copy is
    fetched back for them)."""
    from ..checkpoint import ChunkStore, data_fingerprint
    from .restarts import _mesh_meta

    if is_multimodal:
        arrays = [
            np.asarray(model.mdata[name].X) for name in model.mod_names
        ]
    else:
        arrays = [np.asarray(model.adata.X)]
        for weights_name in ("weights_kl", "weights_lhalf"):
            weights = getattr(model, weights_name, None)
            if weights is not None:
                arrays.append(np.asarray(weights))
    return ChunkStore(checkpoint_dir, {
        "task": "fit_best_of",
        "model": type(model).__name__,
        "n_signatures": getattr(model, "n_signatures", None),
        "ns_signatures": getattr(model, "ns_signatures", None),
        "dim_embeddings": getattr(model, "dim_embeddings", None),
        "lam": getattr(model, "lam", None),
        "delta": getattr(model, "delta", None),
        "prior": getattr(model, "prior", None),
        "init_method": model.init_method,
        "n_restarts": int(n_restarts),
        "base_seed": int(base_seed),
        "config": list(config),
        "restart_chunk": (
            None if restart_chunk is None else int(restart_chunk)
        ),
        "mesh": _mesh_meta(mesh),
        "data": data_fingerprint(*arrays),
    })


def _result_to_entry(result, losses) -> dict:
    """Flatten a fetched (FitResult, losses) chunk into npz-ready arrays
    (params leaves by tree order - the store's meta guard pins the run
    identity, so the treedef is identical at load time)."""
    payload = {
        "losses": np.asarray(losses),
        "initial_objective": np.asarray(result.initial_objective),
        "history": np.asarray(result.history),
        "n_evals": np.asarray(result.n_evals),
        "n_iterations": np.asarray(result.n_iterations),
    }
    for i, leaf in enumerate(jax.tree.leaves(result.params)):
        payload[f"p{i}"] = np.asarray(leaf)
    return payload


def _entry_to_result(entry: dict, params0, lo: int, hi: int):
    """Rebuild the (FitResult, losses) chunk from a stored entry, using
    the current params0 slice only for its treedef."""
    from ..engine.fit import FitResult

    treedef = jax.tree.structure(
        jax.tree.map(lambda leaf: leaf[lo:hi], params0)
    )
    params = jax.tree.unflatten(
        treedef, [entry[f"p{i}"] for i in range(treedef.num_leaves)]
    )
    result = FitResult(
        params=params,
        initial_objective=entry["initial_objective"],
        history=entry["history"],
        n_evals=entry["n_evals"],
        n_iterations=entry["n_iterations"],
    )
    return result, entry["losses"]


def fit_best_of(
    model,
    data_container,
    n_restarts: int,
    base_seed: int = 0,
    given_parameters: dict[str, Any] | None = None,
    init_kwargs: dict[str, Any] | None = None,
    fitting_kwargs: dict[str, Any] | None = None,
    mesh=None,
    batched_init: bool | str = "auto",
    compact: bool | None = None,
    compact_min_bucket: int = 4,
    checkpoint_dir=None,
    restart_chunk: int | None = None,
    verbose: int = 0,
) -> MultiStartSummary:
    """Fit `n_restarts` differently-initialized copies of `model` at once and
    keep the best.

    The model's init_method should be stochastic ('random', 'separableNMF',
    or any CorrNMF init, whose embeddings are random); each restart r is
    seeded with base_seed + r. The model ends up holding the best restart's
    parameters (and its objective trace in .history); the full loss table is
    returned. With a `mesh` (from parallel.make_mesh), the restart axis of
    every parameter leaf is sharded over the mesh's 'restarts' axis.

    batched_init: with 'auto' (default), models using init_method='random'
    without given_parameters are initialized by one device-side jax.random
    program (negligible init time at any restart count, no global numpy RNG
    use); other configurations fall back to a host loop over the model's own
    initializer (restoring the global RNG state afterwards). True forces the
    device path (raises if unsupported), False forces the host loop.

    compact (None = auto, parallel.compaction.resolve_compact): lane
    compaction - as restarts converge they drop out of the batch in
    halving steps instead of running frozen (full block FLOPs) until the
    slowest restart converges. Works for every family (the
    model's own step functions drive the segments); single-device;
    results match the monolithic loop within f32 program-boundary
    accumulation order (bit-identical on the CPU/f64 reference path).

    checkpoint_dir: preemption-safe resume (checkpoint.ChunkStore).
    Restarts run in chunks of `restart_chunk` lanes (default: all of
    them in one chunk) and each completed chunk is one atomic entry; a
    rerun with identical arguments loads finished chunks and computes
    only the missing ones. Chunk boundaries change the lockstep batch a
    lane shares (same equivalence class as compaction: bit-identical
    per-lane results on CPU/f64, f32 program-boundary accumulation order
    on an accelerator), so pick restart_chunk once per study. Not supported together
    with given_parameters (their values cannot be fingerprinted into the
    run identity). restart_chunk without checkpoint_dir simply batches
    the run in chunks (e.g. to bound device memory).

    verbose=1 prints a live objective-range line per capped segment on
    long (kill-guard-rerouted or compacting capped) runs - the only live
    channel on callback-rejecting backends; short monolithic runs print
    nothing extra.
    """
    is_multimodal = hasattr(model, "mdata") and not hasattr(model, "adata")

    if is_multimodal:
        model._setup_mdata(data_container)
    else:
        model._setup_adata(data_container)
        model._setup_fitting_parameters(fitting_kwargs)

    init_kwargs = {} if init_kwargs is None else dict(init_kwargs)
    device_init_supported = (
        not given_parameters
        and model.init_method == "random"
        and type(model).__name__ in _DEVICE_INIT_FAMILIES
    )
    if batched_init is True and not device_init_supported:
        raise ValueError(
            "batched_init=True requires init_method='random', no "
            f"given_parameters, and a model in {_DEVICE_INIT_FAMILIES}."
        )
    use_device_init = batched_init is not False and device_init_supported

    seeds_init_kwargs = "seed" in init_kwargs or model.init_method in (
        "random", "separableNMF", "nndsvdar"
    )
    # CorrNMF-family models draw their embeddings from the (reseeded) global
    # RNG, so restarts differ even under a deterministic signature init; pure
    # W/H models with a deterministic init would run n identical fits.
    draws_embeddings = hasattr(model, "dim_embeddings")
    if not seeds_init_kwargs and not draws_embeddings:
        import warnings

        warnings.warn(
            f"init_method='{model.init_method}' is deterministic: all "
            f"{n_restarts} restarts will be identical. Use a stochastic "
            "init ('random', 'separableNMF', 'nndsvdar') for a meaningful "
            "multi-start.",
            UserWarning,
        )

    if use_device_init:
        # one host init populates the containers (shapes/names); the actual
        # per-restart parameters come from one batched device program
        kwargs = dict(init_kwargs)
        kwargs.setdefault("seed", base_seed)
        rng_state = np.random.get_state()
        try:
            model._initialize(given_parameters, kwargs)
        finally:
            np.random.set_state(rng_state)
        if not is_multimodal:
            model._setup_fitting_parameters(fitting_kwargs)
        _, data = model._device_state()
        params0 = _device_init_batch(model, data, n_restarts, base_seed)
    else:
        params_per_restart = []
        data = None
        rng_state = np.random.get_state()
        # Pin the init loop's _device_state arrays to the host CPU backend:
        # the upload (jnp.asarray) + fetch (np.asarray) per restart per
        # leaf would otherwise be ~100 device round trips at R=16. The
        # stacked numpy pytree is uploaded ONCE by the jitted engine call
        # below.
        cpu = jax.devices("cpu")[0]
        try:
            with jax.default_device(cpu):
                for restart in range(n_restarts):
                    seed = base_seed + restart
                    # drives unseeded CorrNMF embedding draws
                    np.random.seed(seed)
                    kwargs = dict(init_kwargs)
                    if seeds_init_kwargs:
                        kwargs["seed"] = seed
                    model._initialize(given_parameters, kwargs)
                    if not is_multimodal:
                        model._setup_fitting_parameters(fitting_kwargs)
                    params_r, data = model._device_state()
                    params_per_restart.append(
                        jax.tree.map(np.asarray, params_r)
                    )
        finally:
            np.random.set_state(rng_state)
        params0 = _stack_pytrees(params_per_restart)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .mesh import RESTART_AXIS

        restart_first = NamedSharding(mesh, P(RESTART_AXIS))
        params0 = jax.tree.map(
            lambda leaf: jax.device_put(leaf, restart_first), params0
        )
    update_fn, objective_fn = model._build_step(given_parameters)
    from ..models.signature_nmf import promote_objective

    objective_fn = promote_objective(objective_fn, _index_pytree(params0, 0))
    config = model._fit_config()
    from ..engine import effective_tolerance

    params0_one = _index_pytree(params0, 0)
    objective_dtype = jax.eval_shape(objective_fn, params0_one, data).dtype
    model.history["tol_effective"] = effective_tolerance(
        config, objective_dtype, params0_one
    )
    from .compaction import CompactingRunner, resolve_compact

    progress_cb = None
    if verbose:
        from ..models.signature_nmf import segment_progress_printer

        progress_cb = segment_progress_printer()

    def _cache_get(key):
        return _RUNNER_CACHE.get(key) if key is not None else None

    def _cache_put(key, value):
        if key is not None:
            if len(_RUNNER_CACHE) >= 16:  # bound compiled-program memory
                _RUNNER_CACHE.pop(next(iter(_RUNNER_CACHE)))
            _RUNNER_CACHE[key] = value

    def run_lanes(params0_part, n_lanes: int):
        """One lockstep run over `n_lanes` restarts; returns the FETCHED
        (FitResult, losses) pair (one batched device->host transfer,
        engine/transfer.py).

        Both branches reuse their runner across repeated calls with the
        same family/hyperparams/shapes (the compacting runner additionally
        caches its per-lane-count segment programs) - each run is a fresh
        trace + compile otherwise. Only
        cacheable without given_parameters: the step closures bake given
        values in as constants. Every other closure-captured value is
        either a constructor hyperparameter in the key (lam/delta - the
        only non-shape ones any family bakes in) or shape-determined (k,
        dim_embeddings, ns_signatures), covered by the shape keys."""
        cache_key = None
        if not given_parameters:
            def shape_key(tree):
                leaves, treedef = jax.tree.flatten(tree)
                return (
                    str(treedef),
                    tuple((leaf.shape, str(leaf.dtype))
                          for leaf in leaves),
                )

            cache_key = (
                type(model).__name__, config, compact_min_bucket,
                shape_key(params0_part), shape_key(data),
                getattr(model, "lam", None),
                getattr(model, "delta", None),
                getattr(model, "prior", None),
                bool(jax.config.jax_enable_x64),
            )
        if resolve_compact(compact, config, mesh, n_lanes,
                           compact_min_bucket):
            def make_block_update(data_, _n):
                batched_update = jax.vmap(update_fn, in_axes=(0, None))

                def block(params, steps):
                    return jax.lax.fori_loop(
                        0, steps, lambda _, q: batched_update(q, data_),
                        params,
                    )

                return block

            runner = _cache_get(cache_key)
            if runner is None:
                runner = CompactingRunner(
                    config, objective_fn, make_block_update,
                    min_bucket=compact_min_bucket,
                )
                _cache_put(cache_key, runner)
            runner.progress = progress_cb
            try:
                result, losses_device = runner.run(params0_part, data)
            finally:
                runner.progress = None
        else:
            mono_key = (
                None if cache_key is None
                else ("mono", progress_cb is not None) + cache_key
            )
            pair = _cache_get(mono_key)
            if pair is None:
                run = make_fit_function(
                    update_fn, objective_fn, config, batched=True,
                    unroll=getattr(model, "_unroll_blocks", False),
                    progress_cb=progress_cb,
                )
                losses_fn = jax.jit(jax.vmap(objective_fn, in_axes=(0, None)))
                pair = (run, losses_fn)
                _cache_put(mono_key, pair)
            run, losses_fn = pair
            result = run(params0_part, data)
            losses_device = losses_fn(result.params, data)
        return fetch_pytree((result, losses_device))

    store = None
    if checkpoint_dir is not None:
        if given_parameters:
            raise ValueError(
                "checkpoint_dir= does not support given_parameters: their "
                "values cannot be fingerprinted into the run identity."
            )
        store = _best_of_store(
            checkpoint_dir, model, is_multimodal, n_restarts, base_seed,
            config, restart_chunk, mesh,
        )
    if restart_chunk is None or restart_chunk >= n_restarts:
        chunks = [(0, n_restarts)]
    else:
        size = max(1, int(restart_chunk))
        chunks = [
            (lo, min(lo + size, n_restarts))
            for lo in range(0, n_restarts, size)
        ]
    parts = []
    for lo, hi in chunks:
        name = f"restarts_{lo}_{hi}"
        entry = store.load(name) if store is not None else None
        if entry is not None:
            parts.append(_entry_to_result(entry, params0, lo, hi))
            continue
        part0 = jax.tree.map(lambda leaf: leaf[lo:hi], params0)
        result, losses = run_lanes(part0, hi - lo)
        if store is not None:
            store.save(name, **_result_to_entry(result, losses))
        parts.append((result, losses))
    if len(parts) == 1:
        result, final_losses = parts[0]
    else:
        result = jax.tree.map(
            lambda *leaves: np.concatenate([np.asarray(x) for x in leaves]),
            *[p[0] for p in parts],
        )
        final_losses = np.concatenate(
            [np.asarray(p[1]) for p in parts]
        )
    direction = getattr(model, "objective", "minimize")
    best = int(np.argmax(final_losses)) if direction == "maximize" else int(
        np.argmin(final_losses)
    )

    model._absorb_params(_index_pytree(result.params, best))
    model._is_fitted = True
    n_evals = np.asarray(result.n_evals)
    model.history["objective_function"] = list(
        np.asarray(result.history[best])[: int(n_evals[best])]
    )
    model.history["n_iterations"] = int(np.asarray(result.n_iterations)[best])
    model.history["multistart_losses"] = final_losses.tolist()

    return MultiStartSummary(
        losses=final_losses,
        n_iterations=np.asarray(result.n_iterations),
        best_index=best,
        history=np.asarray(result.history),
        n_evals=n_evals,
        signatures=_signature_stack(result.params),
    )

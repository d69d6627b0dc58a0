"""Padded CorrNMF model-selection scans: many (rank, dim) points, few
compiled programs, first-class fitted models.

The model-selection axes for CorrNMF are n_signatures AND dim_embeddings
(the reference defaults dim_embeddings to n_signatures precisely because
users tune it, /root/reference/src/salamander/models/corrnmf.py:60-63).
Driven through the generic rank_scan() each grid point costs one XLA
compilation. Here
every (k, m) is padded to a shared (Kp, mp) bucket and runs as lanes of ONE
compiled program per bucket, using the rank- and dim-masked CorrNMF step
(ops/corrnmf.py make_masked_corrnmf_step):

  - K-padding: padded signatures' scalings sit at NEG_PAD_SCALING, making
    their exposures/aux/rates exact zeros;
  - m-padding: zero-initialized embedding dimensions have identically zero
    gradient and a block-diagonal Hessian row, so they stay exactly zero
    (pad_rank_corrnmf docstring has the argument).

Equivalence to the unpadded programs is pinned by tests/test_rank_padding.py
(trajectory-level ~1e-9/cycle: XLA picks different fma/reduction kernels per
contraction width, and the branchy Newton amplifies ulps - the same caveat
as the K-only padding).

A k x m grid multiplies the unpadded compile count by |m-range| while
the padded scan keeps one program per (Kp, mp) bucket.

Each scan point comes back as a CorrScanResult carrying a FITTED model
(winner lanes absorbed into the model class, full analysis/plotting surface
available) plus the per-restart loss table and objective traces.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import numpy as np

from ..engine import FitConfig, make_fit_function
from ..engine.transfer import fetch_pytree
from ..ops import corrnmf as corr_ops


@functools.lru_cache(maxsize=8)
def _cached_masked_run(config: FitConfig, x64: bool):
    """One engine program + final-losses evaluator per FitConfig: repeated
    scans (and every bucket of one scan) share a single jit cache instead
    of re-tracing per call (the klnmf twin's _cached_masked_runner
    pattern). x64 is part of the key because promote_objective's wrapping
    depends on it. Mesh runs share the same jitted function: lane sharding
    comes from the committed input arrays (device_put with a NamedSharding)
    and propagates through the jit."""
    from ..models.signature_nmf import promote_objective

    update_fn, objective_fn = corr_ops.make_masked_corrnmf_step()
    import jax.numpy as jnp

    objective = promote_objective(
        objective_fn, {"probe": jnp.zeros((), jnp.float32)}
    )
    run = make_fit_function(
        update_fn, objective, config, batched=True, unroll=False,
    )
    losses_fn = jax.jit(jax.vmap(objective, in_axes=(0, None)))
    return run, losses_fn


# the batched aux/ratio intermediates cost ~3 (D, V) + 2 (D, Kp) buffers
# per lane; cap lanes per program call so big cohorts don't OOM (every
# call of a bucket still shares the SAME compiled program: per-point calls
# all carry n_restarts lanes of identical shape). Size on a 16 GiB device,
# scaled by device.memory_budget.
_LANE_BUDGET_BYTES = 4 * 1024**3

_PARAM_KEYS = (
    "signatures", "signature_scalings", "sample_scalings",
    "signature_embeddings", "sample_embeddings", "variance", "exposures",
)


class CorrScanResult(NamedTuple):
    """Per-point outcome of a (padded) multi-start CorrNMF scan."""

    losses: Any        # (n_restarts,) final ELBO per restart (maximize)
    n_iterations: Any  # (n_restarts,)
    best_index: int
    best_params: dict  # host pytree of the winning restart, padding stripped
    model: Any = None  # fitted model holding the winning restart
    history: Any = None   # (n_restarts, max_evals) objective traces
    n_evals: Any = None   # (n_restarts,)
    signatures: Any = None  # (n_restarts, n_features, k) all restarts'
    # signature matrices (features x signature COLUMNS - the same
    # orientation as RestartResult.W and MultiStartSummary.signatures),
    # padding stripped - feeds tools.signature_stability directly

    @property
    def best_loss(self) -> float:
        return float(self.losses[self.best_index])


def _roundup(value: int, bucket: int) -> int:
    return ((value + bucket - 1) // bucket) * bucket


def _checkpointed_corrnmf_scan(checkpoint_dir, X, points, grid_mode, dims,
                               ranks, n_restarts, base_seed, config,
                               pad_ranks, rank_bucket, dim_bucket,
                               init_method, mesh, model_factory,
                               build_models, pack_points, compact,
                               compact_min_bucket):
    """Per-point resumable twin of rank_scan_corrnmf: every completed
    (k[, m]) point is one atomic ChunkStore entry (host arrays + the
    stripped winner pytree); missing points run through the normal driver
    as singleton scans with their ORIGINAL offset-keyed seeds and padded
    shapes (packing never changes per-lane results), and loaded points
    rebuild their fitted model exactly as the driver's build_model does."""
    from ..checkpoint import ChunkStore, data_fingerprint
    from ..containers import AnnData
    from .restarts import _mesh_meta

    store = ChunkStore(checkpoint_dir, {
        "task": "rank_scan_corrnmf",
        "points": [[int(k), int(m)] for k, m in points],
        "n_restarts": int(n_restarts),
        "base_seed": int(base_seed),
        "config": list(config),
        "pad_ranks": bool(pad_ranks),
        "rank_bucket": int(rank_bucket),
        "dim_bucket": int(dim_bucket),
        "grid_mode": bool(grid_mode),
        "init_method": str(init_method),
        "mesh": _mesh_meta(mesh),
        "data": data_fingerprint(np.asarray(X)),
    })
    cpu = jax.devices("cpu")[0]
    rng_state = np.random.get_state()
    results: dict = {}
    try:
        for offset, (k, m) in enumerate(points):
            result_key = (k, m) if grid_mode else k
            name = f"point_k{k}_m{m}"
            entry = store.load(name)
            if entry is None:
                sub = rank_scan_corrnmf(
                    X, [k],
                    dim_embeddings=None if grid_mode else m,
                    n_restarts=n_restarts,
                    base_seed=base_seed + 1000 * offset,
                    config=config, pad_ranks=pad_ranks,
                    rank_bucket=rank_bucket, init_method=init_method,
                    dim_embeddings_range=[m] if grid_mode else None,
                    dim_bucket=dim_bucket, mesh=mesh,
                    model_factory=model_factory,
                    build_models=build_models,
                    pack_points=pack_points, compact=compact,
                    compact_min_bucket=compact_min_bucket,
                )[result_key]
                payload = {
                    "losses": np.asarray(sub.losses),
                    "n_iterations": np.asarray(sub.n_iterations),
                    "best_index": np.asarray(sub.best_index),
                    "history": np.asarray(sub.history),
                    "n_evals": np.asarray(sub.n_evals),
                    "signatures": np.asarray(sub.signatures),
                }
                for pkey, value in sub.best_params.items():
                    payload[f"bp_{pkey}"] = np.asarray(value)
                store.save(name, **payload)
                results[result_key] = sub
                continue
            best = int(entry["best_index"])
            best_params = {
                pkey[3:]: entry[pkey]
                for pkey in entry if pkey.startswith("bp_")
            }
            model = None
            if build_models:
                model = model_factory(k, m)
                model._setup_adata(AnnData(X.copy()))
                seed = base_seed + 1000 * offset + best
                np.random.seed(seed)
                with jax.default_device(cpu):
                    model._initialize(init_kwargs={"seed": seed})
                    model._setup_fitting_parameters()
                model._absorb_params(best_params)
                model._is_fitted = True
                n_evals_best = int(entry["n_evals"][best])
                model.history["objective_function"] = list(
                    entry["history"][best][:n_evals_best]
                )
                model.history["n_iterations"] = int(
                    entry["n_iterations"][best]
                )
                model.history["step_freq"] = config.conv_test_freq
            results[result_key] = CorrScanResult(
                losses=entry["losses"],
                n_iterations=entry["n_iterations"],
                best_index=best,
                best_params=best_params,
                model=model,
                history=entry["history"],
                n_evals=entry["n_evals"],
                signatures=entry["signatures"],
            )
    finally:
        np.random.set_state(rng_state)
    return results


def rank_scan_corrnmf(
    X,
    n_signatures_range,
    dim_embeddings: int | None = None,
    n_restarts: int = 1,
    base_seed: int = 0,
    config: FitConfig | None = None,
    pad_ranks: bool = True,
    rank_bucket: int = 4,
    init_method: str = "nndsvd",
    dim_embeddings_range=None,
    dim_bucket: int = 2,
    mesh=None,
    model_factory=None,
    build_models: bool = True,
    pack_points: bool | None = None,
    compact: bool | None = None,
    compact_min_bucket: int = 4,
    checkpoint_dir=None,
):
    """Multi-start CorrNMF model-selection scan over n_signatures (and
    optionally dim_embeddings).

    X: (n_samples, n_features) counts (model orientation, samples as rows).

    Scan axes: every k in `n_signatures_range` is fitted at dim_embeddings
    `dim_embeddings` (returns {k: CorrScanResult}); passing
    `dim_embeddings_range` instead scans the full (k, m) grid and returns
    {(k, m): CorrScanResult}. With pad_ranks=True, ranks round up to
    multiples of `rank_bucket` (and grid dims to multiples of `dim_bucket`)
    and all points of a (Kp, mp) bucket share ONE compiled program with
    per-lane masks; pad_ranks=False compiles one program per distinct point
    (same code path with all-true masks). Fixed-m scans never pad m, so
    their results are unchanged from the m-unaware driver.

    Restart r of grid-offset o is seeded base_seed + 1000*o + r (offsets
    enumerate the k range, then the grid in m-major order), matching the
    generic rank_scan/fit_best_of convention.

    Padding equivalence caveat: padded lanes are EQUATION-exact (masked
    ranks/dims contribute exact zeros) but not bitwise — XLA picks
    different fma/reduction kernels per contraction width, and CorrNMF's
    branchy Newton line search amplifies those ulps over a fit. Fixed-m
    scans agree with dedicated per-point fits at trajectory level
    (~1e-9/cycle); (k, m) GRID scans with m-padding agree only to ~5e-3
    at best-ELBO level, which is enough to flip which restart wins a
    point. Compare padded grid scans against other padded grid scans
    (or rerun the winner as a dedicated fit via `model_factory`) rather
    than expecting them to reproduce dedicated-fit restart winners.

    model_factory(k, m) may override the fitted class/hyperparameters
    (default: CorrNMFDet(n_signatures=k, dim_embeddings=m,
    init_method=init_method)); it drives BOTH the per-lane initialization
    and the winner models. With build_models=True (default) each result
    carries a fitted model exposing the full analysis surface (plot_*,
    transform, checkpoints); build_models=False skips the per-point host
    re-initialization and leaves result.model as None.

    mesh: a (restarts, samples) Mesh from parallel.make_mesh shards the
    LANE axis of every program call over its 'restarts' axis (each call's
    lane count - n_restarts per grid point in a chunk - must divide
    evenly). The only cross-device communication is the final argmax.

    pack_points (None = auto, parallel.restarts._resolve_pack): several
    points of a bucket share one lockstep call only for fixed-length
    runs - with early exit active, fast points burn the slowest point's
    iterations (frozen lanes still compute) and
    the Newton inner loops couple across lanes. Per-point calls of a
    bucket still share ONE compiled program. Results identical either
    way (per-lane freezing).

    compact (None = auto, parallel.compaction.resolve_compact): lane
    compaction per call - converged restarts drop out of the batch in
    halving steps instead of running frozen through every remaining
    lockstep EM cycle (each cycle carries the batched Newton embedding
    update, so frozen CorrNMF lanes are especially expensive).
    Composes with meshes; results match within f32 program-boundary
    accumulation order (same caveat class as the padding equivalence
    above).

    checkpoint_dir: per-point preemption-safe resume
    (checkpoint.ChunkStore) - each completed (k[, m]) point is one atomic
    entry; a rerun with identical arguments loads finished points and
    computes only the missing ones. The store cannot fingerprint a custom
    `model_factory` - resuming with a DIFFERENT factory but otherwise
    identical arguments silently reuses the old entries; keep one
    directory per factory.
    """
    from ..containers import AnnData
    from ..models import CorrNMFDet

    config = config or FitConfig()
    ranks = [int(k) for k in n_signatures_range]
    grid_mode = dim_embeddings_range is not None
    if grid_mode:
        dims = [int(m) for m in dim_embeddings_range]
    else:
        if dim_embeddings is None:
            raise ValueError(
                "Pass dim_embeddings (fixed-m scan) or "
                "dim_embeddings_range (grid scan)."
            )
        dims = [int(dim_embeddings)]
    if model_factory is None:
        def model_factory(k, m):
            return CorrNMFDet(
                n_signatures=k, dim_embeddings=m, init_method=init_method,
            )
    X = np.asarray(X, dtype=float)
    # one container for the whole scan (every lane shares the same counts;
    # _setup_adata's EPSILON clip is idempotent)
    adata = AnnData(X.copy())

    # grid points in (m-major, k-minor) order; offset drives seeding
    points = [(k, m) for m in dims for k in ranks]

    if checkpoint_dir is not None:
        return _checkpointed_corrnmf_scan(
            checkpoint_dir, X, points, grid_mode, dims, ranks, n_restarts,
            base_seed, config, pad_ranks, rank_bucket, dim_bucket,
            init_method, mesh, model_factory, build_models, pack_points,
            compact, compact_min_bucket,
        )

    # group points into shared-(Kp, mp) buckets
    buckets: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
    for offset, (k, m) in enumerate(points):
        padded_k = _roundup(k, rank_bucket) if pad_ranks else k
        padded_m = (
            _roundup(m, dim_bucket) if (pad_ranks and grid_mode) else m
        )
        buckets.setdefault((padded_k, padded_m), []).append((offset, k, m))

    from .compaction import mesh_restart_ways, resolve_compact

    compact = resolve_compact(compact, config, mesh, n_restarts,
                              compact_min_bucket)
    run, losses_fn = _cached_masked_run(
        config, bool(jax.config.jax_enable_x64)
    )
    compacting_runner = None
    if compact:
        from .compaction import _cached_corrnmf_compacting_runner

        compacting_runner = _cached_corrnmf_compacting_runner(
            config, bool(jax.config.jax_enable_x64), compact_min_bucket,
            lane_multiple=mesh_restart_ways(mesh),
        )
    rng_state = np.random.get_state()
    results: dict = {}
    cpu = jax.devices("cpu")[0]
    lane_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .mesh import RESTART_AXIS

        lane_sharding = NamedSharding(mesh, P(RESTART_AXIS))

    def run_group(padded_k, padded_m, group):
        """One program call for `group` (list of (offset, k, m)): returns
        the fetched (result, final_losses)."""
        lanes = []
        data = None
        with jax.default_device(cpu):
            for offset, k, m in group:
                for restart in range(n_restarts):
                    seed = base_seed + 1000 * offset + restart
                    model = model_factory(k, m)
                    model._setup_adata(adata)
                    np.random.seed(seed)
                    model._initialize(init_kwargs={"seed": seed})
                    model._setup_fitting_parameters()
                    params, data = model._device_state()
                    padded = corr_ops.pad_rank_corrnmf(
                        params, padded_k, padded_m
                    )
                    lanes.append(jax.tree.map(np.asarray, padded))
        params0 = jax.tree.map(lambda *leaves: np.stack(leaves), *lanes)
        if lane_sharding is not None:
            params0 = jax.tree.map(
                lambda leaf: jax.device_put(leaf, lane_sharding), params0
            )
            from jax.sharding import NamedSharding, PartitionSpec as P

            data = jax.tree.map(
                lambda leaf: jax.device_put(
                    leaf, NamedSharding(mesh, P())
                ),
                data,
            )
        if compacting_runner is not None:
            result, final_losses = compacting_runner.run(params0, data)
        else:
            result = run(params0, data)
            final_losses = losses_fn(result.params, data)
        # DEVICE handles - the caller defers the synchronizing fetch
        # until every group is dispatched, so the next group's host-side
        # per-restart init overlaps this group's device compute
        return result, final_losses

    def build_model(k, m, best_params, seed):
        model = model_factory(k, m)
        model._setup_adata(AnnData(X.copy()))
        np.random.seed(seed)
        with jax.default_device(cpu):
            model._initialize(init_kwargs={"seed": seed})
            model._setup_fitting_parameters()
        model._absorb_params(best_params)
        model._is_fitted = True
        return model

    def absorb(result, final_losses, group):
        for i, (offset, k, m) in enumerate(group):
            sl = slice(i * n_restarts, (i + 1) * n_restarts)
            losses = np.asarray(final_losses[sl])
            best = int(np.argmax(losses))  # ELBO: maximize
            lane = sl.start + best
            best_params = {}
            for key in _PARAM_KEYS:
                value = np.asarray(result.params[key][lane])
                if key in ("signatures", "signature_scalings"):
                    value = value[:k]
                elif key == "signature_embeddings":
                    value = value[:k, :m]
                elif key == "sample_embeddings":
                    value = value[:, :m]
                elif key == "exposures":
                    value = value[:, :k]
                best_params[key] = value
            model = None
            if build_models:
                model = build_model(
                    k, m, best_params, base_seed + 1000 * offset + best
                )
                n_evals_best = int(np.asarray(result.n_evals)[lane])
                model.history["objective_function"] = list(
                    np.asarray(result.history[lane])[:n_evals_best]
                )
                model.history["n_iterations"] = int(
                    np.asarray(result.n_iterations)[lane]
                )
                model.history["step_freq"] = config.conv_test_freq
            results[(k, m) if grid_mode else k] = CorrScanResult(
                losses=losses,
                n_iterations=np.asarray(result.n_iterations[sl]),
                best_index=best,
                best_params=best_params,
                model=model,
                history=np.asarray(result.history[sl]),
                n_evals=np.asarray(result.n_evals[sl]),
                signatures=np.asarray(
                    result.params["signatures"][sl]
                )[:, :k, :].transpose(0, 2, 1),
            )

    from .restarts import _resolve_pack

    pack = _resolve_pack(pack_points, config)
    n_samples, n_features = X.shape
    from ..device import memory_budget
    from .restarts import _INFLIGHT_BUDGET_BYTES, _pytree_nbytes

    def drain(in_flight):
        for chunk, pair in in_flight:
            # one batched device->host transfer per chunk
            result, final_losses = fetch_pytree(pair)
            absorb(result, final_losses, chunk)
        in_flight.clear()

    lane_budget = memory_budget(_LANE_BUDGET_BYTES)
    inflight_budget = memory_budget(_INFLIGHT_BUDGET_BYTES)
    try:
        in_flight = []
        for (padded_k, padded_m), group in sorted(buckets.items()):
            per_lane = (
                3 * n_samples * n_features + 2 * n_samples * padded_k
            ) * 8
            lanes_cap = max(n_restarts, lane_budget // per_lane)
            if pack and len(group) * n_restarts <= lanes_cap:
                chunks = [group]
            else:
                # one point per call: every call still has n_restarts lanes
                # of identical shape, so the bucket keeps ONE compiled
                # program (the klnmf twin's memory guard)
                chunks = [[entry] for entry in group]
            for chunk in chunks:
                in_flight.append(
                    (chunk, run_group(padded_k, padded_m, chunk))
                )
                # byte-bounded deferral: every in-flight chunk retains its
                # full device FitResult until fetched
                if sum(_pytree_nbytes(p) for _, p in in_flight) > \
                        inflight_budget:
                    drain(in_flight)
        drain(in_flight)
    finally:
        np.random.set_state(rng_state)
    return results

"""Batched multi-start fits and rank scans.

The reference's tutorial runs restarts and rank scans as serial Python loops
over single fits; here all restarts of one rank are ONE device program: the
batched init lives on device, every restart steps in lockstep inside the
jitted convergence engine (converged lanes frozen), and only the final loss
table returns to the host. Under a multi-device mesh the restart axis is
sharded (perfect scaling - no communication) and the sample axis may be
sharded too (XLA all-reduces the cross-sample contractions).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..device import default_device, memory_budget
from ..engine import FitConfig, fit_loop_lockstep
from ..engine.transfer import fetch_pytree
from .compaction import resolve_compact
from ..initialization.methods import random_init_batch
from ..ops import klnmf as ops
from .mesh import restart_sharding


class RestartResult(NamedTuple):
    """Outcome of a batched multi-start fit.

    W and H stay DEVICE-resident (fetching all restarts' exposures can be
    hundreds of MB at COSMIC scale); losses/n_iterations are host arrays.
    best_W/best_H extract the winning lane with a jitted index and fetch it
    in one batched transfer."""

    W: Any            # (R, V, K) signatures per restart
    H: Any            # (R, K, D) exposures per restart
    losses: Any       # (R,) final objective per restart
    n_iterations: Any # (R,) iterations run per restart
    best_index: int

    @property
    def best_loss(self) -> float:
        return float(self.losses[self.best_index])

    def _best_lane(self, leaf):
        if isinstance(leaf, np.ndarray):
            return leaf[self.best_index]
        return fetch_pytree(_extract_lane(leaf, self.best_index))

    @property
    def best_W(self):
        return self._best_lane(self.W)

    @property
    def best_H(self):
        return self._best_lane(self.H)


@jax.jit
def _extract_lane(stacked, index):
    return stacked[index]


# Deferred-fetch budget: scan drivers dispatch every point's fit before the
# first synchronizing fetch (the next point's host init overlaps the
# previous point's device compute), but each in-flight point retains its
# full device result until fetched - so the queue flushes once the retained
# bytes exceed this cap, keeping peak device memory bounded at COSMIC
# scales where the per-call lane budgets alone used to be the guard. Both
# budgets are sizes on a 16 GiB device, scaled by device.memory_budget.
_INFLIGHT_BUDGET_BYTES = 2 * 1024**3
_LANE_BUDGET_BYTES = 4 * 1024**3


def _pytree_nbytes(tree) -> int:
    return sum(
        getattr(leaf, "nbytes", 0) for leaf in jax.tree.leaves(tree)
    )


def _drain_scan_fetches(in_flight, n_restarts: int, results: dict) -> None:
    """Fetch each deferred (group, losses, n_iterations, params) entry and
    slice per-rank RestartResults out of it (shared by the K-padded KLNMF
    and MvNMF scan drivers). Clears `in_flight`."""
    for group, losses, n_iterations, params in in_flight:
        losses, n_iterations, W, H = fetch_pytree(
            (losses, n_iterations, params["W"], params["H"])
        )
        for i, (offset, k) in enumerate(group):
            lanes = slice(i * n_restarts, (i + 1) * n_restarts)
            losses_k = losses[lanes]
            results[k] = RestartResult(
                W=W[lanes][:, :, :k],
                H=H[lanes][:, :k, :],
                losses=losses_k,
                n_iterations=n_iterations[lanes],
                best_index=int(np.argmin(losses_k)),
            )
    in_flight.clear()


def _rank_scan_with_checkpoint(checkpoint_dir, task: str, X, ranks,
                               n_restarts: int, seed: int,
                               config: FitConfig, meta_extra: dict,
                               run_point):
    """Per-rank resumable wrapper shared by the K-padded scan drivers.

    Each completed rank is one atomic ChunkStore entry (host arrays); a
    rerun with the identical arguments loads finished ranks and computes
    only the missing ones. run_point(offset, k) -> RestartResult computes
    one rank through the normal driver with its ORIGINAL seed
    (seed + 1000 * offset): singleton scans reproduce the full scan's
    per-rank programs exactly - seeds are offset-keyed, padded shapes are
    per-rank, and packing never changes per-lane results (pinned by
    tests/test_rank_padding.py). Note the checkpointed path materializes
    every rank's (R, K, D) exposures on host (the store is on disk);
    the non-checkpointed drivers keep them device-resident.
    """
    from ..checkpoint import ChunkStore, data_fingerprint

    store = ChunkStore(checkpoint_dir, {
        "task": task,
        "ranks": [int(k) for k in ranks],
        "n_restarts": int(n_restarts),
        "seed": int(seed),
        "config": list(config),
        "data": data_fingerprint(np.asarray(X)),
        **meta_extra,
    })
    results: dict[int, RestartResult] = {}
    for offset, k in enumerate(ranks):
        entry = store.load(f"rank{k}")
        if entry is not None:
            results[int(k)] = RestartResult(
                W=entry["W"], H=entry["H"], losses=entry["losses"],
                n_iterations=entry["n_iterations"],
                best_index=int(entry["best_index"]),
            )
            continue
        sub = run_point(offset, int(k))
        W, H = fetch_pytree((sub.W, sub.H))
        host = RestartResult(
            W=np.asarray(W), H=np.asarray(H),
            losses=np.asarray(sub.losses),
            n_iterations=np.asarray(sub.n_iterations),
            best_index=int(sub.best_index),
        )
        store.save(
            f"rank{k}", W=host.W, H=host.H, losses=host.losses,
            n_iterations=host.n_iterations,
            best_index=np.asarray(host.best_index),
        )
        results[int(k)] = host
    return results


def _mesh_meta(mesh):
    """JSON-safe mesh identity for checkpoint metas (axis name/size pairs;
    None off-mesh)."""
    if mesh is None:
        return None
    return [[str(name), int(size)] for name, size in mesh.shape.items()]


def _lockstep_run(update_fn, objective_fn, config: FitConfig):
    """The shared natively-batched fit: one lockstep while_loop over all
    restarts, per-lane convergence, final losses evaluated on device."""

    def run(params0, data):
        batched_update = jax.vmap(lambda p: update_fn(p, data))
        batched_objective = jax.vmap(lambda p: objective_fn(p, data))

        def block(params, steps):
            return jax.lax.fori_loop(
                0, steps, lambda _, q: batched_update(q), params
            )

        result = fit_loop_lockstep(batched_objective, params0, config, block)
        final_loss = batched_objective(result.params)
        return result.params, final_loss, result.n_iterations

    return run


def build_klnmf_restart_runner(config: FitConfig, weighted: bool = False,
                               mesh=None):
    """Compile (once) the batched multi-start KLNMF fit.

    Returns a jitted function (params0, data) -> (FitResult, losses) where
    params0 = {"W": (R,V,K), "H": (R,K,D)} and data = {"X": (V,D)} plus any
    'weights_kl'/'weights_lhalf' entries (`weighted` is accepted for call
    compatibility; the weights always come from the data pytree at call
    time).
    """
    del weighted
    update_fn, objective_fn = ops.make_step_functions()

    # Natively-batched lockstep loop (one while over the whole batch):
    # ~40% higher aggregate throughput than vmap-of-while for multi-start.
    run = _lockstep_run(update_fn, objective_fn, config)

    if mesh is None:
        return jax.jit(run)

    shardings = restart_sharding(mesh)
    in_shardings = (
        {"W": shardings["W"], "H": shardings["H"]},
        {"X": shardings["X"]},
    )
    out_shardings = (
        {"W": shardings["W"], "H": shardings["H"]},
        shardings["per_restart"],
        shardings["per_restart"],
    )
    return jax.jit(run, in_shardings=in_shardings, out_shardings=out_shardings)


def fit_klnmf_restarts(
    X,
    n_signatures: int,
    n_restarts: int,
    seed: int = 0,
    config: FitConfig | None = None,
    weights_kl=None,
    weights_lhalf=None,
    mesh=None,
    dtype=jnp.float32,
    runner=None,
    compact: bool | None = None,
    compact_min_bucket: int = 8,
) -> RestartResult:
    """Fit `n_restarts` random-initialized KLNMF models at once on device.

    X is (n_features, n_samples) in kernel orientation. Pass a `mesh` from
    make_mesh() to shard restarts/samples across devices; pass a prebuilt
    `runner` (build_klnmf_restart_runner) to amortize compilation across
    calls with identical shapes/config.

    compact (None = auto, parallel.compaction.resolve_compact): run the
    fit through the lane-compacting driver - as restarts converge,
    survivors are gathered into half-size batches so frozen lanes stop
    burning block FLOPs. Auto enables it on accelerators for
    convergence-based fits with n_restarts >= 2*compact_min_bucket (one
    halving; see resolve_compact); per-lane
    results match within f32 program-boundary accumulation order
    (bit-identical schedules).
    """
    config = config or FitConfig()
    if runner is None and resolve_compact(
        compact, config, mesh, n_restarts, compact_min_bucket
    ):
        from .compaction import fit_klnmf_restarts_compacting

        return fit_klnmf_restarts_compacting(
            X, n_signatures, n_restarts, seed=seed, config=config,
            weights_kl=weights_kl, weights_lhalf=weights_lhalf,
            dtype=dtype, min_bucket=compact_min_bucket, mesh=mesh,
        )
    X = jnp.asarray(X, dtype)
    key = jax.random.PRNGKey(seed)
    W0, H0 = random_init_batch(key, X, n_signatures, n_restarts, dtype)

    data = {"X": X}
    if weights_kl is not None:
        data["weights_kl"] = jnp.asarray(weights_kl, dtype)
    if weights_lhalf is not None:
        data["weights_lhalf"] = jnp.asarray(weights_lhalf, dtype)

    if runner is None:
        runner = build_klnmf_restart_runner(
            config,
            weighted=(weights_kl is not None or weights_lhalf is not None),
            mesh=mesh,
        )
    if mesh is not None:
        shardings = restart_sharding(mesh)
        W0 = jax.device_put(W0, shardings["W"])
        H0 = jax.device_put(H0, shardings["H"])
        data["X"] = jax.device_put(data["X"], shardings["X"])

    params, losses, n_iterations = runner({"W": W0, "H": H0}, data)
    losses_host, n_iterations = fetch_pytree((losses, n_iterations))
    best = int(np.argmin(losses_host))
    return RestartResult(
        W=params["W"],
        H=params["H"],
        losses=np.asarray(losses_host),
        n_iterations=np.asarray(n_iterations),
        best_index=best,
    )


def rank_scan(
    model_factory,
    data_container,
    n_signatures_range,
    n_restarts: int,
    base_seed: int = 0,
    **fit_best_of_kwargs,
):
    """Model-selection scan for ANY model family.

    model_factory(k) must return an unfitted model with k signatures (e.g.
    `lambda k: CorrNMFDet(n_signatures=k, dim_embeddings=2)`). Each rank runs
    `n_restarts` batched restarts via fit_best_of; returns {k: (model,
    MultiStartSummary)} with each model holding its best restart.

    A `checkpoint_dir` in fit_best_of_kwargs is split into one
    subdirectory per rank (each rank's run identity differs, so sharing
    one ChunkStore would discard the previous rank's entries on every
    point).
    """
    from pathlib import Path

    from .multistart import fit_best_of

    checkpoint_root = fit_best_of_kwargs.pop("checkpoint_dir", None)
    results = {}
    for offset, k in enumerate(n_signatures_range):
        model = model_factory(int(k))
        container = (
            data_container.copy()
            if hasattr(data_container, "copy")
            else data_container
        )
        kwargs = dict(fit_best_of_kwargs)
        if checkpoint_root is not None:
            kwargs["checkpoint_dir"] = Path(checkpoint_root) / f"rank{k}"
        summary = fit_best_of(
            model, container, n_restarts,
            base_seed=base_seed + 1000 * offset,
            **kwargs,
        )
        results[int(k)] = (model, summary)
    return results


def build_klnmf_masked_runner(config: FitConfig, mesh=None):
    """Compile (once) a rank-MASKED multi-start KLNMF fit: lanes of different
    rank share one K-padded program. params0 = {"W": (R,V,Kp), "H": (R,Kp,D),
    "mask": (R,Kp) bool}; returns (params, losses, n_iterations) like
    build_klnmf_restart_runner."""
    update_fn, objective_fn = ops.make_masked_step_functions()

    run = _lockstep_run(update_fn, objective_fn, config)
    if mesh is None:
        return jax.jit(run)
    shardings = restart_sharding(mesh)
    in_shardings = (
        {"W": shardings["W"], "H": shardings["H"], "mask": shardings["mask"]},
        {"X": shardings["X"]},
    )
    out_shardings = (
        {"W": shardings["W"], "H": shardings["H"], "mask": shardings["mask"]},
        shardings["per_restart"],
        shardings["per_restart"],
    )
    return jax.jit(run, in_shardings=in_shardings, out_shardings=out_shardings)


@functools.partial(
    jax.jit, static_argnames=("n_signatures", "n_restarts", "padded")
)
def _padded_random_init(key, X, n_signatures: int, n_restarts: int,
                        padded: int):
    """Jitted per-rank init for the padded scan: identical draws to the
    unpadded path's random_init_batch + pad_rank. Run it on the HOST CPU
    backend (rank_scan_klnmf passes CPU-committed inputs): each rank is a
    different shape, so each would be one more accelerator compile, and the
    jax threefry PRNG draws are platform-deterministic."""
    W0, H0 = random_init_batch(key, X, n_signatures, n_restarts, X.dtype)
    W0, H0, mask = ops.pad_rank(W0, H0, padded)
    return W0, H0, jnp.broadcast_to(mask, (n_restarts, padded))


def _resolve_pack(pack_points, config: FitConfig) -> bool:
    """Decide whether several scan points may share one lockstep call.

    Frozen (converged) lanes still burn full FLOPs every block
    (engine/fit.py fit_loop_lockstep masked_advance), so packing
    heterogeneous points into one call costs (all lanes) x (slowest
    point's iterations). Packing only pays for FIXED-LENGTH runs
    (min_iterations == max_iterations: no lane finishes early, fuller
    batches amortize launches). Results are
    identical either way: per-lane freezing makes each point's
    trajectory independent of its call's co-tenants.
    """
    if pack_points is None:
        return config.min_iterations >= config.max_iterations
    return bool(pack_points)


@functools.lru_cache(maxsize=8)
def _cached_masked_runner(config: FitConfig, mesh):
    """One jitted masked runner per (config, mesh): repeated rank scans and
    all buckets of one scan share a single jit cache (per-shape compiles)."""
    return build_klnmf_masked_runner(config, mesh=mesh)


def rank_scan_klnmf(
    X,
    n_signatures_range,
    n_restarts: int,
    seed: int = 0,
    config: FitConfig | None = None,
    mesh=None,
    dtype=jnp.float32,
    pad_ranks: bool | None = None,
    rank_bucket: int = 8,
    pack_points: bool | None = None,
    compact: bool | None = None,
    compact_min_bucket: int = 8,
    checkpoint_dir=None,
) -> dict[int, RestartResult]:
    """Multi-start KLNMF over a range of ranks (the model-selection scan the
    reference tutorial runs as a nested Python loop, tutorial.ipynb cell 70).

    checkpoint_dir: preemption-safe resume (checkpoint.ChunkStore) - each
    completed rank is one atomic entry, a rerun with identical arguments
    loads finished ranks and computes only the missing ones (zero
    recompute). The run identity (counts fingerprint, ranks, restarts,
    seed, config, layout knobs) is pinned in meta.json; a mismatch
    discards the store with a warning.

    With pad_ranks=True, ranks are rounded up to multiples of
    `rank_bucket` and every rank in a bucket runs as extra lanes of ONE
    K-padded compiled program with per-lane rank masks: a 19-rank scan costs
    ~3 XLA compilations instead of 19. Per-rank results are identical to
    the unpadded scan (same seeds, masked lanes advance and converge
    independently). pad_ranks=False keeps one compiled program per rank.
    None (default) pads exactly when lane compaction is OFF: under
    compaction, per-rank programs through the compacting driver let each
    rank drop its own converged lanes.

    pack_points: whether several ranks of a bucket may share one lockstep
    program call (None = auto: only for fixed-length runs; see
    _resolve_pack - per-lane results are identical either way, only
    wall-time differs). Packed calls are still capped by the lane memory
    budget.

    compact (None = auto, parallel.compaction.resolve_compact) runs each
    call through the lane-compacting driver (parallel/compaction.py): as
    restarts converge, survivors are gathered into half-size batches so
    frozen lanes stop burning block FLOPs. Composes with meshes
    (compacted lane counts
    stay multiples of the restart-axis device count); costs
    ~log2(n_restarts/compact_min_bucket) extra compiled programs per
    bucket; per-lane results match within f32 program-boundary
    accumulation order."""
    config = config or FitConfig()
    if checkpoint_dir is not None:
        ranks = [int(k) for k in n_signatures_range]
        return _rank_scan_with_checkpoint(
            checkpoint_dir, "rank_scan_klnmf", X, ranks, n_restarts, seed,
            config,
            {
                "dtype": str(jnp.dtype(dtype)),
                "pad_ranks": pad_ranks,
                "rank_bucket": int(rank_bucket),
                "mesh": _mesh_meta(mesh),
            },
            lambda offset, k: rank_scan_klnmf(
                X, [k], n_restarts, seed=seed + 1000 * offset,
                config=config, mesh=mesh, dtype=dtype, pad_ranks=pad_ranks,
                rank_bucket=rank_bucket, pack_points=pack_points,
                compact=compact, compact_min_bucket=compact_min_bucket,
            )[k],
        )
    compact = resolve_compact(compact, config, mesh, n_restarts,
                              compact_min_bucket)
    if pad_ranks is None:
        # compaction (when it triggers) prefers per-rank programs (see
        # docstring)
        pad_ranks = not compact
    ranks = [int(k) for k in n_signatures_range]
    results: dict[int, RestartResult] = {}

    if not pad_ranks:
        if compact:
            from .compaction import (
                finalize_compacting_restarts,
                klnmf_restarts_compacting_device,
            )

            # one device upload of X, shared by every rank's run (passing
            # host X would re-upload it PER RANK and hold N duplicate
            # copies while deferred)
            X = jnp.asarray(X, dtype)
            # dispatch (fetch-free) compacting fits before the first
            # synchronizing fetch: rank r+1's host-side init and dispatch
            # overlap rank r's device compute. The in-flight queue is
            # byte-bounded: every queued run retains its full device
            # FitResult until fetched.
            in_flight: list = []
            retained = 0
            for offset, k in enumerate(ranks):
                run_out = klnmf_restarts_compacting_device(
                    X, k, n_restarts,
                    seed=seed + 1000 * offset,
                    config=config, dtype=dtype,
                    min_bucket=compact_min_bucket, mesh=mesh,
                )
                in_flight.append((k, run_out))
                retained += _pytree_nbytes(run_out)
                if retained > memory_budget(_INFLIGHT_BUDGET_BYTES):
                    for k_done, (result, losses) in in_flight:
                        results[k_done] = finalize_compacting_restarts(
                            result, losses
                        )
                    in_flight, retained = [], 0
            for k_done, (result, losses) in in_flight:
                results[k_done] = finalize_compacting_restarts(result, losses)
            return results
        for offset, k in enumerate(ranks):
            # compact already resolved above - pass the decision through so
            # an explicit compact=False is not re-auto-resolved inside
            results[k] = fit_klnmf_restarts(
                X, k, n_restarts,
                seed=seed + 1000 * offset,
                config=config, mesh=mesh, dtype=dtype, compact=False,
            )
        return results

    X = jnp.asarray(X, dtype)
    data = {"X": X}
    if mesh is not None:
        shardings = restart_sharding(mesh)
        data["X"] = jax.device_put(data["X"], shardings["X"])
    # group ranks into shared-padded-K buckets, keeping each rank's seed
    # identical to the unpadded scan's
    buckets: dict[int, list[tuple[int, int]]] = {}
    for offset, k in enumerate(ranks):
        padded = ((k + rank_bucket - 1) // rank_bucket) * rank_bucket
        buckets.setdefault(padded, []).append((offset, k))

    # Memory guard: the aux ratio intermediate costs ~3 (V, D) buffers per lane,
    # so packing a whole bucket's ranks into one call is only worth it for
    # small problems; otherwise run one rank per call - every call of a
    # bucket still shares the SAME compiled program (identical shapes), so
    # the compile count stays at one per bucket either way.
    per_lane = 3 * X.shape[0] * X.shape[1] * 4
    lanes_cap = max(n_restarts,
                    int(memory_budget(_LANE_BUDGET_BYTES) / per_lane))
    pack = _resolve_pack(pack_points, config)

    try:
        runner = _cached_masked_runner(config, mesh)
    except TypeError:  # unhashable mesh: fall back to a fresh runner
        runner = build_klnmf_masked_runner(config, mesh=mesh)
    target = default_device()
    cpu_device = jax.devices("cpu")[0] if target.platform != "cpu" else None
    X_host = jax.device_put(X, cpu_device) if cpu_device is not None else X
    in_flight: list = []
    for padded, members in sorted(buckets.items()):
        groups = (
            [members] if pack and len(members) * n_restarts <= lanes_cap
            else [[member] for member in members]
        )
        for group in groups:
            W_parts, H_parts, mask_parts = [], [], []
            for offset, k in group:
                key = jax.random.PRNGKey(seed + 1000 * offset)
                if cpu_device is not None:
                    key = jax.device_put(key, cpu_device)
                W0, H0, mask = _padded_random_init(
                    key, X_host, k, n_restarts, padded
                )
                W_parts.append(W0)
                H_parts.append(H0)
                mask_parts.append(mask)
            params0 = {
                "W": jnp.concatenate(W_parts),
                "H": jnp.concatenate(H_parts),
                "mask": jnp.concatenate(mask_parts),
            }
            if cpu_device is not None and mesh is None:
                # host-initialized params move to the accelerator in one
                # transfer (mixed placements would fail inside the runner)
                params0 = jax.device_put(params0, target)
            if mesh is not None:
                params0 = {
                    "W": jax.device_put(params0["W"], shardings["W"]),
                    "H": jax.device_put(params0["H"], shardings["H"]),
                    "mask": jax.device_put(params0["mask"], shardings["mask"]),
                }

            if compact:
                from .compaction import (
                    _cached_compacting_runner,
                    mesh_restart_ways,
                )

                c_runner = _cached_compacting_runner(
                    config, True, compact_min_bucket,
                    lane_multiple=mesh_restart_ways(mesh),
                )
                c_result, losses = c_runner.run(params0, data)
                params = c_result.params
                n_iterations = c_result.n_iterations
            else:
                params, losses, n_iterations = runner(params0, data)
            # defer the synchronizing fetch (byte-bounded): dispatch the
            # next group's host init + device run first
            in_flight.append((group, losses, n_iterations, params))
            if sum(_pytree_nbytes(e) for e in in_flight) > \
                    memory_budget(_INFLIGHT_BUDGET_BYTES):
                _drain_scan_fetches(in_flight, n_restarts, results)
    _drain_scan_fetches(in_flight, n_restarts, results)
    return results


# ---------------------------------------------------------------------------
# MvNMF: K-padded multi-start rank scans (masked-rank twin of the KLNMF
# machinery above; reference model semantics
# /root/reference/src/salamander/models/mvnmf.py:95-218)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _cached_mvnmf_masked_runner(config: FitConfig, lam: float, delta: float,
                                mesh):
    """One jitted masked MvNMF runner per (config, lam, delta, mesh):
    repeated scans and all buckets of one scan share a single jit cache."""
    from ..ops import mvnmf as mv_ops

    update_fn, objective_fn = mv_ops.make_masked_step_functions(lam, delta)
    run = _lockstep_run(update_fn, objective_fn, config)
    if mesh is None:
        return jax.jit(run)
    shardings = restart_sharding(mesh)
    in_shardings = (
        {"W": shardings["W"], "H": shardings["H"],
         "gamma": shardings["per_restart"], "mask": shardings["mask"]},
        {"X": shardings["X"]},
    )
    out_shardings = (
        {"W": shardings["W"], "H": shardings["H"],
         "gamma": shardings["per_restart"], "mask": shardings["mask"]},
        shardings["per_restart"],
        shardings["per_restart"],
    )
    return jax.jit(run, in_shardings=in_shardings,
                   out_shardings=out_shardings)


def rank_scan_mvnmf(
    X,
    n_signatures_range,
    n_restarts: int,
    seed: int = 0,
    lam: float = 1.0,
    delta: float = 1.0,
    config: FitConfig | None = None,
    mesh=None,
    dtype=jnp.float32,
    pad_ranks: bool = True,
    rank_bucket: int = 4,
    pack_points: bool | None = None,
    compact: bool | None = None,
    compact_min_bucket: int = 8,
    checkpoint_dir=None,
) -> dict[int, RestartResult]:
    """Multi-start minimum-volume NMF over a range of ranks.

    checkpoint_dir: per-rank preemption-safe resume, exactly as
    rank_scan_klnmf's.

    The MvNMF twin of rank_scan_klnmf: with pad_ranks=True (default), ranks
    round up to multiples of `rank_bucket` and every rank of a bucket runs
    as lanes of ONE K-padded compiled program (per-lane rank masks; padded
    H rows exact zeros, the volume term and the (Kp, Kp) Gram inverse see
    identity padding - ops/mvnmf.py make_masked_step_functions). The
    line-search gamma persists per lane, exactly as the model's _gamma.
    pad_ranks=False runs the same masked program shapes one-rank-per-
    program (all-true masks). Seeding matches rank_scan_klnmf
    (seed + 1000 * rank_offset). Losses MINIMIZE (KL + lam * volume).

    pack_points (None = auto, see _resolve_pack): packing several ranks
    into one lockstep call loses wall time for convergence-based MvNMF
    scans (fast ranks burn the slow ranks' iterations, and the per-trial
    line-search while_loop couples across lanes), so auto packs only
    fixed-length runs. Results are identical
    either way (per-lane freezing).

    compact (None = auto, parallel.compaction.resolve_compact): lane
    compaction per call - converged restarts are dropped from the batch
    in halving steps instead of burning frozen-lane FLOPs (and, for
    MvNMF, frozen lanes' line-search while_loop trials) until the
    slowest lane converges. Composes with meshes; results match within f32
    program-boundary accumulation order.
    """
    config = config or FitConfig()
    if checkpoint_dir is not None:
        ranks = [int(k) for k in n_signatures_range]
        return _rank_scan_with_checkpoint(
            checkpoint_dir, "rank_scan_mvnmf", X, ranks, n_restarts, seed,
            config,
            {
                "lam": float(lam),
                "delta": float(delta),
                "dtype": str(jnp.dtype(dtype)),
                "pad_ranks": bool(pad_ranks),
                "rank_bucket": int(rank_bucket),
                "mesh": _mesh_meta(mesh),
            },
            lambda offset, k: rank_scan_mvnmf(
                X, [k], n_restarts, seed=seed + 1000 * offset, lam=lam,
                delta=delta, config=config, mesh=mesh, dtype=dtype,
                pad_ranks=pad_ranks, rank_bucket=rank_bucket,
                pack_points=pack_points, compact=compact,
                compact_min_bucket=compact_min_bucket,
            )[k],
        )
    compact = resolve_compact(compact, config, mesh, n_restarts,
                              compact_min_bucket)
    ranks = [int(k) for k in n_signatures_range]
    results: dict[int, RestartResult] = {}

    X = jnp.asarray(X, dtype)
    data = {"X": X}
    if mesh is not None:
        shardings = restart_sharding(mesh)
        data["X"] = jax.device_put(data["X"], shardings["X"])

    buckets: dict[int, list[tuple[int, int]]] = {}
    for offset, k in enumerate(ranks):
        padded = (
            ((k + rank_bucket - 1) // rank_bucket) * rank_bucket
            if pad_ranks else k
        )
        buckets.setdefault(padded, []).append((offset, k))

    # memory guard as in rank_scan_klnmf: the line search re-evaluates the
    # KL ratio per trial, ~4 (V, D) buffers per lane live simultaneously
    per_lane = 4 * X.shape[0] * X.shape[1] * 4
    lanes_cap = max(n_restarts,
                    int(memory_budget(_LANE_BUDGET_BYTES) / per_lane))
    pack = _resolve_pack(pack_points, config)

    try:
        runner = _cached_mvnmf_masked_runner(
            config, float(lam), float(delta), mesh
        )
    except TypeError:  # unhashable mesh
        from ..ops import mvnmf as mv_ops

        update_fn, objective_fn = mv_ops.make_masked_step_functions(
            float(lam), float(delta)
        )
        runner = jax.jit(_lockstep_run(update_fn, objective_fn, config))
    target = default_device()
    cpu_device = jax.devices("cpu")[0] if target.platform != "cpu" else None
    X_host = jax.device_put(X, cpu_device) if cpu_device is not None else X
    in_flight: list = []
    for padded, members in sorted(buckets.items()):
        groups = (
            [members] if pack and len(members) * n_restarts <= lanes_cap
            else [[member] for member in members]
        )
        for group in groups:
            W_parts, H_parts, mask_parts = [], [], []
            for offset, k in group:
                key = jax.random.PRNGKey(seed + 1000 * offset)
                if cpu_device is not None:
                    key = jax.device_put(key, cpu_device)
                W0, H0, mask = _padded_random_init(
                    key, X_host, k, n_restarts, padded
                )
                W_parts.append(W0)
                H_parts.append(H0)
                mask_parts.append(mask)
            n_lanes = len(group) * n_restarts
            params0 = {
                "W": jnp.concatenate(W_parts),
                "H": jnp.concatenate(H_parts),
                "gamma": jnp.ones((n_lanes,), dtype),
                "mask": jnp.concatenate(mask_parts),
            }
            if cpu_device is not None and mesh is None:
                params0 = jax.device_put(params0, target)
            if mesh is not None:
                params0 = {
                    "W": jax.device_put(params0["W"], shardings["W"]),
                    "H": jax.device_put(params0["H"], shardings["H"]),
                    "gamma": jax.device_put(
                        params0["gamma"], shardings["per_restart"]
                    ),
                    "mask": jax.device_put(params0["mask"], shardings["mask"]),
                }

            if compact:
                from .compaction import (
                    _cached_mvnmf_compacting_runner,
                    mesh_restart_ways,
                )

                c_runner = _cached_mvnmf_compacting_runner(
                    config, float(lam), float(delta), compact_min_bucket,
                    lane_multiple=mesh_restart_ways(mesh),
                )
                c_result, losses = c_runner.run(params0, data)
                params = c_result.params
                n_iterations = c_result.n_iterations
            else:
                params, losses, n_iterations = runner(params0, data)
            # defer the synchronizing fetch (byte-bounded; see
            # rank_scan_klnmf / _drain_scan_fetches)
            in_flight.append((group, losses, n_iterations, params))
            if sum(_pytree_nbytes(e) for e in in_flight) > \
                    memory_budget(_INFLIGHT_BUDGET_BYTES):
                _drain_scan_fetches(in_flight, n_restarts, results)
    _drain_scan_fetches(in_flight, n_restarts, results)
    return results

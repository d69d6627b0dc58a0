"""Device-scheduled lane compaction for convergence-based multi-start fits.

A lockstep multi-start fit runs every restart until the SLOWEST one
converges, and frozen (converged) lanes still burn full FLOPs every block.
On default-config KLNMF multi-starts, per-lane iteration counts spread
several-fold, so most of the batch's block FLOPs advance lanes that have
already converged.

Compaction recovers most of that waste without touching the convergence
semantics: the loop runs as SEGMENTS (engine.fit.run_lockstep_segment)
that exit as soon as at most half the lanes are still unconverged; the
survivors are then gathered into a batch of HALF the size and resumed
there, halving every subsequent block's cost. Dropped lanes are finished,
so their state is simply scattered into the full-size result buffers.
Per-lane trajectories are unchanged - a lane's updates never depend on
its co-tenants (the invariant already pinned by the pack_points tests) -
so results are bit-identical to the uncompacted loop on CPU and match
within f32 batch-size kernel selection on an accelerator
(tests/test_compaction.py).

The halving schedule is STATIC given (n_restarts, min_bucket), so the
whole fit runs as a fixed chain of fused level programs (segment +
scatter + on-device survivor gather via stable argsort of the done mask,
lane ids carried as device state) with ZERO intermediate device->host
fetches.

Cost model: ~log2(n_restarts / min_bucket) extra compiled programs (one
fused level program per occupancy size, cached across calls with the
same config) and one on-device gather per compaction. This pays when
per-block compute dominates dispatch, i.e. when halving the batch halves
the block's wall.
Composes with meshes: when the lane axis is sharded over the mesh's
'restarts' axis, the survivor gather lowers to collectives (tiny next to
the block FLOPs it saves) and compacted lane counts round up to
multiples of the restart-axis device count (lane_multiple) so every
level still divides evenly across devices.

Optional time-capped segments: with a ``program_seconds`` budget, a level
whose worst case could run longer than the budget instead runs as a
host-driven chain of capped segments of the same while_loop. No budget is
set by default.

No reference counterpart: the reference runs restarts one at a time on
the host (models/signature_nmf.py:315-385), so it never has lockstep
waste - and never has batching either.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..engine import FitConfig
from ..engine.fit import (
    LockstepState,
    _effective_tol,
    finish_lockstep,
    init_lockstep_state,
    run_lockstep_segment,
)
from ..engine.transfer import fetch_pytree

# Pessimistic effective memory bandwidth for the pre-measurement block-cost
# model of the time-capped path (bytes touched per MU iteration ~ 3.5x the
# lane data). It only sizes the first capped dispatch; measured per-block
# walls take over from the second dispatch on.
_MODEL_BYTES_PER_SECOND = 25e9


# Test hook: force a program_seconds budget on the paths that take no
# argument for it (model.fit, assign_signatures, streaming fits), so tests
# reach their capped segments on CPU. None (the default) = no cap.
PROGRAM_SECONDS_OVERRIDE: float | None = None


class CappedFitDispatcher:
    """Call-time guard for the monolithic engine paths: when a
    program-seconds budget is set (the PROGRAM_SECONDS_OVERRIDE test hook)
    and the ONE
    device program a `make_fit_function` fit would run could exceed it
    (bytes model over max_iterations), the fit reroutes through a
    never-compacting CompactingRunner (min_bucket = the lane count, so the
    only level is the full batch) whose capped segments pause/resume the
    identical while_loop. Without a budget every fit keeps the zero-fetch
    monolithic program.

    One instance lives inside each make_fit_function result, so repeated
    calls of that fit function reuse the runner's compiled programs exactly
    as they reuse the monolithic jit cache.
    """

    def __init__(self, update_fn, objective_fn, config: FitConfig,
                 batched: bool, batched_data: bool, progress=None):
        self.update_fn = update_fn
        self.objective_fn = objective_fn
        self.config = config
        self.batched = batched
        self.batched_data = batched_data
        # per-segment progress hook threaded to the capped runner
        # (CompactingRunner.progress)
        self.progress = progress
        self._runners: dict[int, CompactingRunner] = {}

    def _make_block_builder(self):
        update_fn = self.update_fn
        data_axis = 0 if self.batched_data else None

        def make_block_update(data, n_lanes: int):
            batched_update = jax.vmap(update_fn, in_axes=(0, data_axis))

            def block(params, steps):
                return jax.lax.fori_loop(
                    0, steps, lambda _, q: batched_update(q, data), params
                )

            return block

        return make_block_update

    def maybe_run(self, params0, data):
        """The capped FitResult, or None when the monolithic program is
        safe (the caller then dispatches it unchanged)."""
        budget = PROGRAM_SECONDS_OVERRIDE
        if budget is None:
            return None
        if self.batched:
            n_lanes = int(jax.tree.leaves(params0)[0].shape[0])
        else:
            n_lanes = 1
        data_bytes = sum(
            leaf.size * jnp.asarray(leaf).dtype.itemsize
            for leaf in jax.tree.leaves(data)
        )
        if not self.batched_data:
            data_bytes *= n_lanes
        est_seconds = (
            3.5 * data_bytes * int(self.config.max_iterations)
            / _MODEL_BYTES_PER_SECOND
        )
        # the bytes model is pessimistic, so up to 2x the budget the
        # monolithic program stays
        if est_seconds <= 2.0 * budget:
            return None

        if n_lanes not in self._runners:
            self._runners[n_lanes] = CompactingRunner(
                self.config, self.objective_fn, self._make_block_builder(),
                min_bucket=n_lanes, batched_data=self.batched_data,
            )
        lane_params = params0
        if not self.batched:
            lane_params = jax.tree.map(
                lambda leaf: jnp.asarray(leaf)[None], params0
            )
        runner = self._runners[n_lanes]
        runner.progress = self.progress
        try:
            result, _ = runner.run(lane_params, data)
        finally:
            runner.progress = None
        if not self.batched:
            result = jax.tree.map(lambda leaf: leaf[0], result)
        return result


def _take_lanes(state: LockstepState, idx) -> LockstepState:
    """Gather a subset of lanes into a smaller valid LockstepState."""
    def take(leaf):
        return jnp.take(leaf, idx, axis=0)

    return LockstepState(
        params=jax.tree.map(take, state.params),
        of_prev=take(state.of_prev),
        history=take(state.history),
        n_evals=take(state.n_evals),
        eval_idx=state.eval_idx,
        iteration=state.iteration,
        n_iterations=take(state.n_iterations),
        done=take(state.done),
    )


def _scatter_lanes(out: LockstepState, ids,
                   state: LockstepState) -> LockstepState:
    """Write a bucket's lanes back into the full-size buffers at rows
    `ids`, carrying the bucket's (more advanced) shared scalars."""
    def put(buf, val):
        return buf.at[ids].set(val)

    return LockstepState(
        params=jax.tree.map(put, out.params, state.params),
        of_prev=put(out.of_prev, state.of_prev),
        history=put(out.history, state.history),
        n_evals=put(out.n_evals, state.n_evals),
        eval_idx=state.eval_idx,
        iteration=state.iteration,
        n_iterations=put(out.n_iterations, state.n_iterations),
        done=put(out.done, state.done),
    )


class CompactingRunner:
    """Compiled-program cache + schedule driver for one compacting fit flavor.

    objective_fn(params, data) -> scalar is the PER-LANE objective;
    make_block_update(data, n_lanes) -> block_update_fn(params, steps)
    builds the batched block advance for a given lane count (called inside
    the segment trace, so `data` leaves are tracers there - builders may
    only read static shape/dtype information from them). One instance
    caches its jitted programs per lane count; reuse it across calls with
    identical shapes (parallel.compaction._cached_compacting_runner).

    With batched_data=True every data leaf carries the leading lane axis
    (each lane fits its OWN data, e.g. extraction's bootstrap resamples);
    the objective/update vmap over it and each compaction gathers the
    surviving lanes' data rows alongside their state.
    """

    def __init__(
        self,
        config: FitConfig,
        objective_fn: Callable[[Any, Any], jnp.ndarray],
        make_block_update: Callable[[Any, int], Callable[[Any, Any], Any]],
        min_bucket: int = 8,
        batched_data: bool = False,
        program_seconds: float | None = None,
        lane_multiple: int = 1,
    ):
        self.config = config
        self.objective_fn = objective_fn
        self.make_block_update = make_block_update
        self.min_bucket = max(1, int(min_bucket))
        self.batched_data = bool(batched_data)
        # compacted bucket sizes stay multiples of this (the restart-axis
        # device count under a mesh, so every level's lane count divides
        # evenly across devices); 1 = plain halving
        self.lane_multiple = max(1, int(lane_multiple))
        # None = the PROGRAM_SECONDS_OVERRIDE test hook (no cap unless a
        # test sets it); a number
        # bounds every dispatched segment to about that many seconds of
        # device execution (tests force a tiny one on CPU).
        self.program_seconds = program_seconds
        self._programs: dict[str, dict] = {
            "init": {}, "level": {}, "loss": {},
            "segment": {}, "compact": {},
        }
        # measured seconds per convergence-test block, keyed by lane count
        # (compile-free dispatches only; refines the pessimistic model)
        self._measured_per_block: dict[int, float] = {}
        # optional mid-fit progress hook, called once per capped segment
        # with a summary dict (iteration, lanes alive, objective range);
        # model.fit wires a printer here when verbose=1. It adds one small
        # objective fetch per segment.
        self.progress: Callable[[dict], None] | None = None

    # -- jitted pieces, cached per lane count ------------------------------

    def _batched_objective(self, data):
        axes = (0, 0) if self.batched_data else (0, None)
        return jax.vmap(self.objective_fn, in_axes=axes)

    def _init_fn(self, n_lanes: int):
        cache = self._programs["init"]
        if n_lanes not in cache:
            def init(params0, data):
                batched = self._batched_objective(data)
                return init_lockstep_state(
                    lambda p: batched(p, data), params0, self.config
                )

            cache[n_lanes] = jax.jit(init)
        return cache[n_lanes]

    def _level_fn(self, n_lanes: int, target: int):
        """One fused device program per occupancy level: advance the
        segment to the compaction point (`target` surviving lanes; 0 =
        the final level, run to completion), scatter the lanes into the
        full-size buffers, and - on non-final levels - gather the
        target-size survivor batch ON DEVICE (stable argsort of the done
        mask keeps alive lanes first in original order, finished
        passengers padding after, exactly the host driver's former
        selection). Lane ids ride as device state, so the whole compacted
        fit is a FIXED chain of device programs with zero intermediate
        device->host fetches."""
        cache = self._programs["level"]
        key = (n_lanes, target)
        if key not in cache:
            is_last = target == 0

            def level(out, state, ids, data):
                batched = self._batched_objective(data)
                block = self.make_block_update(data, n_lanes)
                new_state = run_lockstep_segment(
                    lambda p: batched(p, data), self.config, block,
                    state, target,
                )
                out = _scatter_lanes(out, ids, new_state)
                if is_last:
                    return out
                pos = jnp.argsort(
                    new_state.done.astype(jnp.int32), stable=True
                )[:target]
                carried = (
                    out, _take_lanes(new_state, pos), jnp.take(ids, pos)
                )
                if self.batched_data:
                    return carried + (jax.tree.map(
                        lambda leaf: jnp.take(leaf, pos, axis=0), data
                    ),)
                return carried

            cache[key] = jax.jit(level)
        return cache[key]

    def _segment_fn(self, n_lanes: int):
        """Capped lockstep segment: advance at most `block_cap` convergence
        blocks toward `alive_floor`, returning the state plus an int32[2]
        stats vector [n_alive, iteration]. alive_floor and block_cap are
        traced, so ONE compiled program per lane count serves every level
        and cap."""
        cache = self._programs["segment"]
        if n_lanes not in cache:
            def segment(state, data, alive_floor, block_cap):
                batched = self._batched_objective(data)
                block = self.make_block_update(data, n_lanes)
                new_state = run_lockstep_segment(
                    lambda p: batched(p, data), self.config, block,
                    state, alive_floor, block_cap=block_cap,
                )
                stats = jnp.stack([
                    jnp.sum(~new_state.done).astype(jnp.int32),
                    new_state.iteration.astype(jnp.int32),
                ])
                return new_state, stats

            cache[n_lanes] = jax.jit(segment)
        return cache[n_lanes]

    def _compact_fn(self, n_lanes: int, target: int):
        """The scatter(+gather) tail of a level, split out of the fused
        level program for the time-capped path: scatter the level's lanes
        into the full-size buffers and - on non-final levels - gather the
        target-size survivor batch on device (same stable-argsort
        selection as _level_fn)."""
        cache = self._programs["compact"]
        key = (n_lanes, target)
        if key not in cache:
            is_last = target == 0

            def compact(out, state, ids, data):
                out = _scatter_lanes(out, ids, state)
                if is_last:
                    return out
                pos = jnp.argsort(
                    state.done.astype(jnp.int32), stable=True
                )[:target]
                carried = (
                    out, _take_lanes(state, pos), jnp.take(ids, pos)
                )
                if self.batched_data:
                    return carried + (jax.tree.map(
                        lambda leaf: jnp.take(leaf, pos, axis=0), data
                    ),)
                return carried

            cache[key] = jax.jit(compact)
        return cache[key]

    # -- block-cost model for the time-capped path --------------------------

    def _model_blocks_cap(self, data, n_lanes: int, budget: float) -> int:
        """Pessimistic pre-measurement cap: blocks per dispatch from a
        bytes-touched model (an MU block reads/writes ~3.5x the lane data
        per iteration) at _MODEL_BYTES_PER_SECOND. Heavier per-cycle
        families (CorrNMF's Newton embedding updates) rely on the
        model's pessimism margin."""
        data_bytes = sum(
            leaf.size * jnp.asarray(leaf).dtype.itemsize
            for leaf in jax.tree.leaves(data)
        )
        if not self.batched_data:
            data_bytes *= n_lanes  # every lane streams the shared data
        per_block = max(
            int(self.config.conv_test_freq) * 3.5 * data_bytes
            / _MODEL_BYTES_PER_SECOND,
            1e-9,
        )
        return max(1, int(budget / per_block))

    def _run_level_capped(self, out, state, ids, data, n_lanes: int,
                          target: int, budget: float):
        """Host-driven twin of one fused level program for big-D fits:
        a chain of capped segment dispatches (each bounded to ~`budget`
        seconds of device execution) followed by one scatter/gather
        program. Costs one int32[2] fetch per dispatch. Per-lane
        trajectories are unchanged: a capped segment pauses the SAME
        while_loop the fused level runs (pinned by
        tests/test_compaction.py on CPU, bitwise)."""
        import time

        freq = int(self.config.conv_test_freq)
        full_blocks = int(self.config.max_iterations) // freq
        alive_floor = target
        segment = self._segment_fn(n_lanes)
        cap = self._model_blocks_cap(data, n_lanes, budget)
        measured = self._measured_per_block.get(n_lanes)
        if measured is None and self._measured_per_block:
            # seed from another lane count: block cost scales ~linearly
            # with lanes (memory-bound), stay conservative with a 1.5x margin
            ref_lanes, ref_per_block = min(
                self._measured_per_block.items(),
                key=lambda kv: abs(kv[0] - n_lanes),
            )
            measured = 1.5 * ref_per_block * n_lanes / ref_lanes
        if measured is not None:
            cap = max(1, int(budget / max(measured, 1e-9)))
        import os

        debug = bool(os.environ.get("SALAMANDER_DEBUG_CAPPED"))
        prev_iteration = None  # unknown until the first stats fetch
        while True:
            t0 = time.perf_counter()
            state, stats = segment(
                state, data, jnp.asarray(alive_floor, jnp.int32),
                jnp.asarray(cap, jnp.int32),
            )
            n_alive, iteration = (int(v) for v in np.asarray(stats))
            wall = time.perf_counter() - t0
            if debug:
                print(
                    f"[capped] lanes={n_lanes} cap={cap} wall={wall:.1f}s "
                    f"n_alive={n_alive} iteration={iteration}",
                    flush=True,
                )
            if self.progress is not None:
                of_prev = np.asarray(state.of_prev, dtype=np.float64)
                self.progress({
                    "iteration": iteration,
                    "n_alive": n_alive,
                    "n_lanes": n_lanes,
                    "objective_min": float(np.min(of_prev)),
                    "objective_max": float(np.max(of_prev)),
                    "segment_seconds": wall,
                })
            if prev_iteration is not None:
                blocks_run = (iteration - prev_iteration) // freq
                if blocks_run > 0:
                    per_block = wall / blocks_run
                    self._measured_per_block[n_lanes] = per_block
                    cap = max(1, int(budget / max(per_block, 1e-9)))
            prev_iteration = iteration
            if n_alive <= alive_floor or iteration >= full_blocks * freq:
                break
        return self._compact_fn(n_lanes, target)(out, state, ids, data)

    def _loss_fn(self, n_lanes: int):
        cache = self._programs["loss"]
        if n_lanes not in cache:
            def final_loss(state, data, initial_objective):
                batched = self._batched_objective(data)
                result = finish_lockstep(
                    state, self.config,
                    self.make_block_update(data, n_lanes),
                    initial_objective,
                )
                return result, batched(result.params, data)

            cache[n_lanes] = jax.jit(final_loss)
        return cache[n_lanes]

    # -- schedule driver (fixed chain of device programs) -------------------

    def _use_fused_level(self, n_lanes: int, budget: float | None,
                         data) -> bool:
        """Whether one fused level program fits the program-seconds
        budget. With no budget: always. With a budget: when the per-block
        cost estimate says even the worst-case level (every one of
        max_iterations' convergence blocks) finishes within 1.5x the
        budget. The estimate is a MEASURED per-block wall when one exists
        (direct, or scaled from the nearest measured lane count with a
        1.5x margin); before any measurement, the pessimistic bytes model
        decides, so "model says safe" keeps small fits on the zero-fetch
        fused chain with no extra compiled programs."""
        if budget is None:
            return True
        full_blocks = (
            int(self.config.max_iterations)
            // int(self.config.conv_test_freq)
        )
        measured = self._measured_per_block.get(n_lanes)
        if measured is None and self._measured_per_block:
            ref_lanes, ref_per_block = min(
                self._measured_per_block.items(),
                key=lambda kv: abs(kv[0] - n_lanes),
            )
            measured = 1.5 * ref_per_block * n_lanes / ref_lanes
        if measured is not None:
            return measured * full_blocks <= 1.5 * budget
        model_cap = self._model_blocks_cap(data, n_lanes, budget)
        return model_cap >= full_blocks

    def run(self, params0, data):
        """Fit all lanes to their own convergence, compacting the batch as
        lanes finish. Returns (FitResult, final_loss) with every leaf at
        the full lane count, positionally identical to the uncompacted
        lockstep loop's."""
        n_restarts = int(jax.tree.leaves(params0)[0].shape[0])
        config = self.config
        # the driver owns the once-per-fit tolerance warning (segments
        # never warn); dtype via eval_shape to avoid an eager objective
        of_shape = jax.eval_shape(
            lambda p: self._batched_objective(data)(p, data), params0
        )
        _effective_tol(config, of_shape.dtype, params0)
        budget = self.program_seconds
        if budget is None:
            budget = PROGRAM_SECONDS_OVERRIDE

        state = self._init_fn(n_restarts)(params0, data)
        initial_objective = state.of_prev  # (R,) of0, device-resident
        out = state  # full-size accumulation buffers (device)
        ids = jnp.arange(n_restarts, dtype=jnp.int32)

        # The halving schedule is static given (n_restarts, min_bucket,
        # lane_multiple), so the fit runs as a fixed chain of fused level
        # programs with all gather decisions made on device - no host
        # round-trips. If every lane converges before the schedule
        # bottoms out, the remaining levels' segment while_loops exit on
        # their first condition check (dispatch cost only; frozen lanes
        # never advance, so trajectories and results are unchanged vs
        # the former host loop's early break). Under a program-seconds
        # budget, levels whose worst case could exceed it instead run as
        # host-driven chains of capped
        # segments (_run_level_capped) - same while_loop, paused and
        # resumed. Under a mesh (lane_multiple = restart-axis device
        # count) the targets round up so every level's lane count still
        # divides evenly across devices.
        bucket = n_restarts
        data_bucket = data  # (shrinks with the lanes under batched_data)
        while True:
            target = self._next_bucket(bucket)
            if target is None:
                break
            if self._use_fused_level(bucket, budget, data_bucket):
                level_out = self._level_fn(bucket, target)(
                    out, state, ids, data_bucket
                )
            else:
                level_out = self._run_level_capped(
                    out, state, ids, data_bucket, bucket, target, budget
                )
            if self.batched_data:
                out, state, ids, data_bucket = level_out
            else:
                out, state, ids = level_out
            bucket = target
        if self._use_fused_level(bucket, budget, data_bucket):
            out = self._level_fn(bucket, 0)(out, state, ids, data_bucket)
        else:
            out = self._run_level_capped(
                out, state, ids, data_bucket, bucket, 0, budget
            )

        return self._loss_fn(n_restarts)(out, data, initial_objective)

    def _next_bucket(self, bucket: int) -> int | None:
        """The next (smaller) compacted lane count, or None to stop:
        halve, round UP to a multiple of lane_multiple; stop when the
        result would drop below min_bucket (with lane_multiple=1 this is
        exactly the original halving schedule) or not shrink."""
        multiple = self.lane_multiple
        half = ((bucket // 2 + multiple - 1) // multiple) * multiple
        if half < self.min_bucket or half >= bucket:
            return None
        return half


def _klnmf_block_update_builder(masked: bool):
    """make_block_update factory for the KLNMF flavors (plain multi-start
    params {"W","H"}; rank-masked scans add "mask")."""
    from ..ops import klnmf as ops

    if masked:
        update_fn, _ = ops.make_masked_step_functions()
    else:
        update_fn, _ = ops.make_step_functions()

    def make_block_update(data, n_lanes: int):
        batched_update = jax.vmap(update_fn, in_axes=(0, None))

        def block(params, steps):
            return jax.lax.fori_loop(
                0, steps, lambda _, q: batched_update(q, data), params
            )

        return block

    return make_block_update


@functools.lru_cache(maxsize=16)
def _cached_compacting_runner(config: FitConfig, masked: bool,
                              min_bucket: int,
                              lane_multiple: int = 1) -> CompactingRunner:
    """One runner (= one compiled-program cache) per KLNMF fit flavor."""
    from ..ops import klnmf as ops

    if masked:
        _, objective_fn = ops.make_masked_step_functions()
    else:
        _, objective_fn = ops.make_step_functions()
    return CompactingRunner(
        config,
        objective_fn,
        _klnmf_block_update_builder(masked),
        min_bucket=min_bucket,
        lane_multiple=lane_multiple,
    )


@functools.lru_cache(maxsize=16)
def _cached_extraction_compacting_runner(
    config: FitConfig, promote: bool, min_bucket: int,
    family: str = "klnmf", lam: float = 1.0, delta: float = 1.0,
    n_given: int = 0, lane_multiple: int = 1,
) -> CompactingRunner:
    """Compacting runner for de novo extraction's discovery fit: rank-masked
    KLNMF (or min-vol MvNMF) lanes where every lane fits its OWN bootstrap
    resample (batched_data=True; extraction.extract_signatures). `promote`
    mirrors the monolithic path's models.signature_nmf.promote_objective
    decision (f64 convergence objective when x64 is available and the fit
    dtype isn't already f64), so convergence blocks match the uncompacted
    loop. lam/delta parameterize the MvNMF family only."""
    if family == "mvnmf":
        from ..ops import mvnmf as mv_ops

        update_fn, objective_fn = mv_ops.make_masked_step_functions(
            lam, delta, n_given_signatures=n_given
        )
    else:
        from ..ops import klnmf as ops

        update_fn, objective_fn = ops.make_masked_step_functions(
            n_given_signatures=n_given
        )
    if promote:
        from ..models.signature_nmf import promote_objective

        objective_fn = promote_objective(
            objective_fn, {"probe": jnp.zeros((), jnp.float32)}
        )

    def make_block_update(data, n_lanes: int):
        batched_update = jax.vmap(update_fn, in_axes=(0, 0))

        def block(params, steps):
            return jax.lax.fori_loop(
                0, steps, lambda _, q: batched_update(q, data), params
            )

        return block

    return CompactingRunner(config, objective_fn, make_block_update,
                            min_bucket=min_bucket, batched_data=True,
                            lane_multiple=lane_multiple)


@functools.lru_cache(maxsize=8)
def _cached_corrnmf_compacting_runner(config: FitConfig, x64: bool,
                                      min_bucket: int,
                                      lane_multiple: int = 1,
                                      ) -> CompactingRunner:
    """Compacting runner for (rank- and dim-)masked CorrNMF scan calls.

    The per-lane step is the masked variational-EM cycle
    (ops/corrnmf.py make_masked_corrnmf_step); the objective is promoted
    to float64 under x64 exactly as the monolithic scan program's
    (corrnmf_scan._cached_masked_run), so convergence decisions match.
    CorrNMF restarts disperse hard - the Newton embedding updates make
    every extra lockstep cycle expensive - which is exactly the regime
    compaction targets."""
    from ..models.signature_nmf import promote_objective
    from ..ops import corrnmf as corr_ops

    update_fn, objective_fn = corr_ops.make_masked_corrnmf_step()
    objective = promote_objective(
        objective_fn, {"probe": jnp.zeros((), jnp.float32)}
    )

    def make_block_update(data, n_lanes: int):
        batched_update = jax.vmap(update_fn, in_axes=(0, None))

        def block(params, steps):
            return jax.lax.fori_loop(
                0, steps, lambda _, q: batched_update(q, data), params
            )

        return block

    return CompactingRunner(config, objective, make_block_update,
                            min_bucket=min_bucket,
                            lane_multiple=lane_multiple)


@functools.lru_cache(maxsize=16)
def _cached_mvnmf_compacting_runner(config: FitConfig, lam: float,
                                    delta: float,
                                    min_bucket: int,
                                    lane_multiple: int = 1,
                                    ) -> CompactingRunner:
    """Compacting runner for rank-masked MvNMF scan calls (params carry
    the per-lane line-search gamma and the rank mask)."""
    from ..ops import mvnmf as mv_ops

    update_fn, objective_fn = mv_ops.make_masked_step_functions(lam, delta)

    def make_block_update(data, n_lanes: int):
        batched_update = jax.vmap(update_fn, in_axes=(0, None))

        def block(params, steps):
            return jax.lax.fori_loop(
                0, steps, lambda _, q: batched_update(q, data), params
            )

        return block

    return CompactingRunner(config, objective_fn, make_block_update,
                            min_bucket=min_bucket,
                            lane_multiple=lane_multiple)


def mesh_restart_ways(mesh) -> int:
    """Device count along the mesh's restart axis (1 without a mesh or
    when the mesh has no 'restarts' axis). This is the compacting
    driver's lane_multiple under a mesh: compacted lane counts stay
    multiples of it so every level divides evenly across devices."""
    if mesh is None:
        return 1
    from .mesh import RESTART_AXIS

    try:
        return int(dict(zip(mesh.axis_names, mesh.devices.shape)).get(
            RESTART_AXIS, 1
        ))
    except Exception:
        return 1


def resolve_compact(compact, config: FitConfig, mesh,
                    n_restarts: int, min_bucket: int) -> bool:
    """Auto policy for lane compaction (compact=None).

    Auto enables compaction on any accelerator exactly where it is legal
    and at least one halving exists: a convergence rule (fixed-length runs
    never free a lane) and n_restarts >= 2 * the effective floor. Under a
    mesh the restart axis is sharded and compaction composes with it
    (lane_multiple = mesh_restart_ways keeps every level's lane count
    evenly divisible; the cross-device survivor gather is collective but
    tiny next to the block FLOPs it saves), so the floor also rounds up to
    the device count. CPU stays opt-in: the split-program driver differs
    from the monolithic runner by f32 fusion ulps (see CLAUDE.md), and CPU
    is the bit-exactness reference.
    """
    if compact is not None:
        return bool(compact)
    floor = max(min_bucket, mesh_restart_ways(mesh))
    return (
        config.min_iterations < config.max_iterations
        and n_restarts >= 2 * floor
        and jax.default_backend() != "cpu"
    )


def fit_klnmf_restarts_compacting(
    X,
    n_signatures: int,
    n_restarts: int,
    seed: int = 0,
    config: FitConfig | None = None,
    weights_kl=None,
    weights_lhalf=None,
    dtype=jnp.float32,
    min_bucket: int = 8,
    mesh=None,
):
    """Compacting twin of parallel.restarts.fit_klnmf_restarts (same seeds,
    same per-lane results). Under a `mesh` the lane axis shards over
    'restarts' and compacted lane counts stay multiples of the device
    count. Returns a RestartResult."""
    result, losses = klnmf_restarts_compacting_device(
        X, n_signatures, n_restarts, seed=seed, config=config,
        weights_kl=weights_kl, weights_lhalf=weights_lhalf, dtype=dtype,
        min_bucket=min_bucket, mesh=mesh,
    )
    return finalize_compacting_restarts(result, losses)


def klnmf_restarts_compacting_device(
    X,
    n_signatures: int,
    n_restarts: int,
    seed: int = 0,
    config: FitConfig | None = None,
    weights_kl=None,
    weights_lhalf=None,
    dtype=jnp.float32,
    min_bucket: int = 8,
    mesh=None,
):
    """Dispatch-only body of fit_klnmf_restarts_compacting: returns the
    DEVICE (FitResult, losses) without any device->host fetch. The
    compacting schedule itself is fetch-free, so callers fitting many
    points (rank scans) can dispatch every point's whole fit before the
    first synchronizing fetch - consecutive points' programs pipeline on
    the device instead of the host stalling on each point's result."""
    from ..initialization.methods import random_init_batch

    config = config or FitConfig()
    X = jnp.asarray(X, dtype)
    key = jax.random.PRNGKey(seed)
    W0, H0 = random_init_batch(key, X, n_signatures, n_restarts, dtype)
    data = {"X": X}
    if weights_kl is not None:
        data["weights_kl"] = jnp.asarray(weights_kl, dtype)
    if weights_lhalf is not None:
        data["weights_lhalf"] = jnp.asarray(weights_lhalf, dtype)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from .mesh import SAMPLE_AXIS, restart_sharding

        shardings = restart_sharding(mesh)
        W0 = jax.device_put(W0, shardings["W"])
        H0 = jax.device_put(H0, shardings["H"])
        data["X"] = jax.device_put(data["X"], shardings["X"])
        per_sample = NamedSharding(mesh, PartitionSpec(SAMPLE_AXIS))
        for key_name in ("weights_kl", "weights_lhalf"):
            if key_name in data:
                data[key_name] = jax.device_put(data[key_name], per_sample)
    runner = _cached_compacting_runner(
        config, False, min_bucket,
        lane_multiple=mesh_restart_ways(mesh),
    )
    return runner.run({"W": W0, "H": H0}, data)


def finalize_compacting_restarts(result, losses):
    """Fetch a device (FitResult, losses) pair and build a RestartResult
    (small fetch: per-lane losses + iteration counts; W/H stay device)."""
    from .restarts import RestartResult

    losses_host, n_iterations = fetch_pytree((losses, result.n_iterations))
    losses_host = np.asarray(losses_host)
    return RestartResult(
        W=result.params["W"],
        H=result.params["H"],
        losses=losses_host,
        n_iterations=np.asarray(n_iterations),
        best_index=int(np.argmin(losses_host)),
    )

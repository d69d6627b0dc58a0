"""Generic on-device NMF fit loop.

The reference drives every model with the same host-side Python while loop
(models/signature_nmf.py:315-385): update parameters each iteration, evaluate
the objective every `conv_test_freq` iterations, declare convergence when the
relative objective change drops below `tol` after at least `min_iterations`,
hard-stop at `max_iterations`, and record the objective trace.

Here that whole loop lives on device as a `lax.while_loop` over BLOCKS of
`conv_test_freq` updates (a `fori_loop` inside), so one objective evaluation
amortizes over a block and there is no host round-trip until the fit is done.
The loop state carries a per-problem `done` flag and freezes finished lanes
with `where`-selects, which makes the same engine correct under `vmap`: a
batched fit runs until every restart has converged, and already-converged
restarts stop changing (matching what sequential fits would produce).

History is a fixed-size NaN-padded buffer (max_iterations // conv_test_freq
entries - exactly the reference's `of_values[1:]`), sliced host-side.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp


class FitConfig(NamedTuple):
    """Convergence-rule hyperparameters shared by every model family.

    stop_on_nonfinite: fail fast when an evaluated objective is NaN/Inf
    (the reference would silently iterate to max_iterations with NaN state;
    off by default for trace parity).
    """

    min_iterations: int = 500
    max_iterations: int = 10000
    conv_test_freq: int = 10
    tol: float = 1e-7
    stop_on_nonfinite: bool = False


def tolerance_floor(dtype) -> float:
    """Smallest meaningful relative-change tolerance for an objective dtype.

    A convergence test comparing |of_prev - of| / |of_prev| against a
    tolerance below the dtype's own relative resolution never measures
    convergence - successive objective values jitter by a few ulps forever
    and the fit silently runs to max_iterations (the reference never hits
    this because it is float64 numpy throughout). Sub-64-bit objectives get
    a floor of 10 machine epsilons; float64 keeps the user's tolerance.
    """
    if jnp.issubdtype(dtype, jnp.floating) and jnp.finfo(dtype).bits < 64:
        return 10.0 * float(jnp.finfo(dtype).eps)
    return 0.0


def _effective_tol(config: "FitConfig", objective_dtype, params0,
                   warn: bool = True) -> float:
    """The enforceable tolerance: the user's tol floored at the resolution
    of BOTH the objective dtype and the parameter dtypes.

    Even with a float64 objective, float32 parameters keep injecting
    ~eps(float32) relative jitter into the objective near the optimum
    (measured: float32 KLNMF never satisfies 1e-7 under a float64
    objective), so the state dtype bounds what a relative-change test can
    resolve.
    """
    tol = float(config.tol)
    floor = tolerance_floor(objective_dtype)
    for leaf in jax.tree.leaves(params0):
        dtype = jnp.asarray(leaf).dtype
        if jnp.issubdtype(dtype, jnp.floating):
            floor = max(floor, tolerance_floor(dtype))
    if tol < floor:
        if warn:
            warnings.warn(
                f"tol={tol:g} is below the convergence resolution of this "
                f"fit's dtype; using {floor:g} instead. Fit with "
                "dtype='float64' (requires jax x64) for tighter tolerances.",
                UserWarning,
            )
        return floor
    return tol


def effective_tolerance(config: "FitConfig", objective_dtype, params0) -> float:
    """Public twin of the engine's internal tolerance flooring, for callers
    that record the enforced tolerance (model.history['tol_effective'])
    without re-triggering the engine's warning."""
    return _effective_tol(config, objective_dtype, params0, warn=False)


class FitResult(NamedTuple):
    params: Any
    initial_objective: jnp.ndarray
    history: jnp.ndarray      # (max_evals,) objective trace, NaN-padded
    n_evals: jnp.ndarray      # number of valid history entries
    n_iterations: jnp.ndarray # total update iterations performed


class _LoopState(NamedTuple):
    params: Any
    of_prev: jnp.ndarray
    history: jnp.ndarray
    n_evals: jnp.ndarray
    iteration: jnp.ndarray
    done: jnp.ndarray


def _select(done, old, new):
    """Per-leaf where keeping finished lanes frozen (done broadcasts)."""
    return jax.tree.map(lambda a, b: jnp.where(done, a, b), old, new)


# Blocks of at most this many updates unroll into straight-line HLO instead
# of a fori_loop (same steady-state throughput, far cheaper compilation).
_UNROLL_LIMIT = 16


_CALLBACKS_SUPPORTED: bool | None = None


def backend_supports_callbacks() -> bool:
    """Whether the default backend can run jax.debug.print (host callbacks).

    A PJRT backend may reject host send/recv callbacks at run time;
    verbose fitting then falls back to printing the objective trace after
    the fit.
    """
    global _CALLBACKS_SUPPORTED
    if _CALLBACKS_SUPPORTED is None:
        def probe(x):
            jax.debug.print("", ordered=False)
            return x + 1

        try:
            jax.jit(probe)(jnp.zeros(())).block_until_ready()
            _CALLBACKS_SUPPORTED = True
        except Exception:
            _CALLBACKS_SUPPORTED = False
    return _CALLBACKS_SUPPORTED


def print_history_trace(history, n_evals: int, conv_test_freq: int,
                        verbosity_freq: int) -> None:
    """Post-fit stand-in for on-device verbosity: print the recorded
    objective at each verbosity_freq boundary crossing."""
    import numpy as np

    values = np.asarray(history)[:n_evals]
    previous_bucket = 0
    for index, value in enumerate(values):
        iteration = (index + 1) * conv_test_freq
        bucket = iteration // verbosity_freq
        if bucket > previous_bucket:
            print(f"iteration: {iteration}; objective: {value:.2f}")
            previous_bucket = bucket


def fit_loop(
    update_fn: Callable[[Any], Any],
    objective_fn: Callable[[Any], jnp.ndarray],
    params0: Any,
    config: FitConfig,
    verbose: bool = False,
    verbosity_freq: int = 1000,
    block_update_fn: Callable[[Any, jnp.ndarray], Any] | None = None,
    unroll: bool = True,
) -> FitResult:
    """Run the shared convergence loop. Pure and jittable; vmap over params0
    for batched restarts (the data lives inside the closures).

    block_update_fn(params, n_steps), when given, replaces the inner
    fori_loop of single updates with one call advancing n_steps
    iterations - the hook for a fused kernel that runs a whole block."""
    freq = int(config.conv_test_freq)
    max_iterations = int(config.max_iterations)
    min_iterations = int(config.min_iterations)
    max_evals = max(1, max_iterations // freq)
    # Full convergence-test blocks are statically sized; a non-divisible
    # max_iterations leaves a statically-sized remainder run once after the
    # loop (never evaluated - reference semantics). Small blocks unroll to
    # straight-line HLO: same steady-state speed as fori_loop, but compile
    # times drop from minutes to seconds on slow-compile backends.
    full_block_iterations = (max_iterations // freq) * freq
    remainder = max_iterations - full_block_iterations

    def advance(params, n_steps: int):
        if block_update_fn is not None:
            return block_update_fn(params, jnp.asarray(n_steps, jnp.int32))
        if unroll and n_steps <= _UNROLL_LIMIT:
            for _ in range(n_steps):
                params = update_fn(params)
            return params
        return jax.lax.fori_loop(
            0, n_steps, lambda _, p: update_fn(p), params
        )

    of0 = objective_fn(params0)
    dtype = of0.dtype
    tol = _effective_tol(config, dtype, params0)
    init = _LoopState(
        params=params0,
        of_prev=of0,
        history=jnp.full((max_evals,), jnp.nan, dtype=dtype),
        n_evals=jnp.zeros((), jnp.int32),
        iteration=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
    )

    def cond(state: _LoopState):
        return ~state.done & (state.iteration < full_block_iterations)

    def body(state: _LoopState) -> _LoopState:
        params = advance(state.params, freq)
        iteration = state.iteration + freq

        of_value = objective_fn(params)
        rel_change = jnp.abs(state.of_prev - of_value) / jnp.abs(state.of_prev)
        converged = (rel_change < tol) & (iteration >= min_iterations)
        done = converged | (iteration >= max_iterations)
        if config.stop_on_nonfinite:
            done = done | ~jnp.isfinite(of_value)

        if verbose:
            # print when this block crossed a verbosity_freq boundary
            # (iteration only visits multiples of conv_test_freq, so exact
            # divisibility would silently skip most configurations)
            crossed = (iteration // verbosity_freq) > (
                state.iteration // verbosity_freq
            )
            jax.lax.cond(
                crossed & ~state.done,
                lambda: jax.debug.print(
                    "iteration: {i}; objective: {of:.2f}",
                    i=iteration, of=of_value,
                ),
                lambda: None,
            )

        new = _LoopState(
            params=params,
            of_prev=of_value,
            history=state.history.at[state.n_evals].set(of_value.astype(dtype)),
            n_evals=state.n_evals + 1,
            iteration=iteration,
            done=done,
        )
        # under vmap, freeze lanes that are done or waiting for the remainder
        frozen = state.done | (state.iteration >= full_block_iterations)
        return _select(frozen, state, new)

    final = jax.lax.while_loop(cond, body, init)

    params, iteration = final.params, final.iteration
    if remainder > 0:
        params = _select(final.done, params, advance(params, remainder))
        iteration = jnp.where(final.done, iteration, iteration + remainder)

    return FitResult(
        params=params,
        initial_objective=of0,
        history=final.history,
        n_evals=final.n_evals,
        n_iterations=iteration,
    )


class LockstepState(NamedTuple):
    """Resumable state of the natively-batched convergence loop.

    Every leaf except `eval_idx`/`iteration` carries the leading restart
    (lane) axis, which is what makes device-scheduled lane compaction possible:
    gathering a subset of lanes out of a LockstepState yields a valid
    smaller-batch LockstepState mid-fit (parallel/compaction.py). The two
    scalars are shared because every lane advances in lockstep blocks -
    they stay correct across a compaction (the carried lanes have all seen
    exactly `iteration` iterations and `eval_idx` objective evaluations).
    """

    params: Any
    of_prev: jnp.ndarray       # (R,) objective at each lane's last eval
    history: jnp.ndarray       # (R, max_evals) NaN-padded traces
    n_evals: jnp.ndarray       # (R,)
    eval_idx: jnp.ndarray      # scalar: block evals performed so far
    iteration: jnp.ndarray     # scalar: iterations performed so far
    n_iterations: jnp.ndarray  # (R,) per-lane count, frozen when done
    done: jnp.ndarray          # (R,) bool


def _masked_advance(block_update_fn, params, frozen, n_steps):
    n_restarts = frozen.shape[0]
    params_new = block_update_fn(params, jnp.asarray(n_steps, jnp.int32))
    return jax.tree.map(
        lambda old, new: jnp.where(
            frozen.reshape((n_restarts,) + (1,) * (old.ndim - 1)), old, new
        ),
        params,
        params_new,
    )


def init_lockstep_state(
    objective_fn: Callable[[Any], jnp.ndarray],
    params0: Any,
    config: FitConfig,
) -> LockstepState:
    """Evaluate the initial objective and build the loop state (jittable)."""
    freq = int(config.conv_test_freq)
    max_evals = max(1, int(config.max_iterations) // freq)
    of0 = objective_fn(params0)  # (R,)
    n_restarts = of0.shape[0]
    return LockstepState(
        params=params0,
        of_prev=of0,
        history=jnp.full((n_restarts, max_evals), jnp.nan, dtype=of0.dtype),
        n_evals=jnp.zeros((n_restarts,), jnp.int32),
        eval_idx=jnp.zeros((), jnp.int32),
        iteration=jnp.zeros((), jnp.int32),
        n_iterations=jnp.zeros((n_restarts,), jnp.int32),
        done=jnp.zeros((n_restarts,), bool),
    )


def run_lockstep_segment(
    objective_fn: Callable[[Any], jnp.ndarray],
    config: FitConfig,
    block_update_fn: Callable[[Any, jnp.ndarray], Any],
    state: LockstepState,
    alive_floor=0,
    block_cap=None,
) -> LockstepState:
    """Advance the lockstep loop until every lane is done, max_iterations'
    full blocks are exhausted, or at most `alive_floor` lanes remain
    unconverged (jittable; alive_floor may be a traced scalar, so one
    compiled program serves every floor at a given lane count).

    With alive_floor=0 this runs the loop to the exact same exit as
    fit_loop_lockstep. A positive floor is the compaction hook: the caller
    gathers the surviving lanes into a smaller batch and resumes there,
    so converged lanes stop burning block FLOPs (frozen lanes cost full
    compute).

    `block_cap` (optional, may be traced) additionally bounds THIS CALL to
    at most that many convergence-test blocks, so a big-D convergence loop
    can run as a host-driven chain of capped segments when a caller bounds
    each device program's duration (parallel.compaction.CompactingRunner,
    program_seconds). The cap changes WHERE the loop pauses, never the
    per-lane trajectories - resuming a capped state is exactly continuing
    the same while_loop.
    """
    freq = int(config.conv_test_freq)
    max_iterations = int(config.max_iterations)
    min_iterations = int(config.min_iterations)
    full_block_iterations = (max_iterations // freq) * freq
    tol = _effective_tol(config, state.of_prev.dtype, state.params,
                         warn=False)
    alive_floor = jnp.asarray(alive_floor, jnp.int32)
    eval_end = None
    if block_cap is not None:
        eval_end = state.eval_idx + jnp.asarray(block_cap, jnp.int32)

    def cond(state: LockstepState):
        n_alive = jnp.sum(~state.done)
        keep_going = (n_alive > alive_floor) & (
            state.iteration < full_block_iterations
        )
        if eval_end is not None:
            keep_going = keep_going & (state.eval_idx < eval_end)
        return keep_going

    def body(state: LockstepState) -> LockstepState:
        done_prev = state.done
        params = _masked_advance(block_update_fn, state.params, done_prev,
                                 freq)
        iteration = state.iteration + freq

        of_value = objective_fn(params)  # (R,)
        rel_change = jnp.abs(state.of_prev - of_value) / jnp.abs(
            state.of_prev
        )
        converged = (rel_change < tol) & (iteration >= min_iterations)
        done = done_prev | converged | (iteration >= max_iterations)
        if config.stop_on_nonfinite:
            done = done | ~jnp.isfinite(of_value)

        record = ~done_prev  # (R,) lanes recording this eval
        dtype = state.history.dtype
        history = state.history.at[:, state.eval_idx].set(
            jnp.where(record, of_value.astype(dtype),
                      state.history[:, state.eval_idx])
        )
        return LockstepState(
            params=params,
            of_prev=jnp.where(record, of_value, state.of_prev),
            history=history,
            n_evals=state.n_evals + record.astype(jnp.int32),
            eval_idx=state.eval_idx + 1,
            iteration=iteration,
            n_iterations=jnp.where(done_prev, state.n_iterations,
                                   iteration),
            done=done,
        )

    return jax.lax.while_loop(cond, body, state)


def finish_lockstep(
    state: LockstepState,
    config: FitConfig,
    block_update_fn: Callable[[Any, jnp.ndarray], Any],
    initial_objective,
) -> FitResult:
    """Apply the never-evaluated remainder tail (max_iterations not
    divisible by conv_test_freq - reference semantics) and assemble the
    FitResult (jittable)."""
    remainder = int(config.max_iterations) - (
        int(config.max_iterations) // int(config.conv_test_freq)
    ) * int(config.conv_test_freq)
    params = state.params
    n_iterations = state.n_iterations
    if remainder > 0:
        params = _masked_advance(block_update_fn, params, state.done,
                                 remainder)
        n_iterations = jnp.where(state.done, n_iterations,
                                 int(config.max_iterations))
    return FitResult(
        params=params,
        initial_objective=initial_objective,
        history=state.history,
        n_evals=state.n_evals,
        n_iterations=n_iterations,
    )


def fit_loop_lockstep(
    objective_fn: Callable[[Any], jnp.ndarray],
    params0: Any,
    config: FitConfig,
    block_update_fn: Callable[[Any, jnp.ndarray], Any],
) -> FitResult:
    """Natively-batched twin of fit_loop for restart-blocked kernels.

    params0 carries a leading restart axis R; objective_fn maps batched
    params -> (R,) objectives; block_update_fn advances ALL restarts by a
    scalar step count (e.g. a fused batched kernel, which cannot live
    under vmap without serializing the batch). All lanes advance in lockstep
    blocks; finished lanes are frozen with where-selects, exactly matching
    vmap(fit_loop) semantics (same eval points, per-lane histories and
    iteration counts).

    Composed from init_lockstep_state / run_lockstep_segment /
    finish_lockstep so device-scheduled lane compaction (parallel/compaction.py)
    reuses the exact same loop semantics segment by segment.
    """
    # trigger the tolerance warning once, exactly as before the refactor
    # (eval_shape: no actual objective evaluation, just its dtype)
    of_shape = jax.eval_shape(objective_fn, params0)
    _effective_tol(config, of_shape.dtype, params0)
    state = init_lockstep_state(objective_fn, params0, config)
    final = run_lockstep_segment(objective_fn, config, block_update_fn,
                                 state, alive_floor=0)
    return finish_lockstep(final, config, block_update_fn, state.of_prev)


def make_fit_function(
    update_fn: Callable[[Any, Any], Any],
    objective_fn: Callable[[Any, Any], jnp.ndarray],
    config: FitConfig,
    verbose: bool = False,
    verbosity_freq: int = 1000,
    batched: bool = False,
    unroll: bool = True,
    batched_data: bool = False,
    progress_cb: Callable[[dict], None] | None = None,
):
    """Build a jitted fit function `(params0, data) -> FitResult`.

    update_fn/objective_fn take (params, data); `data` is a pytree of arrays
    (count matrix, weights, ...) passed as a jit argument rather than baked
    into the program. With batched=True, params0 gains a leading restart axis
    and the loop runs all restarts to their own convergence; batched_data
    additionally gives every data leaf a leading restart axis (bootstrap
    resampling - each lane fits its own counts). `unroll` controls block
    unrolling: keep it True for cheap per-iteration updates (multiplicative
    rules); set False for heavy updates with inner loops (CorrNMF's Newton
    solves), whose unrolled graphs compile slowly.

    progress_cb: called once per capped segment with a summary dict
    (iteration, lanes alive, objective range) when a program-seconds
    budget (the parallel.compaction.PROGRAM_SECONDS_OVERRIDE test hook)
    reroutes a long fit through capped segments. Without a budget every fit is one
    monolithic program and never calls it.
    """

    def run(params0, data):
        return fit_loop(
            lambda p: update_fn(p, data),
            lambda p: objective_fn(p, data),
            params0,
            config,
            verbose=verbose,
            verbosity_freq=verbosity_freq,
            unroll=unroll,
        )

    def _with_program_kill_guard(monolithic):
        # Under a program-seconds budget (parallel/compaction.py), dispatch
        # checks a call-time duration model and reroutes fits whose one
        # program could run past it through capped segments of the
        # identical loop. Import is lazy (engine <- parallel would
        # otherwise be circular).
        from ..parallel.compaction import CappedFitDispatcher

        dispatcher = CappedFitDispatcher(
            update_fn, objective_fn, config,
            batched=batched, batched_data=batched_data,
            progress=progress_cb,
        )

        def dispatch(params0, data):
            capped = dispatcher.maybe_run(params0, data)
            if capped is not None:
                return capped
            return monolithic(params0, data)

        return dispatch

    if batched:
        data_axis = 0 if batched_data else None
        if verbose:
            # the lockstep loop has no live printing; fall back to the
            # vmapped per-lane loop when verbosity is requested
            return jax.jit(jax.vmap(run, in_axes=(0, data_axis)))

        # Natively-batched lockstep loop: one while loop over the whole
        # batch instead of a batching-transformed one (vmap(fit_loop)).
        def run_lockstep(params0, data):
            batched_update = jax.vmap(update_fn, in_axes=(0, data_axis))
            batched_objective = jax.vmap(objective_fn, in_axes=(0, data_axis))

            def block(params, steps):
                return jax.lax.fori_loop(
                    0, steps, lambda _, q: batched_update(q, data), params
                )

            return fit_loop_lockstep(
                lambda p: batched_objective(p, data),
                params0,
                config,
                block,
            )

        return _with_program_kill_guard(jax.jit(run_lockstep))
    if verbose:
        return jax.jit(run)
    return _with_program_kill_guard(jax.jit(run))

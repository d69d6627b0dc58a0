"""Stochastic (minibatch) variational EM for correlated NMF.

The reference's CorrNMFDet (models/corrnmf_det.py:157-169) is strictly
full-batch: every EM cycle touches all D samples. For cohorts where D is far
beyond the reference's scale, this module provides the online-EM variant
(Cappe & Moulines 2009; Hoffman et al. 2013 for the step-size schedule):
each step draws a minibatch of samples, refreshes that minibatch's LOCAL
parameters (sample scalings + embeddings) with the exact batch M-steps, and
updates the GLOBAL parameters from Robbins-Monro running averages of the
minibatch-scaled sufficient statistics:

  s1[k] = sum_d aux[k, d]                   (signature-scaling numerator)
  s2[k] = sum_d exp(tau_d + <l_k, u_d>)     (signature-scaling denominator)
  C[v,k] = W_vk * sum_d ratio_vd h_dk       (expected signature counts;
                                             column-normalizing C IS the
                                             KL multiplicative W update)

with rho_t = (t + delay)^(-forgetting) and t = 0, 1, ... The signature
embeddings have no fixed-dimensional sufficient statistic (their M-step is a
Newton solve whose rate term depends on the variable), so they take the
standard non-conjugate SVI route: a Newton solve on the minibatch-rescaled
surrogate, blended into the running iterate with the same rho_t.

Exactness anchor (pinned by tests/test_svi.py): with batch_size = n_samples,
rho = 1 (delay=1, t=0) and signature_newton_iters raised to the full-batch
cap, one SVI step IS one deterministic EM cycle - the statistics equal their
full-batch values and the blending is the identity - so the whole scheme is
a strict generalization of CorrNMFDet's update.

Cost model (everything jittable with static batch size): per-step compute is
amortized O(batch_size) - minibatches are cut from a per-epoch shuffled
permutation (reshuffled once per epoch, O(D log D) amortized over D/B
steps; when B does not divide D the epoch's tail partial batch is dropped -
see _draw_epoch_batch), the sample-embedding sum-of-squares behind the
variance M-step is
carried as a running statistic (refreshed exactly at each epoch boundary),
and gather/scatter touch only the batch rows. The full (D, V) count matrix
does stay resident on device, and the optional full-data ELBO evaluation
every eval_freq steps is an O(D V) pass (set eval_freq=0 to disable it);
for cohorts beyond one device's memory, shard the sample axis across a mesh
(parallel/mesh.py) - the minibatch gather/scatter pattern is compatible
with that layout.

The same scheme powers online NMF for the KLNMF family (make_klnmf_svi_step:
sample-local multiplicative H updates + a running expected-signature-counts
statistic whose column normalization IS the KL W update).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from . import corrnmf as ops
from . import klnmf as klops
from .klnmf import EPSILON
from .precision import mm


class SVIConfig(NamedTuple):
    """Step-size schedule and solver knobs for the stochastic EM fit.

    rho_t = (t + delay)^(-forgetting): forgetting in (0.5, 1] guarantees
    Robbins-Monro convergence; delay >= 1 tempers early steps. delay=1 makes
    the first step's rho exactly 1, which initializes the running statistics
    to the first minibatch estimate.
    """

    batch_size: int = 128
    forgetting: float = 0.7
    delay: float = 1.0
    signature_newton_iters: int = 4
    sample_newton_iters: int = 3  # the reference's sample-side maxiter=3


def _validate_config(config: SVIConfig, n_samples: int) -> int:
    """Reject schedules that silently corrupt the fit. Returns batch_size.

    delay < 1 makes rho_0 = delay**(-forgetting) exceed 1 (delay=0 makes it
    inf), so the (1-rho)/rho blend leaves the convex hull and the running
    statistics go negative/NaN; forgetting outside (0.5, 1] breaks the
    Robbins-Monro conditions (sum rho = inf, sum rho^2 < inf)."""
    batch_size = int(config.batch_size)
    if not 1 <= batch_size <= n_samples:
        raise ValueError(
            f"batch_size={batch_size} must be in [1, n_samples={n_samples}]"
        )
    if not config.delay >= 1.0:
        raise ValueError(
            f"delay={config.delay} must be >= 1 (rho_0 = delay**-forgetting "
            "must not exceed 1)"
        )
    if not 0.5 < config.forgetting <= 1.0:
        raise ValueError(
            f"forgetting={config.forgetting} must be in (0.5, 1] for "
            "Robbins-Monro convergence"
        )
    if config.signature_newton_iters < 1 or config.sample_newton_iters < 1:
        raise ValueError("Newton iteration counts must be >= 1")
    return batch_size


class SVIState(NamedTuple):
    params: Any          # the CorrNMFDet parameter pytree (minus exposures)
    stat_observed: Any   # (K,) running average of D-scaled sum_d aux[k,d]
    stat_predicted: Any  # (K,) running average of D-scaled sum_d exp(...)
    stat_counts: Any     # (V,K) running average of expected signature counts
    step: Any            # scalar int32 step counter t
    perm: Any            # (D,) epoch sample order; reshuffled once per epoch
    cursor: Any          # scalar int32 position in perm
    stat_usq: Any        # scalar running sum(sample_embeddings**2)


def svi_init(params, streaming: bool = False) -> SVIState:
    """Fresh SVI state around a CorrNMFDet parameter pytree (the running
    statistics start at zero; rho_0 = 1 with the default delay overwrites
    them with the first minibatch estimate). cursor starts past the end of
    perm so the first step reshuffles with its own PRNG key.

    streaming=True builds the state for the host-resident-X driver
    (run_svi_streaming), whose epoch permutation lives on the HOST: the
    device-side perm collapses to shape (0,) so huge cohorts don't carry a
    dead (D,) index array in HBM."""
    signatures = params["signatures"]
    n_signatures, n_features = signatures.shape
    dtype = signatures.dtype
    sample_embeddings = params["sample_embeddings"]
    n_samples = sample_embeddings.shape[0]
    perm = (
        jnp.zeros((0,), jnp.int32) if streaming
        else jnp.arange(n_samples, dtype=jnp.int32)
    )
    return SVIState(
        params={key: value for key, value in params.items()
                if key != "exposures"},
        stat_observed=jnp.zeros((n_signatures,), dtype),
        stat_predicted=jnp.zeros((n_signatures,), dtype),
        stat_counts=jnp.zeros((n_features, n_signatures), dtype),
        step=jnp.zeros((), jnp.int32),
        perm=perm,
        cursor=jnp.asarray(n_samples, jnp.int32),
        stat_usq=jnp.sum(sample_embeddings**2),
    )


def refresh_sample_usq(state):
    """Exact-refresh the running sum(sample_embeddings**2) statistic (the
    epoch-boundary drift guard). Works for SVIState and MMSVIState - both
    carry params['sample_embeddings'] and a stat_usq field. The streaming
    driver calls this at exactly the step positions where the resident
    step's on-device _draw_epoch_batch would refresh, preserving bitwise
    equality between the two paths."""
    return state._replace(
        stat_usq=jnp.sum(state.params["sample_embeddings"] ** 2)
    )


def _draw_epoch_batch(key, perm, cursor, usq_exact_fn, stat_usq, batch_size):
    """Cut the next minibatch from the epoch permutation, reshuffling (and
    exactly refreshing the running sum-of-squares statistic, so its O(B)
    incremental updates can't drift) when the epoch is exhausted. Amortized
    O(batch_size) per step.

    Drop-last semantics: reshuffling triggers whenever fewer than batch_size
    samples remain, so when batch_size does not divide n_samples the tail
    partial batch of each epoch is NOT visited that epoch (it lands in the
    next epoch's fresh permutation with uniform probability). 'One epoch
    refreshes every sample exactly once' therefore holds only for divisible
    batch sizes; otherwise each "epoch" covers floor(D/B)*B uniformly-drawn
    samples."""
    n_samples = perm.shape[0]

    def reshuffle(args):
        old_perm, _, _ = args
        new_perm = jax.random.permutation(key, n_samples).astype(
            old_perm.dtype
        )
        return new_perm, jnp.zeros((), jnp.int32), usq_exact_fn()

    perm, start, stat_usq = jax.lax.cond(
        cursor + batch_size > n_samples,
        reshuffle,
        lambda args: args,
        (perm, cursor, stat_usq),
    )
    indices = jax.lax.dynamic_slice_in_dim(perm, start, batch_size)
    return indices, perm, start + batch_size, stat_usq


@functools.lru_cache(maxsize=64)
def make_svi_batch_step(
    n_samples: int,
    config: SVIConfig,
    n_given_signatures: int = 0,
    fix_signature_scalings: bool = False,
    fix_sample_scalings: bool = False,
    fix_signature_embeddings: bool = False,
    fix_sample_embeddings: bool = False,
    fix_variance: bool = False,
):
    """Build the jittable minibatch CORE (state, X_batch, indices) -> state.

    The caller supplies the minibatch: X_batch is the (B, V) count rows and
    indices the (B,) sample positions they came from. This is the shared
    engine of both data placements:
      - make_svi_step wraps it with the on-device epoch sampler and a
        jnp.take gather from the device-resident full X;
      - run_svi_streaming drives it directly with host-sliced, device_put
        batches (X host-resident - the beyond-HBM path), feeding the SAME
        index sequence, so the two paths produce bitwise-identical params.

    state.perm/state.cursor pass through untouched (the wrapper or host
    driver owns them); state.stat_usq must already be epoch-refreshed when
    needed (refresh_sample_usq) - the core only applies the incremental
    update.
    """
    batch_size = _validate_config(config, n_samples)
    scale = n_samples / batch_size
    fix_signatures = False
    K_given = int(n_given_signatures)

    def batch_step(state: SVIState, X_batch, indices) -> SVIState:
        params = dict(state.params)
        signatures = params["signatures"]          # (K, V)
        sig_scal = params["signature_scalings"]    # (K,)
        smp_scal = params["sample_scalings"]       # (D,)
        sig_emb = params["signature_embeddings"]   # (K, m)
        smp_emb = params["sample_embeddings"]      # (D, m)
        variance = params["variance"]
        dtype = signatures.dtype

        rho = (state.step.astype(dtype) + config.delay) ** (
            -config.forgetting
        )

        perm, cursor, stat_usq = state.perm, state.cursor, state.stat_usq
        tau_batch = jnp.take(smp_scal, indices, axis=0)  # (B,)
        u_batch = jnp.take(smp_emb, indices, axis=0)     # (B, m)
        usq_batch_old = jnp.sum(u_batch**2)

        # 1. minibatch sample scalings (exact local M-step, closed form)
        if not fix_sample_scalings:
            tau_batch = ops.update_sample_scalings(
                X_batch, sig_scal, sig_emb, u_batch
            )

        # 2.+3. minibatch exposures and sufficient statistics
        exposures_batch = ops.compute_exposures(
            sig_scal, tau_batch, sig_emb, u_batch
        )                                                # (B, K)
        ratios = X_batch / (exposures_batch @ signatures)  # (B, V)
        aux_batch = exposures_batch.T * (signatures @ ratios.T)  # (K, B)

        # 4. signature scalings from running-averaged statistics
        observed_hat = scale * jnp.sum(aux_batch, axis=1)
        predicted_hat = scale * jnp.sum(
            jnp.exp(tau_batch[None, :] + mm(sig_emb, u_batch.T)), axis=1
        )
        stat_observed = (1.0 - rho) * state.stat_observed + rho * observed_hat
        stat_predicted = (
            (1.0 - rho) * state.stat_predicted + rho * predicted_hat
        )
        if not fix_signature_scalings:
            sig_scal = jnp.log(stat_observed) - jnp.log(stat_predicted)

        # 5a. signature embeddings: Newton solve on the minibatch-rescaled
        # surrogate (aux and rate terms scaled by D/B; the log(scale) offset
        # multiplies the rate sum, the Gaussian prior stays unscaled),
        # blended with rho - the non-conjugate SVI global update
        if not fix_signature_embeddings:
            log_scale = jnp.log(jnp.asarray(scale, dtype))
            sig_emb_star = ops.update_embeddings(
                sig_emb, u_batch, sig_scal, tau_batch + log_scale,
                variance, scale * aux_batch,
                max_iter=config.signature_newton_iters,
            )
            sig_emb = (1.0 - rho) * sig_emb + rho * sig_emb_star

        # 5b. minibatch sample embeddings (exact local update, 3 Newton
        # steps as in the reference's sample-side maxiter=3)
        if not fix_sample_embeddings:
            u_batch = ops.update_embeddings(
                u_batch, sig_emb, tau_batch, sig_scal, variance,
                aux_batch.T, max_iter=config.sample_newton_iters,
            )

        # scatter the refreshed locals back into the full arrays
        if not fix_sample_scalings:
            smp_scal = smp_scal.at[indices].set(tau_batch)
        if not fix_sample_embeddings:
            smp_emb = smp_emb.at[indices].set(u_batch)
            stat_usq = stat_usq - usq_batch_old + jnp.sum(u_batch**2)

        # 6. variance over all embeddings, with the O(D m) sample term
        # carried incrementally (exact-refreshed at each epoch boundary)
        if not fix_variance:
            total = jnp.sum(sig_emb**2) + stat_usq
            count = sig_emb.size + smp_emb.size
            variance = jnp.maximum(total / count, EPSILON)

        # 7. signatures: column-normalized running average of the expected
        # signature counts (the KL multiplicative W update in statistic form)
        counts_hat = (
            signatures.T * mm(ratios.T, exposures_batch) * scale
        )                                                # (V, K)
        stat_counts = (1.0 - rho) * state.stat_counts + rho * counts_hat
        if not fix_signatures:
            W_new = stat_counts / jnp.sum(stat_counts, axis=0)
            W_new = jnp.maximum(W_new, EPSILON)
            if K_given > 0:
                given = jnp.arange(W_new.shape[1]) < K_given
                W_new = jnp.where(given[None, :], signatures.T, W_new)
            signatures = W_new.T

        params.update(
            signatures=signatures,
            signature_scalings=sig_scal,
            sample_scalings=smp_scal,
            signature_embeddings=sig_emb,
            sample_embeddings=smp_emb,
            variance=variance,
        )
        return SVIState(
            params=params,
            stat_observed=stat_observed,
            stat_predicted=stat_predicted,
            stat_counts=stat_counts,
            step=state.step + 1,
            perm=perm,
            cursor=cursor,
            stat_usq=stat_usq,
        )

    return batch_step


@functools.lru_cache(maxsize=64)
def make_svi_step(
    n_samples: int,
    config: SVIConfig,
    n_given_signatures: int = 0,
    fix_signature_scalings: bool = False,
    fix_sample_scalings: bool = False,
    fix_signature_embeddings: bool = False,
    fix_sample_embeddings: bool = False,
    fix_variance: bool = False,
):
    """Build the jittable minibatch step (state, X, key) -> state.

    lru_cached on its (hashable) arguments: repeated fit_minibatch calls
    with identical shapes/config receive the SAME step function object, so
    run_svi's jit (step_fn is a static argument) reuses one compiled
    program instead of re-tracing per call.

    X is the full (D, V) count matrix resident on device; each step gathers
    its minibatch rows and hands them to the shared make_svi_batch_step
    core. The update order inside a step mirrors the deterministic EM cycle
    exactly (sample scalings -> exposures/aux -> signature scalings ->
    signature embeddings -> sample embeddings -> variance -> signatures),
    which is what makes the full-batch/rho=1 case collapse to CorrNMFDet's
    update.
    """
    batch_size = _validate_config(config, n_samples)
    batch_step = make_svi_batch_step(
        n_samples, config, n_given_signatures,
        fix_signature_scalings, fix_sample_scalings,
        fix_signature_embeddings, fix_sample_embeddings, fix_variance,
    )

    def step(state: SVIState, X, key) -> SVIState:
        indices, perm, cursor, stat_usq = _draw_epoch_batch(
            key, state.perm, state.cursor,
            lambda: jnp.sum(state.params["sample_embeddings"] ** 2),
            state.stat_usq, batch_size,
        )
        state = state._replace(perm=perm, cursor=cursor, stat_usq=stat_usq)
        return batch_step(state, jnp.take(X, indices, axis=0), indices)

    return step


def full_elbo(params, X):
    """Full-data ELBO at the current SVI state (exposures recomputed)."""
    exposures = ops.compute_exposures(
        params["signature_scalings"],
        params["sample_scalings"],
        params["signature_embeddings"],
        params["sample_embeddings"],
    )
    return ops.elbo_corrnmf(
        X,
        params["signatures"],
        exposures,
        params["signature_embeddings"],
        params["sample_embeddings"],
        params["variance"],
    )


@functools.partial(
    jax.jit,
    static_argnames=("step_fn", "n_steps", "eval_freq", "elbo_fn"),
)
def run_svi(step_fn, state0, X, key, n_steps: int, eval_freq: int,
            elbo_fn=full_elbo):
    """Drive `n_steps` minibatch steps, recording the full-data ELBO every
    `eval_freq` steps. Returns (final_state, history) with history shape
    (n_steps // eval_freq,). One compiled program; the full count data
    (array or pytree of per-modality arrays) stays resident on device
    throughout. elbo_fn(params, X) evaluates the recorded objective
    (full_elbo for CorrNMFDet, mm_full_elbo for MultimodalCorrNMF).

    Each evaluation is a full O(D V) pass; eval_freq=0 disables evaluation
    entirely (history comes back empty), keeping every step O(batch)."""
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if eval_freq < 0:
        raise ValueError(
            f"eval_freq={eval_freq} must be >= 1, or 0 to disable the "
            "full-data ELBO trace"
        )
    n_evals = n_steps // eval_freq if eval_freq else 0
    remainder = n_steps - n_evals * eval_freq

    def advance(carry, n):
        state, key = carry

        def body(_, inner):
            state, key = inner
            key, subkey = jax.random.split(key)
            return step_fn(state, X, subkey), key

        return jax.lax.fori_loop(0, n, body, (state, key))

    def block(carry, _):
        carry = advance(carry, eval_freq)
        return carry, elbo_fn(carry[0].params, X)

    if n_evals:
        carry, history = jax.lax.scan(
            block, (state0, key), None, length=n_evals
        )
    else:
        carry = (state0, key)
        history = jnp.zeros(
            (0,), jax.tree_util.tree_leaves(state0.params)[0].dtype
        )
    if remainder:
        carry = advance(carry, remainder)
    state, _ = carry
    return state, history


@functools.partial(
    jax.jit, static_argnames=("step_fn", "eval_freq", "elbo_fn")
)
def _run_svi_segment(step_fn, state, X, key, history, eval_offset,
                     n_blocks, eval_freq: int, elbo_fn):
    """Advance `n_blocks` (traced) eval blocks of the run_svi loop, writing
    each block's full-data objective at history[eval_offset + i]. The step
    sequence and key splits are exactly run_svi's, so chaining segments
    reproduces the monolithic program's trajectory; only WHERE the loop
    pauses differs (cf. engine.fit.run_lockstep_segment's block_cap)."""
    def block(i, carry):
        state, key, history = carry

        def body(_, inner):
            state, key = inner
            key, subkey = jax.random.split(key)
            return step_fn(state, X, subkey), key

        state, key = jax.lax.fori_loop(0, eval_freq, body, (state, key))
        history = history.at[eval_offset + i].set(
            elbo_fn(state.params, X).astype(history.dtype)
        )
        return state, key, history

    return jax.lax.fori_loop(
        0, n_blocks, block, (state, key, history)
    )


@functools.partial(jax.jit, static_argnames=("step_fn",))
def _run_svi_steps(step_fn, state, X, key, n_steps):
    """Advance `n_steps` (traced) raw minibatch steps (no evaluation) -
    the capped driver's segment for eval_freq=0 runs and the remainder
    tail. Key handling identical to run_svi's inner fori_loop."""
    def body(_, inner):
        state, key = inner
        key, subkey = jax.random.split(key)
        return step_fn(state, X, subkey), key

    return jax.lax.fori_loop(0, n_steps, body, (state, key))


def run_svi_guarded(step_fn, state0, X, key, n_steps: int, eval_freq: int,
                    elbo_fn=full_elbo, batch_size: int | None = None,
                    n_samples: int | None = None,
                    program_seconds: float | None = None):
    """run_svi behind the program-duration guard.

    run_svi compiles all n_steps into ONE program. Under a program-seconds
    budget (program_seconds, or the test hook
    parallel.compaction.PROGRAM_SECONDS_OVERRIDE) whose limit that program
    could exceed, this driver runs the IDENTICAL loop as a host-driven
    chain of capped segments (same step sequence, same key splits, evals written at
    the same step positions), adapting each dispatch's block cap from the
    measured wall of the previous one - the same pause/resume scheme as
    CompactingRunner._run_level_capped. Without a budget (the default) and
    for small runs it defers to the monolithic run_svi unchanged.

    batch_size/n_samples feed the pre-measurement cost model (a step
    touches ~batch_size/n_samples of the resident data); callers that know
    their SVIConfig should pass both - without them a step is modeled as a
    full-data pass, which only over-segments (never under-protects).
    Returns (final_state, history) exactly like run_svi.
    """
    import time

    from ..parallel import compaction

    budget = (program_seconds if program_seconds is not None
              else compaction.PROGRAM_SECONDS_OVERRIDE)
    if budget is None:
        return run_svi(step_fn, state0, X, key, n_steps, eval_freq,
                       elbo_fn=elbo_fn)
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if eval_freq < 0:
        raise ValueError(
            f"eval_freq={eval_freq} must be >= 1, or 0 to disable the "
            "full-data ELBO trace"
        )

    # -- pre-measurement cost model (pessimistic; measured feedback below
    # refines it from the second dispatch on). Steps: batch-rows bytes at
    # the compaction model's bandwidth, floored at a 0.5 ms launch-bound
    # step cost. Evals: one full pass over the resident data.
    data_bytes = sum(
        leaf.size * jnp.asarray(leaf).dtype.itemsize
        for leaf in jax.tree.leaves(X)
    )
    from ..parallel.compaction import _MODEL_BYTES_PER_SECOND

    if batch_size is not None and n_samples:
        fraction = min(int(batch_size), int(n_samples)) / int(n_samples)
        batch_bytes = data_bytes * fraction
    else:
        batch_bytes = data_bytes  # unknown batch: assume a full-data step
    step_model = max(3.5 * batch_bytes / _MODEL_BYTES_PER_SECOND, 5e-4)
    eval_model = 3.5 * data_bytes / _MODEL_BYTES_PER_SECOND

    n_evals = n_steps // eval_freq if eval_freq else 0
    remainder = n_steps - n_evals * eval_freq
    total_model = n_steps * step_model + n_evals * eval_model
    if total_model <= 2.0 * budget:
        return run_svi(step_fn, state0, X, key, n_steps, eval_freq,
                       elbo_fn=elbo_fn)

    state = state0
    if n_evals:
        hist_dtype = jax.eval_shape(elbo_fn, state0.params, X).dtype
        history = jnp.full((n_evals,), jnp.nan, dtype=hist_dtype)
        per_block_model = eval_freq * step_model + eval_model
        cap = max(1, int(budget / per_block_model))
        offset = 0
        measured = None
        while offset < n_evals:
            n_blocks = min(cap, n_evals - offset)
            t0 = time.perf_counter()
            state, key, history = _run_svi_segment(
                step_fn, state, X, key, history,
                jnp.asarray(offset, jnp.int32),
                jnp.asarray(n_blocks, jnp.int32), eval_freq, elbo_fn,
            )
            jax.block_until_ready(history)
            wall = time.perf_counter() - t0
            offset += n_blocks
            measured = wall / n_blocks
            cap = max(1, int(budget / max(measured, 1e-9)))
    else:
        history = jnp.zeros(
            (0,), jax.tree_util.tree_leaves(state0.params)[0].dtype
        )
        measured = None

    if remainder:
        # cap raw tail steps with the same model/feedback (per-step cost =
        # measured per-block cost minus the eval share when available)
        if measured is not None and eval_freq:
            step_cost = max(measured / eval_freq, 1e-9)
        else:
            step_cost = step_model
        cap = max(1, int(budget / step_cost))
        done = 0
        while done < remainder:
            n = min(cap, remainder - done)
            t0 = time.perf_counter()
            state, key = _run_svi_steps(
                step_fn, state, X, key, jnp.asarray(n, jnp.int32)
            )
            jax.block_until_ready(jax.tree.leaves(state.params)[0])
            wall = time.perf_counter() - t0
            done += n
            cap = max(1, int(budget / max(wall / n, 1e-9)))
    return state, history


# --------------------------------------------------------------------- #
# KLNMF: online NMF over the sample axis
# --------------------------------------------------------------------- #


class KLSVIState(NamedTuple):
    params: Any       # {"W": (V, K), "H": (K, D)}
    stat_counts: Any  # (V, K) running average of D-scaled expected counts
    step: Any
    perm: Any         # (D,) epoch sample order; reshuffled once per epoch
    cursor: Any       # scalar int32 position in perm


def klnmf_svi_init(params, streaming: bool = False) -> KLSVIState:
    """Fresh online-NMF state around a KLNMF parameter pytree
    ({"W": (V, K), "H": (K, D)}; StandardNMF._device_state orientation).
    streaming=True collapses the device-side perm to (0,) for the
    host-resident-X driver (see svi_init)."""
    W, H = params["W"], params["H"]
    n_samples = H.shape[1]
    perm = (
        jnp.zeros((0,), jnp.int32) if streaming
        else jnp.arange(n_samples, dtype=jnp.int32)
    )
    return KLSVIState(
        params={"W": W, "H": H},
        stat_counts=jnp.zeros(W.shape, W.dtype),
        step=jnp.zeros((), jnp.int32),
        perm=perm,
        cursor=jnp.asarray(n_samples, jnp.int32),
    )


@functools.lru_cache(maxsize=64)
def make_klnmf_svi_batch_step(
    n_samples: int,
    config: SVIConfig,
    n_given_signatures: int = 0,
    h_inner_iters: int = 1,
):
    """Online-NMF minibatch CORE for KLNMF:
    (KLSVIState, batch, indices) -> state, with batch = {"X": (V, B)} plus
    optional 'weights_kl'/'weights_lhalf' (B,) entries supplied by the
    caller (make_klnmf_svi_step gathers them from device-resident data;
    run_svi_streaming device_puts host slices - the beyond-HBM path). The
    two placements feed the same index sequence and produce bitwise-equal
    params. state.perm/cursor pass through untouched."""
    batch_size = _validate_config(config, n_samples)
    if h_inner_iters < 1:
        raise ValueError(f"h_inner_iters={h_inner_iters} must be >= 1")
    scale = n_samples / batch_size
    K_given = int(n_given_signatures)

    def batch_step(state: KLSVIState, batch, indices) -> KLSVIState:
        W = state.params["W"]
        H = state.params["H"]
        dtype = W.dtype

        rho = (state.step.astype(dtype) + config.delay) ** (
            -config.forgetting
        )
        X_batch = batch["X"]                       # (V, B)
        H_batch = jnp.take(H, indices, axis=1)     # (K, B)
        w_kl_batch = batch.get("weights_kl")
        w_lhalf_batch = batch.get("weights_lhalf")

        # sample-local step: exact multiplicative H updates on the batch
        for _ in range(h_inner_iters):
            aux = X_batch / mm(W, H_batch)
            H_batch = klops._update_H_from_aux(
                H_batch, W, aux, w_kl_batch, w_lhalf_batch
            )

        # W statistic from the refreshed exposures (update_W semantics)
        aux = X_batch / mm(W, H_batch)
        scaled_aux = aux if w_kl_batch is None else w_kl_batch * aux
        counts_hat = W * mm(scaled_aux, H_batch.T) * scale  # (V, K)
        stat_counts = (1.0 - rho) * state.stat_counts + rho * counts_hat

        n_signatures = W.shape[1]
        if K_given == n_signatures:
            W_new = W
        else:
            W_new = stat_counts / jnp.sum(stat_counts, axis=0)
            clipped = jnp.maximum(W_new, EPSILON)
            if K_given > 0:
                given = jnp.arange(n_signatures) < K_given
                W_new = jnp.where(given[None, :], W, clipped)
            else:
                W_new = clipped

        H = H.at[:, indices].set(H_batch)
        return KLSVIState(
            params={"W": W_new, "H": H},
            stat_counts=stat_counts,
            step=state.step + 1,
            perm=state.perm,
            cursor=state.cursor,
        )

    return batch_step


@functools.lru_cache(maxsize=64)
def make_klnmf_svi_step(
    n_samples: int,
    config: SVIConfig,
    n_given_signatures: int = 0,
    h_inner_iters: int = 1,
):
    """Online NMF step for KLNMF: (KLSVIState, data, key) -> state.
    lru_cached (see make_svi_step): repeated calls share one compiled
    run_svi program.

    data = {"X": (V, D)} plus optional "weights_kl"/"weights_lhalf" (D,)
    entries, exactly as the engine's data pytree (klnmf.make_step_functions).
    Each step refreshes the minibatch's exposure columns with
    `h_inner_iters` exact multiplicative H updates under the current W (the
    sample-local step), then updates W from the Robbins-Monro running
    average of the D-scaled expected signature counts
    C_hat = W * ((w . X/(W H)) @ H_b^T): column-normalizing the running
    counts IS the KL multiplicative W update in sufficient-statistic form
    (reference _utils_klnmf.py:164-217; online dictionary learning in the
    style of Mairal et al. 2010, adapted to generalized KL).

    Exactness anchor (pinned by tests/test_svi.py): batch_size = n_samples,
    rho = 1, h_inner_iters = 1 reduces to update_H followed by update_W -
    the serial Lee-Seung cycle (the full-batch engine's update_WH instead
    shares one aux from the OLD W,H; both are valid majorize-minimize
    cycles for the same objective).
    """
    batch_size = _validate_config(config, n_samples)
    batch_step = make_klnmf_svi_batch_step(
        n_samples, config, n_given_signatures, h_inner_iters
    )

    def step(state: KLSVIState, data, key) -> KLSVIState:
        # no incrementally-carried scalar statistic here; pass a dummy
        zero = jnp.zeros((), state.params["W"].dtype)
        indices, perm, cursor, _ = _draw_epoch_batch(
            key, state.perm, state.cursor, lambda: zero, zero, batch_size
        )
        state = state._replace(perm=perm, cursor=cursor)
        batch = {"X": jnp.take(data["X"], indices, axis=1)}
        for name in ("weights_kl", "weights_lhalf"):
            if data.get(name) is not None:
                batch[name] = jnp.take(data[name], indices)
        return batch_step(state, batch, indices)

    return step


def klnmf_full_objective(params, data):
    """Full-data KLNMF objective (weighted KL + optional l1/2 penalty) at
    the current online-NMF state - the run_svi eval hook for KLNMF. Note
    this objective is MINIMIZED (the trace decreases), unlike the CorrNMF
    ELBOs."""
    return klops.klnmf_objective(
        data["X"],
        params["W"],
        params["H"],
        data.get("weights_kl"),
        data.get("weights_lhalf"),
    )


# --------------------------------------------------------------------- #
# multimodal (MuData) variant: shared sample embeddings, per-modality
# globals and statistics
# --------------------------------------------------------------------- #


class MMSVIState(NamedTuple):
    params: Any   # the MultimodalCorrNMF parameter pytree (minus exposures)
    stats: Any    # {mod: {"observed": (K,), "predicted": (K,),
    #                      "counts": (V, K)}}
    step: Any
    perm: Any     # (D,) epoch sample order; reshuffled once per epoch
    cursor: Any   # scalar int32 position in perm
    stat_usq: Any  # scalar running sum(sample_embeddings**2)


def mm_svi_init(params, streaming: bool = False) -> MMSVIState:
    """Fresh multimodal SVI state around a MultimodalCorrNMF parameter
    pytree (models/mmcorrnmf.py _device_state). streaming=True collapses
    the device-side perm to (0,) for the host-resident-X driver (see
    svi_init)."""
    mods = {}
    stats = {}
    for name, mod in params["mods"].items():
        signatures = mod["signatures"]
        n_signatures, n_features = signatures.shape
        dtype = signatures.dtype
        mods[name] = {k: v for k, v in mod.items() if k != "exposures"}
        stats[name] = {
            "observed": jnp.zeros((n_signatures,), dtype),
            "predicted": jnp.zeros((n_signatures,), dtype),
            "counts": jnp.zeros((n_features, n_signatures), dtype),
        }
    sample_embeddings = params["sample_embeddings"]
    n_samples = sample_embeddings.shape[0]
    perm = (
        jnp.zeros((0,), jnp.int32) if streaming
        else jnp.arange(n_samples, dtype=jnp.int32)
    )
    return MMSVIState(
        params={
            "mods": mods,
            "sample_embeddings": sample_embeddings,
            "variance": params["variance"],
        },
        stats=stats,
        step=jnp.zeros((), jnp.int32),
        perm=perm,
        cursor=jnp.asarray(n_samples, jnp.int32),
        stat_usq=jnp.sum(sample_embeddings**2),
    )


def mm_full_elbo(params, X):
    """Full-data multimodal ELBO (exposures recomputed; shared sample
    penalty added exactly once, as in MultimodalCorrNMF._build_step)."""
    U = params["sample_embeddings"]
    variance = params["variance"]
    elbo = 0.0
    for name, mod in params["mods"].items():
        exposures = ops.compute_exposures(
            mod["signature_scalings"], mod["sample_scalings"],
            mod["signature_embeddings"], U,
        )
        elbo += ops.elbo_corrnmf(
            X[name], mod["signatures"], exposures,
            mod["signature_embeddings"], U, variance,
            penalize_sample_embeddings=False,
        )
    n_obs, dim = U.shape
    elbo -= 0.5 * dim * n_obs * jnp.log(2.0 * jnp.pi * variance)
    elbo -= jnp.sum(U**2) / (2.0 * variance)
    return elbo


def make_mm_svi_step(
    n_samples: int,
    mod_names: list,
    ns_signatures: list,
    config: SVIConfig,
    mod_flags: dict | None = None,
    fix_sample_embeddings: bool = False,
    fix_variance: bool = False,
):
    """Multimodal twin of make_svi_step: (MMSVIState, X_dict, key) -> state.

    One shared minibatch of samples drives every modality; the joint
    sample-embedding update concatenates the modality signature axes exactly
    as the full-batch step does (models/mmcorrnmf.py _build_step step 5b).
    mod_flags[name] may carry 'n_given', 'fix_signatures',
    'fix_sig_scalings', 'fix_smp_scalings', 'fix_sig_embeddings' (all
    defaulting to free).

    lru_cached (see make_svi_step) after normalizing the list/dict
    arguments to hashable tuples: repeated fit_minibatch calls share one
    compiled run_svi program."""
    return _make_mm_svi_step_cached(
        int(n_samples), tuple(mod_names), tuple(int(n) for n in ns_signatures),
        config, _freeze_mod_flags(mod_names, mod_flags),
        bool(fix_sample_embeddings), bool(fix_variance),
    )


def _freeze_mod_flags(mod_names, mod_flags):
    if mod_flags is None:
        return None
    return tuple(
        (name, tuple(sorted((mod_flags.get(name) or {}).items())))
        for name in mod_names
    )


@functools.lru_cache(maxsize=64)
def _make_mm_svi_step_cached(
    n_samples: int,
    mod_names: tuple,
    ns_signatures: tuple,
    config: SVIConfig,
    frozen_flags,
    fix_sample_embeddings: bool,
    fix_variance: bool,
):
    batch_size = _validate_config(config, n_samples)
    batch_step = _make_mm_svi_batch_step_cached(
        n_samples, mod_names, ns_signatures, config, frozen_flags,
        fix_sample_embeddings, fix_variance,
    )

    def step(state: MMSVIState, X, key) -> MMSVIState:
        indices, perm, cursor, stat_usq = _draw_epoch_batch(
            key, state.perm, state.cursor,
            lambda: jnp.sum(state.params["sample_embeddings"] ** 2),
            state.stat_usq, batch_size,
        )
        state = state._replace(perm=perm, cursor=cursor, stat_usq=stat_usq)
        X_batch = {
            name: jnp.take(X[name], indices, axis=0) for name in mod_names
        }
        return batch_step(state, X_batch, indices)

    return step


def make_mm_svi_batch_step(
    n_samples: int,
    mod_names: list,
    ns_signatures: list,
    config: SVIConfig,
    mod_flags: dict | None = None,
    fix_sample_embeddings: bool = False,
    fix_variance: bool = False,
):
    """Multimodal minibatch CORE: (MMSVIState, X_batch, indices) -> state,
    with X_batch = {mod: (B, V_i) count rows} supplied by the caller - the
    shared engine of the device-resident (make_mm_svi_step) and
    host-streaming (run_svi_streaming) placements; see make_svi_batch_step.
    """
    return _make_mm_svi_batch_step_cached(
        int(n_samples), tuple(mod_names), tuple(int(n) for n in ns_signatures),
        config, _freeze_mod_flags(mod_names, mod_flags),
        bool(fix_sample_embeddings), bool(fix_variance),
    )


@functools.lru_cache(maxsize=64)
def _make_mm_svi_batch_step_cached(
    n_samples: int,
    mod_names: tuple,
    ns_signatures: tuple,
    config: SVIConfig,
    frozen_flags,
    fix_sample_embeddings: bool,
    fix_variance: bool,
):
    mod_flags = None if frozen_flags is None else {
        name: dict(items) for name, items in frozen_flags
    }
    batch_size = _validate_config(config, n_samples)
    scale = n_samples / batch_size
    mod_names = list(mod_names)
    defaults = dict(
        n_given=0, fix_signatures=False, fix_sig_scalings=False,
        fix_smp_scalings=False, fix_sig_embeddings=False,
    )
    flags = {
        name: {**defaults, **((mod_flags or {}).get(name, {}))}
        for name in mod_names
    }

    def batch_step(state: MMSVIState, X_batch_all, indices) -> MMSVIState:
        mods = {
            name: dict(state.params["mods"][name]) for name in mod_names
        }
        U = state.params["sample_embeddings"]
        variance = state.params["variance"]
        dtype = U.dtype
        stats = {name: dict(state.stats[name]) for name in mod_names}

        rho = (state.step.astype(dtype) + config.delay) ** (
            -config.forgetting
        )
        log_scale = jnp.log(jnp.asarray(scale, dtype))

        perm, cursor, stat_usq = state.perm, state.cursor, state.stat_usq
        U_batch = jnp.take(U, indices, axis=0)  # (B, m)
        usq_batch_old = jnp.sum(U_batch**2)

        # 1-3: per-modality locals + sufficient statistics on the batch
        batch = {}
        for name in mod_names:
            m, f = mods[name], flags[name]
            X_batch = X_batch_all[name]                    # (B, V_i)
            tau_batch = jnp.take(m["sample_scalings"], indices, axis=0)
            if not f["fix_smp_scalings"]:
                tau_batch = ops.update_sample_scalings(
                    X_batch, m["signature_scalings"],
                    m["signature_embeddings"], U_batch,
                )
            exposures_batch = ops.compute_exposures(
                m["signature_scalings"], tau_batch,
                m["signature_embeddings"], U_batch,
            )                                              # (B, K_i)
            ratios = X_batch / mm(exposures_batch, m["signatures"])
            aux_batch = (
                exposures_batch.T * mm(m["signatures"], ratios.T)
            )                                              # (K_i, B)
            batch[name] = dict(
                tau=tau_batch, exposures=exposures_batch,
                ratios=ratios, aux=aux_batch,
            )

        # 4: per-modality signature scalings from running averages
        for name in mod_names:
            m, f, b, s = mods[name], flags[name], batch[name], stats[name]
            observed_hat = scale * jnp.sum(b["aux"], axis=1)
            predicted_hat = scale * jnp.sum(
                jnp.exp(b["tau"][None, :]
                        + mm(m["signature_embeddings"], U_batch.T)),
                axis=1,
            )
            s["observed"] = (1.0 - rho) * s["observed"] + rho * observed_hat
            s["predicted"] = (
                (1.0 - rho) * s["predicted"] + rho * predicted_hat
            )
            if not f["fix_sig_scalings"]:
                m["signature_scalings"] = jnp.log(s["observed"]) - jnp.log(
                    s["predicted"]
                )

        # 5a: per-modality signature embeddings (damped SVI global update)
        for name in mod_names:
            m, f, b = mods[name], flags[name], batch[name]
            if f["fix_sig_embeddings"]:
                continue
            sig_emb_star = ops.update_embeddings(
                m["signature_embeddings"], U_batch,
                m["signature_scalings"], b["tau"] + log_scale,
                variance, scale * b["aux"],
                max_iter=config.signature_newton_iters,
            )
            m["signature_embeddings"] = (
                (1.0 - rho) * m["signature_embeddings"] + rho * sig_emb_star
            )

        # 5b: joint minibatch sample-embedding update across modalities
        if not fix_sample_embeddings:
            sig_embs = jnp.concatenate(
                [mods[n]["signature_embeddings"] for n in mod_names], axis=0
            )
            sig_scals = jnp.concatenate(
                [mods[n]["signature_scalings"] for n in mod_names]
            )
            aux_all = jnp.concatenate(
                [batch[n]["aux"] for n in mod_names], axis=0
            )                                              # (sum K, B)
            scalings_mat = jnp.concatenate(
                [
                    jnp.tile(
                        batch[n]["tau"][:, None], (1, ns_signatures[i])
                    )
                    for i, n in enumerate(mod_names)
                ],
                axis=1,
            )                                              # (B, sum K)
            U_batch = ops.update_embeddings(
                U_batch, sig_embs, scalings_mat, sig_scals, variance,
                aux_all.T, max_iter=config.sample_newton_iters,
            )
            U = U.at[indices].set(U_batch)
            stat_usq = stat_usq - usq_batch_old + jnp.sum(U_batch**2)

        # scatter the per-modality locals
        for name in mod_names:
            if not flags[name]["fix_smp_scalings"]:
                mods[name]["sample_scalings"] = (
                    mods[name]["sample_scalings"]
                    .at[indices].set(batch[name]["tau"])
                )

        # 6: shared variance from all signature embeddings + full U, with
        # the O(D m) sample term carried incrementally (exact-refreshed at
        # each epoch boundary)
        if not fix_variance:
            all_sig_embs = jnp.concatenate(
                [mods[n]["signature_embeddings"] for n in mod_names], axis=0
            )
            total = jnp.sum(all_sig_embs**2) + stat_usq
            count = all_sig_embs.size + U.size
            variance = jnp.maximum(total / count, EPSILON)

        # 7: per-modality signatures from running expected counts
        for name in mod_names:
            m, f, b, s = mods[name], flags[name], batch[name], stats[name]
            counts_hat = (
                m["signatures"].T * mm(b["ratios"].T, b["exposures"]) * scale
            )                                              # (V_i, K_i)
            s["counts"] = (1.0 - rho) * s["counts"] + rho * counts_hat
            if not f["fix_signatures"]:
                W_new = s["counts"] / jnp.sum(s["counts"], axis=0)
                W_new = jnp.maximum(W_new, EPSILON)
                if f["n_given"] > 0:
                    given = jnp.arange(W_new.shape[1]) < f["n_given"]
                    W_new = jnp.where(
                        given[None, :], m["signatures"].T, W_new
                    )
                m["signatures"] = W_new.T

        return MMSVIState(
            params={
                "mods": mods,
                "sample_embeddings": U,
                "variance": variance,
            },
            stats=stats,
            step=state.step + 1,
            perm=perm,
            cursor=cursor,
            stat_usq=stat_usq,
        )

    return batch_step


# --------------------------------------------------------------------- #
# beyond-HBM streaming: X host-resident, minibatches device_put per step
# --------------------------------------------------------------------- #


@functools.lru_cache(maxsize=64)
def _jitted(fn):
    """One stable jit wrapper per (cached) step/chunk function object, so
    repeated run_svi_streaming calls reuse compiled programs."""
    return jax.jit(fn)


def _host_cpu_device():
    return jax.devices("cpu")[0]


def run_svi_streaming(
    batch_step_fn,
    state0,
    get_batch,
    n_samples: int,
    batch_size: int,
    key,
    n_steps: int,
    eval_freq: int = 0,
    objective_fn=None,
    refresh_fn=None,
    prefetch: int = 2,
    device=None,
):
    """Drive minibatch steps with the count data HOST-resident: the epoch
    permutation lives on the host, each step's rows are sliced from host
    memory and device_put while the device is still computing earlier steps
    (JAX's async dispatch provides the double buffering; `prefetch` bounds
    how far the host may run ahead so in-flight batch buffers can't
    accumulate in HBM).

    This is the single-chip beyond-HBM path: only the O(D) per-sample state
    (scalings/embeddings or H) and O(B) batches live on device, so cohorts
    whose count matrix exceeds HBM fit end-to-end. The reference loads all
    of X up front (signature_nmf.py:269-281) and cannot.

    batch_step_fn: a make_*_svi_batch_step core (state, batch, indices) ->
    state. get_batch(indices) -> host batch pytree for those samples (the
    family's layout: (B, V) rows for CorrNMF, {"X": (V, B), weights...} for
    KLNMF, {mod: (B, V_i)} for multimodal).

    The index sequence REPLICATES the resident path's on-device epoch
    sampler exactly (same jax.random key splits, same reshuffle positions,
    same drop-last semantics - jax.random is platform-deterministic), so
    streaming and resident fits from the same seed produce bitwise-equal
    parameters; refresh_fn (refresh_sample_usq where the family carries a
    running sum-of-squares) is applied at exactly the resident refresh
    positions.

    objective_fn(params) -> device scalar (e.g. from make_streamed_objective)
    is evaluated after every `eval_freq` steps, matching run_svi's recording
    positions. Returns (final_state, history list of floats). The final
    state's perm/cursor fields are NOT meaningful (the host owns them).
    """
    import collections

    import numpy as np

    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if eval_freq < 0:
        raise ValueError(f"eval_freq={eval_freq} must be >= 0")
    if not 1 <= batch_size <= n_samples:
        raise ValueError(
            f"batch_size={batch_size} must be in [1, n_samples={n_samples}]"
        )
    cpu = _host_cpu_device()
    if device is None:
        from ..device import default_device

        device = default_device()
    step = _jitted(batch_step_fn)
    refresh = _jitted(refresh_fn) if refresh_fn is not None else None

    key = jax.device_put(key, cpu)
    perm = None
    cursor = n_samples  # svi_init semantics: first step reshuffles
    state = state0
    inflight = collections.deque()
    history = []
    for t in range(n_steps):
        with jax.default_device(cpu):
            key, subkey = jax.random.split(key)
            reshuffle = cursor + batch_size > n_samples
            if reshuffle:
                # mirror of _draw_epoch_batch's reshuffle branch (including
                # drop-last): permutation drawn with the STEP's subkey
                perm = np.asarray(
                    jax.random.permutation(subkey, n_samples)
                ).astype(np.int32)
                cursor = 0
        if reshuffle and refresh is not None:
            # outside the cpu default_device scope: at t=0 the state is
            # still uncommitted, and running the refresh under the scope
            # would pull the whole per-sample pytree through the host
            # (host round-trip + CPU accumulation order, breaking the
            # resident-path bitwise pin on the accelerator backend)
            state = refresh(state)
        indices = perm[cursor:cursor + batch_size]
        cursor += batch_size
        batch_dev = jax.device_put(get_batch(indices), device)
        idx_dev = jax.device_put(indices, device)
        state = step(state, batch_dev, idx_dev)
        inflight.append(state.step)
        if len(inflight) > prefetch:
            jax.block_until_ready(inflight.popleft())
        if eval_freq and objective_fn is not None and (t + 1) % eval_freq == 0:
            history.append(objective_fn(state.params))
    jax.block_until_ready(state.step)
    if history:
        from ..engine.transfer import fetch_pytree

        history = [float(v) for v in fetch_pytree(tuple(history))]
    return state, history


def make_streamed_objective(
    chunk_fn,
    rest_fn,
    get_chunk,
    n_samples: int,
    chunk_size: int = 8192,
    device=None,
):
    """Build params -> device-scalar full-data objective that streams the
    host-resident counts through the device in fixed-shape chunks.

    chunk_fn(carry, params, chunk, indices, valid) accumulates the chunk's
    decomposable contribution into the scalar carry (jitted once per shape;
    the last chunk is index-padded with `valid` masking the padding);
    rest_fn(params) adds the sample-independent terms (Gaussian penalties).
    get_chunk(indices) -> host pytree of those samples' counts. The
    accumulation stays ON DEVICE - one scalar comes back per evaluation,
    not per chunk (each small fetch pays a transfer latency)."""
    import numpy as np

    if device is None:
        from ..device import default_device

        device = default_device()
    chunk_size = int(min(chunk_size, n_samples))
    chunk_jit = _jitted(chunk_fn)
    rest_jit = _jitted(rest_fn)

    def evaluate(params):
        carry = None
        for start in range(0, n_samples, chunk_size):
            stop = min(start + chunk_size, n_samples)
            indices = np.arange(start, stop, dtype=np.int32)
            n_valid = stop - start
            if n_valid < chunk_size:
                indices = np.concatenate(
                    [indices, np.zeros(chunk_size - n_valid, np.int32)]
                )
            valid = np.arange(chunk_size) < n_valid
            chunk_dev, idx_dev, valid_dev = jax.device_put(
                (get_chunk(indices), indices, valid), device
            )
            if carry is None:
                dtype = jnp.asarray(
                    jax.tree_util.tree_leaves(params)[0]
                ).dtype
                carry = jnp.zeros((), dtype)
            carry = chunk_jit(carry, params, chunk_dev, idx_dev, valid_dev)
        return carry + rest_jit(params)

    return evaluate


def corrnmf_elbo_stream_chunk(carry, params, X_chunk, indices, valid):
    """Per-chunk Poisson log-likelihood contribution to the CorrNMF ELBO
    (the sample-decomposable part of ops.corrnmf.elbo_corrnmf; X_chunk is
    (C, V) count rows)."""
    from jax.scipy.special import gammaln

    tau = jnp.take(params["sample_scalings"], indices)
    u = jnp.take(params["sample_embeddings"], indices, axis=0)
    exposures = ops.compute_exposures(
        params["signature_scalings"], tau, params["signature_embeddings"], u
    )                                           # (C, K)
    WH = exposures @ params["signatures"]       # (C, V)
    nonzero = WH != 0
    log_wh = jnp.log(jnp.where(nonzero, WH, 1.0))
    per_sample = jnp.sum(
        jnp.where(nonzero, X_chunk * log_wh, 0.0) - WH, axis=1
    )
    per_sample -= jnp.sum(gammaln(1.0 + X_chunk), axis=1)
    return carry + jnp.sum(jnp.where(valid, per_sample, 0.0))


def corrnmf_elbo_stream_rest(params):
    """Sample-count-independent ELBO terms: both Gaussian embedding
    penalties (the full sample-embedding matrix is device-resident)."""
    sig_emb = params["signature_embeddings"]
    smp_emb = params["sample_embeddings"]
    variance = params["variance"]
    n_signatures, dim = sig_emb.shape
    n_samples = smp_emb.shape[0]
    log_norm = jnp.log(2.0 * jnp.pi * variance)
    rest = -0.5 * dim * n_signatures * log_norm
    rest -= jnp.sum(sig_emb**2) / (2.0 * variance)
    rest -= 0.5 * dim * n_samples * log_norm
    rest -= jnp.sum(smp_emb**2) / (2.0 * variance)
    return rest


def klnmf_objective_stream_chunk(carry, params, chunk, indices, valid):
    """Per-chunk weighted-KL (+ l1/2) contribution to the KLNMF objective
    (sample-decomposable; chunk = {"X": (V, C)} plus optional weights)."""
    X = chunk["X"]
    W = params["W"]
    H_cols = jnp.take(params["H"], indices, axis=1)   # (K, C)
    WH = mm(W, H_cols)
    nonzero = X != 0
    safe_ratio = jnp.where(nonzero, X / jnp.where(nonzero, WH, 1.0), 1.0)
    summands = jnp.where(nonzero, X * jnp.log(safe_ratio) - X, 0.0) + WH
    per_sample = jnp.sum(summands, axis=0)            # (C,)
    weights_kl = chunk.get("weights_kl")
    if weights_kl is not None:
        per_sample = per_sample * weights_kl
    weights_lhalf = chunk.get("weights_lhalf")
    if weights_lhalf is not None:
        per_sample = per_sample + weights_lhalf * jnp.sum(
            jnp.sqrt(H_cols), axis=0
        )
    return carry + jnp.sum(jnp.where(valid, per_sample, 0.0))


def klnmf_objective_stream_rest(params):
    """KLNMF has no sample-independent objective terms."""
    return jnp.zeros((), params["W"].dtype)


def mm_elbo_stream_chunk(carry, params, X_chunk, indices, valid):
    """Per-chunk multimodal ELBO contribution: each modality's Poisson
    log-likelihood over the chunk's samples (X_chunk = {mod: (C, V_i)})."""
    U = params["sample_embeddings"]
    for name, mod in params["mods"].items():
        sub = {
            "sample_scalings": mod["sample_scalings"],
            "sample_embeddings": U,
            "signature_scalings": mod["signature_scalings"],
            "signature_embeddings": mod["signature_embeddings"],
            "signatures": mod["signatures"],
        }
        carry = corrnmf_elbo_stream_chunk(
            carry, sub, X_chunk[name], indices, valid
        )
    return carry


def mm_elbo_stream_rest(params):
    """Multimodal sample-independent terms: per-modality signature
    penalties plus the shared sample penalty exactly once (mm_full_elbo
    semantics)."""
    U = params["sample_embeddings"]
    variance = params["variance"]
    log_norm = jnp.log(2.0 * jnp.pi * variance)
    rest = jnp.zeros((), U.dtype)
    for mod in params["mods"].values():
        sig_emb = mod["signature_embeddings"]
        n_signatures, dim = sig_emb.shape
        rest -= 0.5 * dim * n_signatures * log_norm
        rest -= jnp.sum(sig_emb**2) / (2.0 * variance)
    n_samples, dim = U.shape
    rest -= 0.5 * dim * n_samples * log_norm
    rest -= jnp.sum(U**2) / (2.0 * variance)
    return rest

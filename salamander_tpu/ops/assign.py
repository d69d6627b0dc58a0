"""Catalog-assignment kernels: exposure-only refits against a FIXED
signature catalog, with per-sample per-signature activity masks.

The reference expresses a single catalog refit as
``fit(given_parameters={"asignatures": ...})`` (reference
src/salamander/models/klnmf.py:83-121 freezes W columns through the MU
update); what it has no equivalent for is the *sparse assignment* problem:
pick, for every sample independently, the smallest subset of catalog
signatures that still explains its counts (the job of tools like
SigProfilerAssignment, which solve it sample-by-sample with host NNLS
loops).

Device design: with W fixed, every sample is an independent K-variable
problem, so

- the whole cohort refits as ONE batched multiplicative-update program
  (the H update of KLNMF; W never updates), and
- the greedy backward-elimination search runs ALL K candidate removals for
  ALL samples at once: candidates are a vmapped lane axis over the masked
  refit, the accept/remove decision is an argmin + gather on device, and
  the round loop is a single ``lax.while_loop`` — zero host round-trips
  until the final result fetch. (Under a program-seconds budget,
  cohort-scale searches instead run the *_guarded twins below: the
  identical loops paused/resumed as one program per round and capped
  refit segments.)

Masking convention matches ops.klnmf.make_masked_step_functions: inactive
(k, d) entries of H are held at EXACT zero, so W @ H, the KL and every
ratio equal the subset computation (adding exact zeros to a contraction is
exact); active entries are clipped at EPSILON like every other update in
the package.

All matmuls here run at ``precision=HIGHEST`` (full f32): a reduced-
precision f32 matmul (one bf16 pass, or TF32 on GPU tensor cores) puts
enough noise into aux = X/(W@H) to shift the MU fixed points, and the
acceptance budget compares per-sample KLs at a few percent. The matrices
are small; the cost is noise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .klnmf import EPSILON, samplewise_kl_divergence

_HIGHEST = lax.Precision.HIGHEST


def _mm(a, b):
    """Full-f32 matmul (see module docstring: reduced-precision passes
    break the acceptance invariant)."""
    return jnp.matmul(a, b, precision=_HIGHEST)


def _kl(X, W, H):
    """Precision-pinned per-sample KL: the acceptance and convergence
    decisions ride on it, so its W @ H must not be reduced-precision
    either."""
    with jax.default_matmul_precision("highest"):
        return samplewise_kl_divergence(X, W, H)

__all__ = [
    "init_exposures",
    "refit_exposures_fixed",
    "refit_exposures",
    "refit_exposures_guarded",
    "eliminate_signatures",
    "eliminate_signatures_guarded",
    "bootstrap_refit",
    "bootstrap_refit_guarded",
]


def init_exposures(X, W, mask):
    """Uniform warm start: each sample's counts split evenly over its
    active signatures (inactive entries exactly zero).

    X: (V, D) counts; W: (V, K) catalog; mask: (K, D) bool. Returns (K, D).
    """
    dtype = jnp.result_type(X, W)
    counts = jnp.sum(mask, axis=0)
    colsum = jnp.sum(X, axis=0, dtype=dtype)
    H0 = colsum[None, :] / jnp.maximum(counts, 1)[None, :]
    return jnp.where(mask, jnp.maximum(H0, EPSILON), 0.0)


def _masked_mu_step(X, W, H, mask):
    """One exposure-only MU step under the activity mask.

    Deliberately the EXACT arithmetic of ops.klnmf.update_H (aux without
    clipping) so the all-active case is bitwise the canonical H update;
    a fully-masked sample column yields nan in aux but the where() pins
    its H entries to exact zero regardless.
    """
    aux = X / _mm(W, H)
    H_new = H * _mm(W.T, aux)
    return jnp.where(mask, jnp.maximum(H_new, EPSILON), 0.0)


def refit_exposures_fixed(X, W, mask, H0, n_iterations: int):
    """Masked exposure-only refit, FIXED iteration count (fori_loop).

    The candidate-evaluation workhorse: cheap, branch-free, warm-started.
    """
    body = lambda _, H: _masked_mu_step(X, W, H, mask)
    return lax.fori_loop(0, n_iterations, body, H0)


def refit_exposures(X, W, mask, H0=None, max_iterations: int = 10_000,
                    tol: float = 1e-7, conv_test_freq: int = 10):
    """Masked exposure-only refit to convergence.

    Runs blocks of ``conv_test_freq`` MU steps inside a ``lax.while_loop``
    and stops when the relative objective improvement over a block drops
    below ``tol`` (the package's standard convergence rule, engine/fit.py
    semantics) or ``max_iterations`` is hit. Returns (H, n_iterations).
    """
    if H0 is None:
        H0 = init_exposures(X, W, mask)
    max_blocks = -(-max_iterations // conv_test_freq)

    def objective(H):
        return jnp.sum(_kl(X, W, H))

    def cond(state):
        _, prev, cur, block = state
        rel = jnp.abs(prev - cur) / jnp.maximum(jnp.abs(prev), EPSILON)
        return (block < max_blocks) & ((block < 1) | (rel >= tol))

    def body(state):
        H, _, cur, block = state
        H = refit_exposures_fixed(X, W, mask, H, conv_test_freq)
        return H, cur, objective(H), block + 1

    init = (H0, jnp.inf, objective(H0), jnp.asarray(0))
    H, _, _, blocks = lax.while_loop(cond, body, init)
    return H, blocks * conv_test_freq


# --------------------------------------------------------------------- #
# Program-duration guard: capped/resumable twins
# --------------------------------------------------------------------- #
#
# Every public driver above runs as ONE device program. Under a
# program-seconds budget (an explicit program_seconds=, or the
# parallel.compaction.PROGRAM_SECONDS_OVERRIDE test hook), the twins below run the IDENTICAL loops
# as host-driven chains of capped programs: refit_exposures as a paused
# and resumed while_loop (same blocks, same convergence test), the
# elimination as one jitted program per round (the monolithic
# while_loop's body), pausing between rounds. Without a budget (the
# default) and for small fits they defer to the monolithic programs
# unchanged.


@functools.partial(jax.jit, static_argnames=("conv_test_freq",))
def _refit_init(X, W, mask, H0, conv_test_freq: int):
    """Initial refit loop state (H, of_prev, of_cur, block) as one program."""
    dtype = jnp.result_type(X, W)
    X = X.astype(dtype)
    W = W.astype(dtype)
    if H0 is None:
        H0 = init_exposures(X, W, mask)
    return H0, jnp.asarray(jnp.inf, dtype), jnp.sum(_kl(X, W, H0)), jnp.asarray(0)


@functools.partial(jax.jit, static_argnames=("conv_test_freq",))
def _refit_segment(X, W, mask, H, of_prev, of_cur, block, max_blocks, tol,
                   block_cap, conv_test_freq: int):
    """Resume refit_exposures' while_loop for at most `block_cap` (traced)
    convergence blocks. Chaining segments reproduces the monolithic loop
    exactly - the cap changes where the loop pauses, never the trajectory.
    Returns the state plus int32 stats [block, done]."""
    dtype = jnp.result_type(X, W)
    X = X.astype(dtype)
    W = W.astype(dtype)
    end = block + block_cap

    def objective(H):
        return jnp.sum(_kl(X, W, H))

    def rel_change(prev, cur):
        return jnp.abs(prev - cur) / jnp.maximum(jnp.abs(prev), EPSILON)

    def cond(state):
        H, prev, cur, blk = state
        live = (blk < max_blocks) & ((blk < 1) | (rel_change(prev, cur) >= tol))
        return live & (blk < end)

    def body(state):
        H, _, cur, blk = state
        H = refit_exposures_fixed(X, W, mask, H, conv_test_freq)
        return H, cur, objective(H), blk + 1

    H, of_prev, of_cur, block = lax.while_loop(
        cond, body, (H, of_prev, of_cur, block)
    )
    done = (block >= max_blocks) | (
        (block >= 1) & (rel_change(of_prev, of_cur) < tol)
    )
    stats = jnp.stack([block.astype(jnp.int32), done.astype(jnp.int32)])
    return H, of_prev, of_cur, block, stats


_refit_monolithic = jax.jit(
    refit_exposures, static_argnames=("max_iterations", "conv_test_freq")
)


def _program_budget(program_seconds):
    """Resolve the program-duration budget (lazy import: ops must not
    import parallel at module scope)."""
    if program_seconds is not None:
        return program_seconds
    from ..parallel import compaction

    return compaction.PROGRAM_SECONDS_OVERRIDE


def _refit_iter_seconds(X, W) -> float:
    """Pessimistic modeled seconds per masked-MU iteration (bytes touched
    ~3.5x the X/WH/aux buffers plus the H pair, at the compaction model's
    pessimistic bandwidth; measured feedback recovers the slack from the
    second dispatch on)."""
    from ..parallel.compaction import _MODEL_BYTES_PER_SECOND

    V, D = X.shape
    K = W.shape[1]
    itemsize = jnp.result_type(X, W).itemsize
    per_iter_bytes = 3.5 * itemsize * (V * D + 2 * K * D + V * K)
    return per_iter_bytes / _MODEL_BYTES_PER_SECOND


def refit_exposures_guarded(X, W, mask, H0=None, max_iterations: int = 10_000,
                            tol: float = 1e-7, conv_test_freq: int = 10,
                            program_seconds: float | None = None):
    """refit_exposures behind the program-duration guard.

    When a program-seconds budget is set and the modeled whole-loop
    duration could exceed it, the convergence loop runs as a host-driven
    chain of capped segments (_refit_segment) with per-dispatch measured
    feedback, at the cost of one int32[2] fetch per segment. Otherwise
    (no budget, small cohorts) defers to the monolithic jitted
    refit_exposures. Returns (H, n_iterations) exactly
    like refit_exposures.
    """
    import time

    import numpy as np

    budget = _program_budget(program_seconds)
    max_blocks = -(-max_iterations // conv_test_freq)
    if budget is not None:
        est = _refit_iter_seconds(X, W) * max_iterations
    if budget is None or est <= 2.0 * budget:
        return _refit_monolithic(
            X, W, mask, H0, max_iterations=max_iterations, tol=tol,
            conv_test_freq=conv_test_freq,
        )

    H, of_prev, of_cur, block = _refit_init(X, W, mask, H0, conv_test_freq)
    per_block = _refit_iter_seconds(X, W) * conv_test_freq
    cap = max(1, int(budget / per_block))
    prev_block = 0
    while True:
        t0 = time.perf_counter()
        H, of_prev, of_cur, block, stats = _refit_segment(
            X, W, mask, H, of_prev, of_cur, block,
            jnp.asarray(max_blocks), tol, jnp.asarray(cap), conv_test_freq,
        )
        blocks_done, done = (int(v) for v in np.asarray(stats))
        wall = time.perf_counter() - t0
        if blocks_done > prev_block:
            measured = wall / (blocks_done - prev_block)
            cap = max(1, int(budget / max(measured, 1e-9)))
        prev_block = blocks_done
        if done:
            return H, blocks_done * conv_test_freq


@functools.partial(
    jax.jit, static_argnames=("candidate_iters", "polish_iterations")
)
def _elimination_round(X, W, mask, H, frozen, budget,
                       candidate_iters: int, polish_iterations: int):
    """One greedy-elimination round as its own program: exactly the body of
    eliminate_signatures' while_loop (try every removal for every sample,
    accept each sample's cheapest in-budget removal, polish), plus an int32
    count of frozen samples for the host driver's stopping test (int32,
    never bool - see _refit_segment)."""
    dtype = jnp.result_type(X, W)
    X = X.astype(dtype)
    W = W.astype(dtype)
    K = W.shape[1]

    def candidate(k, mask, H):
        m_k = mask.at[k, :].set(False)
        Hk = refit_exposures_fixed(X, W, m_k, jnp.where(m_k, H, 0.0),
                                   candidate_iters)
        kl = _kl(X, W, Hk)
        valid = mask[k, :] & (jnp.sum(mask, axis=0) > 1)
        return jnp.where(valid, kl, jnp.inf), Hk

    cand_kl, cand_H = jax.vmap(candidate, in_axes=(0, None, None))(
        jnp.arange(K), mask, H
    )
    k_star = jnp.argmin(cand_kl, axis=0)
    kl_star = jnp.min(cand_kl, axis=0)
    accept = (~frozen) & (kl_star <= budget)
    removal = (jnp.arange(K)[:, None] == k_star[None, :]) & accept[None, :]
    new_mask = mask & ~removal
    H_star = jnp.take_along_axis(cand_H, k_star[None, None, :], axis=0)[0]
    new_H = jnp.where(accept[None, :], H_star, H)
    new_H = refit_exposures_fixed(X, W, new_mask, new_H, polish_iterations)
    new_frozen = frozen | ~accept
    return new_mask, new_H, new_frozen, jnp.sum(new_frozen, dtype=jnp.int32)


def eliminate_signatures_guarded(
    X,
    W,
    rel_tol,
    abs_tol=0.0,
    candidate_iters: int = 50,
    polish_iterations: int = 200,
    max_polish_iterations: int = 10_000,
    conv_test_freq: int = 10,
    polish_tol=1e-7,
    program_seconds: float | None = None,
):
    """eliminate_signatures as a host-driven chain of per-round programs.

    The monolithic version runs the dense refit, EVERY elimination round
    and the final polish inside ONE device program. Here the identical loop
    pauses between rounds (one int32 fetch each) and the dense/final
    refits go through refit_exposures_guarded's capped segments. Same
    math, same results; one round must itself fit the budget, which the
    caller controls via its sample batch size (assign.assign_signatures
    models this and auto-chunks under a budget). Returns eliminate_signatures' dict.
    """
    dtype = jnp.result_type(X, W)
    X = jnp.asarray(X, dtype)
    W = jnp.asarray(W, dtype)
    K = W.shape[1]
    D = X.shape[1]

    mask0 = jnp.ones((K, D), dtype=bool)
    frozen = jnp.zeros(D, dtype=bool)
    # under a sample-sharded X (assign.assign_signatures mesh=...) place the
    # per-sample state on the same shards up front, so every round program
    # starts aligned instead of resharding replicated inputs
    x_sharding = getattr(X, "sharding", None)
    if isinstance(x_sharding, jax.sharding.NamedSharding) \
            and len(x_sharding.spec) == 2:
        mask0 = jax.device_put(mask0, x_sharding)
        frozen = jax.device_put(frozen, jax.sharding.NamedSharding(
            x_sharding.mesh, jax.sharding.PartitionSpec(x_sharding.spec[1])
        ))
    H_dense, _ = refit_exposures_guarded(
        X, W, mask0, max_iterations=max_polish_iterations, tol=polish_tol,
        conv_test_freq=conv_test_freq, program_seconds=program_seconds,
    )
    kl_dense, budget = _elimination_budget(X, W, H_dense, rel_tol, abs_tol)

    mask, H = mask0, H_dense
    rounds = 0
    while rounds < K:
        mask, H, frozen, n_frozen = _elimination_round(
            X, W, mask, H, frozen, budget,
            candidate_iters=candidate_iters,
            polish_iterations=polish_iterations,
        )
        rounds += 1
        if int(n_frozen) == D:
            break

    H_final, _ = refit_exposures_guarded(
        X, W, mask, H0=H, max_iterations=max_polish_iterations,
        tol=polish_tol, conv_test_freq=conv_test_freq,
        program_seconds=program_seconds,
    )
    del kl_dense  # the contract program re-evaluates it with the rest
    return _elimination_result(
        X, W, mask, H_final, H, H_dense, rel_tol, abs_tol, rounds
    )


@jax.jit
def _elimination_budget(X, W, H_dense, rel_tol, abs_tol):
    kl_dense = _kl(X, W, H_dense)
    return kl_dense, (1.0 + rel_tol) * kl_dense + abs_tol


def _finalize_contract(X, W, mask, H_final, H_accepted, H_dense,
                       rel_tol, abs_tol):
    """Close the acceptance contract IN ONE PROGRAM: every reported sample
    satisfies kl_sparse <= (1 + rel_tol) * kl_dense + abs_tol exactly.

    Accept decisions, the dense budget and the final KL historically ran
    in separate programs (or separate fusion regions of one program), and
    f32 reduction-order ulps let a handful of samples land a hair over
    budget in the REPORTED numbers. Here the budget and every
    candidate KL are evaluated together, each over-budget sample falls
    back down a chain that provably terminates within budget —
    polished result -> pre-polish accepted state (same support) -> dense
    full-support refit (whose KL IS kl_dense, <= budget since
    rel_tol, abs_tol >= 0) — and the reported kl_sparse is the SELECTED
    evaluation, not a re-evaluation that could drift by another ulp.

    Returns (mask_out, H_out, kl_dense, kl_sparse, n_active).
    """
    kl_dense = _kl(X, W, H_dense)
    budget = (1.0 + rel_tol) * kl_dense + abs_tol
    kl_fin = _kl(X, W, H_final)
    kl_acc = _kl(X, W, H_accepted)
    use_fin = kl_fin <= budget
    use_acc = (~use_fin) & (kl_acc <= budget)
    use_dense = ~(use_fin | use_acc)
    H_out = jnp.where(
        use_fin[None, :], H_final,
        jnp.where(use_acc[None, :], H_accepted, H_dense),
    )
    mask_out = jnp.where(use_dense[None, :], True, mask)
    kl_sparse = jnp.where(
        use_fin, kl_fin, jnp.where(use_acc, kl_acc, kl_dense)
    )
    return mask_out, H_out, kl_dense, kl_sparse, jnp.sum(mask_out, axis=0)


@jax.jit
def _elimination_result(X, W, mask, H_final, H_accepted, H_dense,
                        rel_tol, abs_tol, n_rounds):
    mask_out, H_out, kl_dense, kl_sparse, n_active = _finalize_contract(
        X, W, mask, H_final, H_accepted, H_dense, rel_tol, abs_tol
    )
    return {
        "mask": mask_out.astype(jnp.int32),
        "H": H_out,
        "kl_dense": kl_dense,
        "kl_sparse": kl_sparse,
        "n_rounds": jnp.asarray(n_rounds, jnp.int32),
        "n_active": n_active,
    }


@functools.partial(
    jax.jit, static_argnames=("candidate_iters", "polish_iterations",
                              "conv_test_freq", "max_polish_iterations")
)
def eliminate_signatures(
    X,
    W,
    rel_tol,
    abs_tol=0.0,
    candidate_iters: int = 50,
    polish_iterations: int = 200,
    max_polish_iterations: int = 10_000,
    conv_test_freq: int = 10,
    polish_tol=1e-7,
):
    """Greedy backward elimination of catalog signatures, per sample.

    Starting from the dense refit over the full catalog, each round tries
    removing every currently-active signature from every sample (a vmapped
    candidate axis), picks each sample's cheapest removal, and accepts it
    while the sample's KL stays within the budget

        kl <= (1 + rel_tol) * kl_dense + abs_tol

    i.e. the result is (greedily) the sparsest per-sample support whose fit
    is within ``rel_tol`` of the full-catalog refit. Samples freeze
    independently; the loop ends when all are frozen. Everything — the
    candidate refits, the argmin/gather accept step, the round loop — runs
    on device inside one compiled program.

    Args:
      X: (V, D) counts. W: (V, K) column-stochastic catalog.
      rel_tol / abs_tol: acceptance budget (traced; retune without recompile).
      candidate_iters: warm-started MU steps per candidate evaluation.
      polish_iterations: MU steps applied to the accepted state each round
        (keeps the warm start honest as the support shrinks).

    Returns dict with:
      mask: (K, D) bool final supports; H: (K, D) polished exposures;
      kl_dense / kl_sparse: (D,) per-sample KL before/after;
      n_rounds: scalar int; n_active: (D,) support sizes.
    """
    K = W.shape[1]
    dtype = jnp.result_type(X, W)
    X = X.astype(dtype)
    W = W.astype(dtype)

    mask0 = jnp.ones((K, X.shape[1]), dtype=bool)
    H_dense, _ = refit_exposures(
        X, W, mask0, max_iterations=max_polish_iterations, tol=polish_tol,
        conv_test_freq=conv_test_freq,
    )
    kl_dense = _kl(X, W, H_dense)
    budget = (1.0 + rel_tol) * kl_dense + abs_tol

    def candidate(k, mask, H):
        """Refit every sample with signature k removed; +inf where invalid."""
        m_k = mask.at[k, :].set(False)
        Hk = refit_exposures_fixed(X, W, m_k, jnp.where(m_k, H, 0.0),
                                   candidate_iters)
        kl = _kl(X, W, Hk)
        valid = mask[k, :] & (jnp.sum(mask, axis=0) > 1)
        return jnp.where(valid, kl, jnp.inf), Hk

    def cond(state):
        _, _, frozen, rounds = state
        return (~jnp.all(frozen)) & (rounds < K)

    def body(state):
        mask, H, frozen, rounds = state
        cand_kl, cand_H = jax.vmap(candidate, in_axes=(0, None, None))(
            jnp.arange(K), mask, H
        )
        k_star = jnp.argmin(cand_kl, axis=0)
        kl_star = jnp.min(cand_kl, axis=0)
        accept = (~frozen) & (kl_star <= budget)
        removal = (jnp.arange(K)[:, None] == k_star[None, :]) & accept[None, :]
        new_mask = mask & ~removal
        H_star = jnp.take_along_axis(cand_H, k_star[None, None, :], axis=0)[0]
        new_H = jnp.where(accept[None, :], H_star, H)
        new_H = refit_exposures_fixed(X, W, new_mask, new_H,
                                      polish_iterations)
        return new_mask, new_H, frozen | ~accept, rounds + 1

    init = (mask0, H_dense, jnp.zeros(X.shape[1], dtype=bool),
            jnp.asarray(0))
    mask, H, _, n_rounds = lax.while_loop(cond, body, init)

    H_final, _ = refit_exposures(
        X, W, mask, H0=H, max_iterations=max_polish_iterations,
        tol=polish_tol, conv_test_freq=conv_test_freq,
    )
    # same-program budget recheck: the reported per-sample KLs satisfy the
    # acceptance budget EXACTLY (fusion-ulp drift between the accept-time
    # and report-time evaluations otherwise leaves rare samples a hair
    # over; see _finalize_contract)
    mask_out, H_out, kl_dense_out, kl_sparse, n_active = _finalize_contract(
        X, W, mask, H_final, H, H_dense, rel_tol, abs_tol
    )
    return {
        # int32 twin of the boolean support; callers re-bool on host
        "mask": mask_out.astype(jnp.int32),
        "H": H_out,
        "kl_dense": kl_dense_out,
        "kl_sparse": kl_sparse,
        "n_rounds": n_rounds,
        "n_active": n_active,
    }


def resample_counts(X, key, n_resamples: int, method: str = "multinomial"):
    """Draw count-bootstrap resamples of a (V, D) count matrix on device.

    method:
      'multinomial' - per sample d, redraw Multinomial(round(n_d), X[:,d]/n_d)
        (the SigProfiler-style nonparametric count bootstrap; per-sample
        totals are preserved);
      'poisson' - X_b ~ Poisson(X), the parametric bootstrap under the
        model's own Poisson likelihood (samples' totals vary).

    Traceable (jit/vmap-safe). Returns (n_resamples, V, D) in X.dtype.
    Shared by ``bootstrap_refit`` (exposure CIs) and the de novo
    consensus-extraction pipeline (``salamander_tpu.extraction``).
    """
    V, D = X.shape
    if method == "multinomial":
        totals = jnp.round(jnp.sum(X, axis=0))          # (D,)
        probs = (X / jnp.sum(X, axis=0)).T              # (D, V)
        draws = jax.random.multinomial(
            key,
            jnp.broadcast_to(totals, (n_resamples, D)),
            jnp.broadcast_to(probs, (n_resamples, D, V)),
        )                                               # (B, D, V)
        return jnp.swapaxes(draws, -1, -2).astype(X.dtype)
    if method == "poisson":
        return jax.random.poisson(
            key, X, shape=(n_resamples, V, D)
        ).astype(X.dtype)
    raise ValueError(f"unknown bootstrap method {method!r}")


@functools.partial(
    jax.jit,
    static_argnames=("n_replicates", "method", "max_iterations",
                     "conv_test_freq"),
)
def bootstrap_refit(
    X,
    W,
    mask,
    key,
    n_replicates: int,
    method: str = "multinomial",
    max_iterations: int = 10_000,
    tol: float = 1e-7,
    conv_test_freq: int = 10,
):
    """Resample the cohort's counts and refit exposures, all replicates in
    ONE masked-MU program.

    X: (V, D) counts; W: (V, K) catalog; mask: (K, D) activity (tiled over
    replicates - pass all-ones for dense refits or an AssignmentResult's
    supports for sparse ones). method:
      'multinomial' - per sample d, redraw Multinomial(round(n_d), X[:,d]/n_d)
        (the SigProfiler-style nonparametric count bootstrap);
      'poisson' - X_b ~ Poisson(X), the parametric bootstrap under the
        model's own Poisson likelihood (samples' totals vary).
    Replicate b=0 is the ORIGINAL X (so callers get the point estimate and
    the resamples from one program). Returns H (B, K, D).
    """
    dtype = jnp.result_type(X, W)
    X = X.astype(dtype)
    W = W.astype(dtype)
    V, D = X.shape

    X_boot = resample_counts(X, key, n_replicates - 1, method)
    X_all = jnp.concatenate([X[None], X_boot], axis=0)  # (B, V, D)

    # one flat masked refit: replicates are independent columns
    X_flat = jnp.reshape(jnp.swapaxes(X_all, 0, 1), (V, n_replicates * D))
    mask_flat = jnp.tile(mask, (1, n_replicates))
    H_flat, _ = refit_exposures(
        X_flat, W, mask_flat, max_iterations=max_iterations, tol=tol,
        conv_test_freq=conv_test_freq,
    )
    K = W.shape[1]
    return jnp.swapaxes(jnp.reshape(H_flat, (K, n_replicates, D)), 0, 1)


@functools.partial(jax.jit, static_argnames=("n_replicates", "method"))
def _bootstrap_flatten(X, W, mask, key, n_replicates: int, method: str):
    """Resample + flatten phase of bootstrap_refit as its own program (the
    guarded driver refits the flat cohort through capped segments)."""
    dtype = jnp.result_type(X, W)
    X = X.astype(dtype)
    V, D = X.shape
    X_boot = resample_counts(X, key, n_replicates - 1, method)
    X_all = jnp.concatenate([X[None], X_boot], axis=0)
    X_flat = jnp.reshape(jnp.swapaxes(X_all, 0, 1), (V, n_replicates * D))
    return X_flat, jnp.tile(mask, (1, n_replicates))


def bootstrap_refit_guarded(
    X,
    W,
    mask,
    key,
    n_replicates: int,
    method: str = "multinomial",
    max_iterations: int = 10_000,
    tol: float = 1e-7,
    conv_test_freq: int = 10,
    program_seconds: float | None = None,
):
    """bootstrap_refit behind the program-duration guard: the resample/
    flatten runs as one short program and the flat (V, B*D) refit goes
    through refit_exposures_guarded's capped segments (a B-replicate
    refit multiplies the single-cohort program duration by B). Same math
    as bootstrap_refit; returns H (B, K, D)."""
    dtype = jnp.result_type(X, W)
    X = jnp.asarray(X, dtype)
    W = jnp.asarray(W, dtype)
    D = X.shape[1]
    X_flat, mask_flat = _bootstrap_flatten(
        X, W, mask, key, n_replicates, method
    )
    H_flat, _ = refit_exposures_guarded(
        X_flat, W, mask_flat, max_iterations=max_iterations, tol=tol,
        conv_test_freq=conv_test_freq, program_seconds=program_seconds,
    )
    K = W.shape[1]
    return _bootstrap_reshape(H_flat, K, n_replicates, D)


@functools.partial(jax.jit, static_argnames=("K", "n_replicates", "D"))
def _bootstrap_reshape(H_flat, K: int, n_replicates: int, D: int):
    return jnp.swapaxes(jnp.reshape(H_flat, (K, n_replicates, D)), 0, 1)

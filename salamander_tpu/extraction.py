"""De novo consensus signature extraction.

The field's headline discovery workflow (SigProfilerExtractor-style), which
the reference cannot express: resample the cohort's counts B times, factorize
every resample at every candidate rank, cluster the pooled signatures under a
one-per-replicate matching constraint, and report per-cluster silhouette
stability next to the consensus solution's reconstruction error — stability,
not loss, marks the true rank (past it, extra components fit replicate-
specific noise and their clusters collapse). The reference's own tutorial
runs plain restarts in a host Python for-loop (reference ``tutorial.ipynb``
cell 70) and has no resampling, clustering or consensus machinery at all;
its closest primitive is one ``fit(given_parameters={"asignatures": ...})``
refit (reference src/salamander/models/klnmf.py:83-121).

Device design — the whole discovery phase is THREE device programs:

1. ``ops.assign.resample_counts`` draws all B count resamples on device
   (multinomial per sample, SigProfiler's nonparametric bootstrap, or
   Poisson, the parametric one).
2. Every (rank, replicate) pair is a LANE of one K-padded lockstep fit:
   ``ops.klnmf.make_masked_step_functions`` lets rank-k lanes run exactly
   (padded H rows pinned at zero) inside a shared rank-``max(ranks)``
   program, so the entire rank range amortizes ONE XLA compilation, and
   every lane converges under the package's standard rule
   (``engine.make_fit_function(batched=True, batched_data=True)`` — each
   lane fits its own resampled counts).
3. Per-rank consensus exposures refit on the ORIGINAL counts through one
   shared K-padded ``ops.assign.refit_exposures`` program.

Only the clustering runs on host: it is Hungarian matching on (k x k)
cosine matrices, microseconds of scipy per replicate, and fetching the
(lanes, V, K) signature stack is ONE batched transfer
(``engine.transfer.fetch_pytree``).

Memory note: the lockstep fit materializes per-lane data,
``len(ranks) * n_bootstraps * V * D`` elements of the fit dtype. At PCAWG
scale (96 x 192, 9 ranks x 20 replicates) that is ~13 MB; at D = 200k it
is ~14 GB — beyond the ``max_lane_gb`` budget the lanes run as
consecutive equal chunks (one chunk's buffers resident at a time), with
results identical to the single-chunk call: lane draws are
(seed, rank, replicate)-keyed, so a lane never depends on its co-tenants.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from . import containers
from .device import memory_budget
from .engine import FitConfig, make_fit_function
from .engine.transfer import fetch_pytree
from .ops.assign import resample_counts
from .ops.klnmf import EPSILON, make_masked_step_functions

__all__ = ["ExtractionResult", "extract_signatures"]


# --------------------------------------------------------------------- #
# Device phase: resample -> lane init -> one masked lockstep fit
# --------------------------------------------------------------------- #


def _lane_init(key, X_lane, mask):
    """Random (W, H) init for one masked lane, on device.

    Mirrors initialization.methods.random_init_batch (Dirichlet signatures
    via normalized exponentials, Dirichlet exposures scaled to per-sample
    totals, EPSILON clips; reference initialization/methods.py:89-109
    semantics) restricted to the lane's active signatures: normalizing a
    subset of iid exponentials over that subset IS a Dirichlet of the
    subset's size, so a rank-k lane inside a rank-Kp program draws exactly
    a rank-k random init. Padded H rows are EXACT zero (the masked-step
    contract); padded W columns are inert and keep their draws.
    """
    dtype = X_lane.dtype
    n_padded = mask.shape[0]
    n_features, n_samples = X_lane.shape
    key_w, key_h = jax.random.split(key)
    # per-signature fold_in keys make a rank-k lane's draws independent of
    # the PADDED rank, so results are identical no matter which other ranks
    # share the compiled program (pinned by tests/test_extraction.py)
    signature_keys = jnp.arange(n_padded)
    draws_w = jax.vmap(
        lambda j: jax.random.exponential(
            jax.random.fold_in(key_w, j), (n_features,), dtype
        )
    )(signature_keys)
    W = (draws_w / jnp.sum(draws_w, axis=-1, keepdims=True)).T
    draws_h = jax.vmap(
        lambda j: jax.random.exponential(
            jax.random.fold_in(key_h, j), (n_samples,), dtype
        )
    )(signature_keys).T
    masked = jnp.where(mask[None, :], draws_h, 0.0)
    exposures = masked / jnp.sum(masked, axis=-1, keepdims=True)
    totals = jnp.sum(X_lane, axis=0)
    H = (exposures * totals[:, None]).T
    W = jnp.maximum(W, EPSILON)
    H = jnp.where(mask[:, None], jnp.maximum(H, EPSILON), 0.0)
    return W, H


# Keep all B bootstrap resamples resident when they fit in this budget
# (shared across lane chunks); beyond it they are regenerated per chunk so
# peak device memory stays at the old profile. Size on a 16 GiB device,
# scaled by device.memory_budget.
_BOOT_RESIDENT_BUDGET_BYTES = 2 * 1024**3


def _resample_all(X, key, n_bootstraps, method):
    """All B bootstrap resamples of the cohort, EPSILON-clipped (models
    clip counts to EPSILON at fit start, reference signature_nmf.py:269-281;
    replicate fits follow the same contract). Split out of _prepare_lanes
    so the driver can generate the resamples ONCE and share them across
    lane chunks: the multinomial draw is the expensive part at cohort
    scale, while the (B, V, D) result is only
    B x the cohort's own footprint."""
    X_boot = resample_counts(X, key, n_bootstraps, method)  # (B, V, D)
    return jnp.maximum(X_boot, EPSILON)


def _prepare_lanes(X_boot, key, lane_ranks, lane_replicates, n_padded,
                   with_gamma=False, W_given=None, n_given: int = 0):
    """Initialize every (rank, replicate) lane from the resampled counts.

    Returns (params0, data) for the masked lockstep fit. Lane keys are
    fold_in(fold_in(key, rank), replicate) with per-signature sub-keys in
    the init: a lane's draws depend only on (seed, rank, replicate) — never
    on which OTHER ranks share the call or how far the program is padded.
    Results are bitwise-reproducible across scans that share a padded rank;
    across different paddings they agree to fusion ulps only (XLA regroups
    reductions per contraction width — measured 1e-13 relative on f64 CPU;
    the same lesson as the package's cross-program equality pins).

    with_gamma adds the per-lane persistent line-search step the masked
    MvNMF update carries (reset to 1 per fit — reference mvnmf.py:212-218).

    W_given/n_given (semi-supervised extraction): the first n_given
    signature columns of EVERY lane are set to W_given and the masked step
    functions freeze them (reference given-signature semantics,
    src/salamander/models/_utils_klnmf.py update_W's n_given_signatures);
    lane_ranks count the NEW signatures, occupying columns
    [n_given : n_given + rank]. Given exposures (H rows [:n_given]) stay
    free and are drawn like any other active row.
    """
    X_lanes = X_boot[lane_replicates]                       # (L, V, D)
    masks = (
        (n_given + lane_ranks)[:, None] > jnp.arange(n_padded)[None, :]
    )
    lane_keys = jax.vmap(
        lambda k, b: jax.random.fold_in(jax.random.fold_in(key, k), b)
    )(lane_ranks, lane_replicates)
    W0, H0 = jax.vmap(_lane_init)(lane_keys, X_lanes, masks)
    if n_given:
        W0 = W0.at[:, :, :n_given].set(
            jnp.asarray(W_given, W0.dtype)[None, :, :]
        )
    params0 = {"W": W0, "H": H0, "mask": masks}
    if with_gamma:
        params0["gamma"] = jnp.ones((W0.shape[0],), X_boot.dtype)
    return params0, {"X": X_lanes}


# --------------------------------------------------------------------- #
# Host phase: Hungarian-constrained consensus clustering + silhouettes
# --------------------------------------------------------------------- #


def _unit_rows(stack):
    norms = np.linalg.norm(stack, axis=-1, keepdims=True)
    return stack / np.clip(norms, np.finfo(np.float64).tiny, None)


def _consensus_cluster(stack: np.ndarray, best_index: int,
                       max_iterations: int = 200):
    """Partition B x k pooled signatures into k clusters, one signature per
    replicate per cluster (the constraint that makes 'cluster j' mean 'the
    same signature rediscovered B times', not an arbitrary blob).

    stack: (B, k, V) row signatures. Alternates Hungarian matching of each
    replicate onto the centroids (cosine) with centroid re-estimation
    (normalized mean of matched members), seeded from the best-loss
    replicate; converges when the matching stops changing (k-means-style
    monotone objective over a finite assignment set).

    Returns (consensus (k, V) rows summing to 1, matched (B, k, V) raw
    signatures, permutations (B, k) lane->cluster, mean matched cosine to
    the consensus (k,)).
    """
    from scipy.optimize import linear_sum_assignment

    n_replicates, k, _ = stack.shape
    units = _unit_rows(stack.astype(np.float64))
    centroids = units[best_index]
    perms = np.tile(np.arange(k), (n_replicates, 1))
    for _ in range(max_iterations):
        new_perms = np.empty_like(perms)
        for b in range(n_replicates):
            sim = centroids @ units[b].T  # (cluster, signature)
            rows, cols = linear_sum_assignment(1.0 - sim)
            new_perms[b, rows] = cols
        matched_units = units[np.arange(n_replicates)[:, None], new_perms]
        centroids = _unit_rows(matched_units.mean(axis=0))
        if np.array_equal(new_perms, perms):
            break
        perms = new_perms
    matched = stack[np.arange(n_replicates)[:, None], perms]
    consensus = matched.mean(axis=0)
    consensus = consensus / consensus.sum(axis=-1, keepdims=True)
    cosines = np.einsum(
        "bkv,kv->bk", matched_units, _unit_rows(consensus)
    ).mean(axis=0)
    return consensus, matched, perms, cosines


def _cluster_silhouettes(matched: np.ndarray) -> np.ndarray:
    """Per-cluster mean silhouette under cosine distance.

    matched: (B, k, V) cluster-aligned signatures (cluster j = [:, j]).
    Standard silhouette: a(i) = mean distance to own cluster's other
    members, b(i) = smallest mean distance to another cluster,
    s = (b - a) / max(a, b). NaN when B < 2 or k < 2 (undefined, not
    perfect — mirrors tl.signature_stability's single-restart contract).
    """
    n_replicates, k, _ = matched.shape
    if n_replicates < 2 or k < 2:
        return np.full(k, np.nan)
    units = _unit_rows(matched.astype(np.float64))
    points = units.transpose(1, 0, 2).reshape(k * n_replicates, -1)
    distance = 1.0 - points @ points.T
    labels = np.repeat(np.arange(k), n_replicates)
    same = labels[:, None] == labels[None, :]
    a = np.sum(np.where(same, distance, 0.0), axis=1) / (n_replicates - 1)
    mean_to = np.empty((k * n_replicates, k))
    for j in range(k):
        mean_to[:, j] = distance[:, labels == j].mean(axis=1)
    mean_to[np.arange(k * n_replicates), labels] = np.inf  # own cluster out
    b = mean_to.min(axis=1)
    s = (b - a) / np.maximum(np.maximum(a, b), np.finfo(np.float64).tiny)
    return s.reshape(k, n_replicates).mean(axis=1)


# --------------------------------------------------------------------- #
# The pipeline
# --------------------------------------------------------------------- #


@dataclass
class ExtractionResult:
    """Everything the consensus-extraction pipeline learned.

    ``table`` is `pl.rank_selection`-compatible (index ``n_signatures``;
    ``best_loss`` = the consensus solution's KL on the ORIGINAL counts,
    ``mean_stability``/``min_stability`` = per-cluster silhouettes)."""

    table: pd.DataFrame
    consensus: dict[int, pd.DataFrame]       # rank -> (k, V) row signatures
    exposures: dict[int, pd.DataFrame]       # rank -> (D, k) consensus refit
    silhouettes: dict[int, np.ndarray]       # rank -> (k,) cluster silhouette
    matched: dict[int, np.ndarray]           # rank -> (B, k, V) cluster-
    # aligned replicate signatures (cluster j = [:, j, :])
    replicate_losses: dict[int, np.ndarray]  # rank -> (B,) final KL per lane
    replicate_iterations: dict[int, np.ndarray]  # rank -> (B,) MU iterations
    # each lane ran before its convergence test fired (diagnostic: ranks
    # whose lanes keep hitting max_iterations need a larger budget)
    suggested_rank: int | None
    model: Any = field(default=None)         # fitted KLNMF at the suggestion


def _suggest_rank(ranks, min_sil, min_stability: float,
                  rank_rule: str) -> int | None:
    """Rank decision from per-rank min cluster silhouettes (see the
    ``suggested_rank`` docs on extract_signatures). ``ranks``/``min_sil``
    are aligned arrays; NaN silhouettes (rank 1's single cluster, or
    n_bootstraps < 2) are skipped as unmeasurable. Warns and returns None
    instead of raising when no rank qualifies."""
    min_sil = np.asarray(min_sil, dtype=float)
    if np.isnan(min_sil).all():
        warnings.warn(
            "cluster silhouettes are undefined (n_bootstraps < 2 or "
            "rank 1 only) - no rank suggestion; inspect result.table",
            UserWarning,
        )
        return None
    # rank 1 has a single cluster (silhouette undefined); start at the
    # first rank where stability is measurable
    start = int(np.argmax(~np.isnan(min_sil)))
    passes = min_sil[start:] >= min_stability
    if rank_rule == "largest":
        if passes.any():
            return int(ranks[start:][np.where(passes)[0][-1]])
        warnings.warn(
            f"every scanned rank falls below min_stability="
            f"{min_stability} (best min silhouette "
            f"{np.nanmax(min_sil):.3f}) - no suggestion; add bootstraps, "
            "scan other ranks, or lower the threshold",
            UserWarning,
        )
        return None
    if not passes[0]:
        warnings.warn(
            f"even the smallest measurable rank ({int(ranks[start])}) "
            f"falls below min_stability={min_stability} "
            f"(min silhouette {min_sil[start]:.3f}) - no suggestion under "
            "rank_rule='prefix'; scan smaller ranks, add bootstraps, or "
            "lower the threshold",
            UserWarning,
        )
        return None
    prefix_end = int(np.argmin(passes)) - 1 if not passes.all() else -1
    return int(ranks[start:][prefix_end])


def extract_signatures(
    data,
    ranks,
    n_bootstraps: int = 20,
    resample_method: str = "multinomial",
    seed: int = 0,
    min_stability: float = 0.8,
    rank_rule: str = "largest",
    model: str = "klnmf",
    lam: float = 1.0,
    delta: float = 1.0,
    given_signatures=None,
    min_iterations: int = 500,
    max_iterations: int = 10_000,
    conv_test_freq: int = 10,
    tol: float = 1e-7,
    dtype=np.float32,
    fit_final: bool = True,
    mesh=None,
    compact: bool | None = None,
    max_lane_gb: float | None = None,
    checkpoint_dir=None,
) -> ExtractionResult:
    """De novo consensus signature extraction over a rank range.

    data: AnnData-like or samples-x-features DataFrame of counts.
    ranks: candidate signature counts (e.g. ``range(2, 11)``).
    n_bootstraps: count resamples per rank (``resample_method``:
    'multinomial' preserves per-sample totals, 'poisson' is the parametric
    bootstrap). Each (rank, replicate) pair fits de novo under the chosen
    family's update rule with a fresh seeded Dirichlet init, all lanes in
    ONE K-padded device program; per-rank pooled signatures are
    consensus-clustered and scored by silhouette (see module docstring).

    model: 'klnmf' (plain KL multiplicative updates, the field-standard
    discovery family) or 'mvnmf' (minimum-volume NMF — ``lam``/``delta``
    as on ``models.MvNMF``; the volume penalty shrinks the signature
    simplex, which identifies signatures plain NMF can only recover up to
    a cone). The consensus-exposure refit on the original counts is the
    KL subproblem for BOTH families (the volume penalty touches only W,
    which the refit holds fixed); 'mvnmf' lane losses and ``best_loss``
    are the penalized objective KL + lam*logdet(W^T W + delta I).

    given_signatures (semi-supervised extraction): known signatures (a
    signatures-x-features DataFrame/AnnData, e.g. COSMIC rows already
    assigned to the cohort) that every lane carries FROZEN in its leading
    columns — the reference's given-signature concept
    (src/salamander/models/_utils_klnmf.py update_W n_given_signatures)
    lifted into the discovery pipeline: ``ranks`` then counts the NEW
    signatures discovered on top of the given ones (each lane fits
    n_given + rank total; given exposures stay free). Consensus
    clustering, silhouettes and the rank decision run on the NEW
    signatures only (the given ones are identical across replicates by
    construction); ``consensus``/``exposures`` frames carry given + new
    (given names first, new names rolled past any collisions), and
    ``fit_final`` fits n_given + suggested total signatures.

    suggested_rank: under ``rank_rule='largest'`` (default, the
    SigProfilerExtractor-style decision) it is the LARGEST scanned rank
    whose min cluster silhouette stays >= ``min_stability``. Smaller
    ranks are allowed to be unstable: when the data carry k
    well-separated processes, under-rank factorizations merge them
    differently across bootstrap replicates, so instability BELOW the
    true rank is the expected signature of resolvable structure (e.g.
    planted k=5 at D=200k scores 1.000 at rank 5 with every other rank
    unstable). ``rank_rule='prefix'`` is the conservative alternative
    (tl.suggest_rank semantics): the largest rank reachable from the
    smallest scanned rank through consecutively stable ranks — use it
    when an isolated high-rank pass above a long unstable run should
    read as noise. When no rank qualifies, ``suggested_rank`` is None
    and a warning points at the table — after minutes of device compute
    you get the evidence, not an exception.

    With ``fit_final=True`` the suggested rank's consensus signatures are
    refit on the full data as a ``models.KLNMF`` with
    ``given_parameters={"asignatures": ...}`` (exposure-only fit, W frozen
    — reference src/salamander/models/klnmf.py:83-121 semantics), so the
    winner exposes the complete model surface (plots, transform, io).

    ``mesh``: a ``parallel.make_mesh()`` (restarts, samples) mesh shards the
    discovery fit — (rank, replicate) lanes over the restart axis (purely
    data-parallel) and each lane's sample axis over the sample axis (the
    W-update numerators and objectives all-reduce over it). Requires
    ``len(ranks) * n_bootstraps`` divisible by the mesh's restart ways and
    n_samples by its sample ways. The host clustering and the (cheap)
    consensus refit stay as-is; sharded results match unsharded to
    reduction-regrouping ulps.

    ``compact``: lane compaction for the discovery fit (None = on for
    every accelerator convergence fit, sharded or not — including below
    the halving threshold, where the compacting runner degenerates to the
    plain lockstep loop; its fori-loop blocks are also what keeps big-D
    lane programs inside device memory. Under a ``mesh`` the compacted lane counts
    stay multiples of the restart-axis device count). Lanes converge at
    wildly
    different iteration counts across ranks, so the uncompacted lockstep
    loop burns most of its FLOPs advancing frozen lanes; compaction halves
    the live batch as lanes finish, gathering each survivor's own bootstrap
    counts alongside its state. Bit-identical to ``compact=False`` on CPU;
    on an accelerator borderline lanes may stop at a neighboring convergence block
    (fusion ulps — the package-wide split-program lesson).

    ``max_lane_gb``: device-memory budget for the discovery fit's per-lane
    buffers (bootstrap counts + factors). Above it, lanes run as
    consecutive equal-size chunks — only one chunk's buffers are resident
    at a time, so cohorts whose full lane set exceeds device memory still
    extract on one device. None = a quarter of the device's memory on
    accelerators (device.memory_budget), unlimited on CPU.
    Chunked results are identical to unchunked (bitwise on CPU): lane
    draws are (seed, rank, replicate)-keyed, never co-tenant-dependent.
    Ignored under ``mesh`` (sharded lanes already spread across devices).

    ``checkpoint_dir``: preemption-safe resume. A cohort-scale extraction
    is minutes-to-hours of device compute across many programs (the
    reference has NO persistence anywhere — SURVEY.md section 5.4); with a
    checkpoint directory every completed discovery chunk and every
    completed per-rank consensus refit is written atomically as it
    finishes, and re-running with the SAME data and arguments skips
    straight past completed work (lane draws are (seed, rank, replicate)-
    keyed and the host clustering is deterministic, so the resumed run is
    the identical computation). A checkpoint written by a different run —
    different data fingerprint, arguments, or lane layout (the auto chunk
    size is backend-dependent, so resume on the backend that started the
    run) — is detected, warned about and discarded. Only the final
    ``fit_final`` refit is not checkpointed (it starts after all heavy
    phases complete). The directory stays on disk afterwards; delete it to
    reclaim space or reuse it for reruns of the same configuration.
    """
    from .assign import _extract_counts

    ranks = sorted({int(k) for k in ranks})
    if not ranks or ranks[0] < 1:
        raise ValueError(f"ranks must be positive integers, got {ranks!r}")
    if n_bootstraps < 1:
        raise ValueError("n_bootstraps must be >= 1")
    if model not in ("klnmf", "mvnmf"):
        raise ValueError(f"model must be 'klnmf' or 'mvnmf', got {model!r}")
    if rank_rule not in ("largest", "prefix"):
        raise ValueError(
            f"rank_rule must be 'largest' or 'prefix', got {rank_rule!r}"
        )
    X_host, obs_names, var_names = _extract_counts(data)  # (V, D)
    n_features, n_samples = X_host.shape
    W_given_host = None
    given_names: list[str] = []
    n_given = 0
    if given_signatures is not None:
        from .assign import _align_catalog

        W_given_host, given_names = _align_catalog(
            given_signatures, var_names
        )
        n_given = W_given_host.shape[1]
    n_padded = n_given + ranks[-1]
    if n_padded > n_samples or n_padded > n_features:
        raise ValueError(
            f"max total rank {n_padded} (n_given={n_given} + "
            f"max new rank {ranks[-1]}) exceeds the data's "
            f"min(n_samples, n_features) = {min(n_samples, n_features)}"
        )

    lane_ranks = np.repeat(ranks, n_bootstraps)
    lane_replicates = np.tile(np.arange(n_bootstraps), len(ranks))

    X = jnp.asarray(np.maximum(X_host, EPSILON), dtype=dtype)
    W_given = (
        None if W_given_host is None
        else jnp.asarray(W_given_host, dtype=dtype)
    )
    key = jax.random.PRNGKey(seed)
    resample = jax.jit(
        _resample_all, static_argnames=("n_bootstraps", "method")
    )
    prepare = jax.jit(
        _prepare_lanes,
        static_argnames=("n_padded", "with_gamma", "n_given"),
    )
    # Generate the B bootstrap resamples ONCE and share them across lane
    # chunks (same draws: same key, same op). The multinomial draw is the
    # expensive part at cohort scale; the (B, V, D) residency is bounded -
    # beyond the budget the old
    # per-chunk regeneration keeps peak memory unchanged.
    boot_bytes = n_bootstraps * X.size * X.dtype.itemsize
    X_boot_shared = (
        resample(X, key, n_bootstraps=n_bootstraps, method=resample_method)
        if boot_bytes <= memory_budget(_BOOT_RESIDENT_BUDGET_BYTES) else None
    )

    if model == "mvnmf":
        from .ops.mvnmf import make_masked_step_functions as _mv_masked

        update_fn, objective_fn = _mv_masked(
            lam, delta, n_given_signatures=n_given
        )
    else:
        update_fn, objective_fn = make_masked_step_functions(
            n_given_signatures=n_given
        )
    from .models.signature_nmf import promote_objective
    from .parallel.compaction import _cached_extraction_compacting_runner

    config = FitConfig(
        min_iterations=min_iterations, max_iterations=max_iterations,
        conv_test_freq=conv_test_freq, tol=tol,
    )

    n_lanes = len(lane_ranks)
    lane_spec = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from .parallel.mesh import RESTART_AXIS, SAMPLE_AXIS

        restart_ways = mesh.shape[RESTART_AXIS]
        sample_ways = mesh.shape[SAMPLE_AXIS]
        if n_lanes % restart_ways or n_samples % sample_ways:
            raise ValueError(
                f"mesh ({restart_ways} restart x {sample_ways} sample ways) "
                f"must divide the {n_lanes} lanes and {n_samples} samples"
            )

        def lane_spec(*trailing):
            return NamedSharding(mesh, PartitionSpec(RESTART_AXIS, *trailing))

        chunk_size = n_lanes  # sharded lanes already spread across devices
    else:
        if max_lane_gb is not None and max_lane_gb <= 0:
            raise ValueError("max_lane_gb must be positive")
        if max_lane_gb is None:
            budget = (
                memory_budget(4 * 2**30)
                if jax.default_backend() != "cpu" else None
            )
        else:
            budget = int(max_lane_gb * 2**30)
        if budget is None:
            chunk_size = n_lanes
        else:
            # per-lane residency during an MU block: the lane's bootstrap
            # counts PLUS the aux = X/(WH) quotient PLUS the materialized
            # WH product (three V x D buffers; +0.5 margin for fusion
            # slack), and the factor pairs twice (state + scatter target
            # in the compacting runner). An optimistic 2x model ran a
            # 45-lane chunk at D = 200k out of a 16 GiB device's memory.
            bytes_per_lane = np.dtype(dtype).itemsize * (
                3.5 * n_features * n_samples
                + 2 * n_padded * (n_features + n_samples)
            )
            n_chunks = max(
                1, int(-((n_lanes * bytes_per_lane) // -budget))
            )
            chunk_size = -(n_lanes // -n_chunks)

    if compact is None:
        # Accelerator lanes always run through the compacting runner,
        # even below the halving threshold (where it is the identical
        # lockstep loop with zero halvings): its fori-loop blocks avoid
        # the monolithic engine's unrolled-block temporaries at big D.
        # Under a mesh the runner composes with the sharded lane axis
        # (compacted lane counts stay multiples of the restart-axis
        # device count).
        use_runner = (
            config.min_iterations < config.max_iterations
            and jax.default_backend() != "cpu"
        )
    else:
        use_runner = bool(compact)

    ckpt = None
    if checkpoint_dir is not None:
        from .checkpoint import ChunkStore, data_fingerprint

        ckpt = ChunkStore(checkpoint_dir, {
            "pipeline": "extract_signatures",
            "format": 1,
            "data": data_fingerprint(X_host),
            "given": (None if W_given_host is None
                      else data_fingerprint(W_given_host)),
            "seed": int(seed),
            "ranks": [int(k) for k in ranks],
            "n_bootstraps": int(n_bootstraps),
            "resample_method": str(resample_method),
            "model": model,
            "lam": float(lam),
            "delta": float(delta),
            "min_iterations": int(min_iterations),
            "max_iterations": int(max_iterations),
            "conv_test_freq": int(conv_test_freq),
            "tol": float(tol),
            "dtype": np.dtype(dtype).name,
            "n_lanes": int(n_lanes),
            "chunk_size": int(chunk_size),
            "compact": bool(use_runner),
            "mesh": mesh is not None,
        })

    W_parts, loss_parts, iter_parts = [], [], []
    promoted = None
    for start in range(0, n_lanes, chunk_size):
        stop = min(start + chunk_size, n_lanes)
        if ckpt is not None:
            cached = ckpt.load(
                f"chunk_{start:06d}",
                match={"start": start, "stop": stop},
            )
            if cached is not None:
                W_parts.append(np.asarray(cached["W"]))
                loss_parts.append(np.asarray(cached["loss"]))
                iter_parts.append(np.asarray(cached["iterations"]))
                continue
        sl = slice(start, stop)
        X_boot = X_boot_shared
        if X_boot is None:  # beyond the residency budget: regenerate
            X_boot = resample(
                X, key, n_bootstraps=n_bootstraps, method=resample_method
            )
        params0, lane_data = prepare(
            X_boot, key, jnp.asarray(lane_ranks[sl]),
            jnp.asarray(lane_replicates[sl]),
            n_padded=n_padded, with_gamma=(model == "mvnmf"),
            W_given=W_given, n_given=n_given,
        )
        if lane_spec is not None:
            from .parallel.mesh import SAMPLE_AXIS

            param_specs = {
                "W": lane_spec(None, None),
                "H": lane_spec(None, SAMPLE_AXIS),
                "mask": lane_spec(None),
            }
            if "gamma" in params0:
                param_specs["gamma"] = lane_spec()
            params0 = jax.device_put(params0, param_specs)
            lane_data = jax.device_put(
                lane_data, {"X": lane_spec(None, SAMPLE_AXIS)}
            )
        if promoted is None:
            promoted = promote_objective(
                objective_fn, jax.tree.map(lambda leaf: leaf[0], params0)
            )
        if use_runner:
            from .parallel.compaction import mesh_restart_ways

            runner = _cached_extraction_compacting_runner(
                config, promoted is not objective_fn, 8,
                family=model, lam=lam, delta=delta, n_given=n_given,
                lane_multiple=mesh_restart_ways(mesh),
            )
            result, losses_device = runner.run(params0, lane_data)
        else:
            run = make_fit_function(
                update_fn, promoted, config, batched=True, batched_data=True,
            )
            result = run(params0, lane_data)
            losses_device = jax.jit(jax.vmap(promoted, in_axes=(0, 0)))(
                result.params, lane_data
            )
        W_c, loss_c, iter_c = fetch_pytree(
            (result.params["W"], losses_device, result.n_iterations)
        )
        W_parts.append(np.asarray(W_c))
        loss_parts.append(np.asarray(loss_c))
        iter_parts.append(np.asarray(iter_c))
        if ckpt is not None:
            ckpt.save(
                f"chunk_{start:06d}",
                match={"start": start, "stop": stop},
                W=W_c, loss=loss_c, iterations=iter_c,
            )
        # the fetch synchronized this chunk; dropping the references frees
        # its device buffers before the next chunk's prepare allocates
        del params0, lane_data, result, losses_device, X_boot

    X_boot_shared = None  # free the resamples before the consensus refit
    W_lanes = np.concatenate(W_parts, axis=0)  # (L, V, Kp)
    losses = np.concatenate(loss_parts, axis=0)
    lane_iterations = np.concatenate(iter_parts, axis=0)

    # one shared K-padded refit program evaluates every rank's consensus
    # on the ORIGINAL counts (padded mask rows are inactive -> exact
    # rank-k) through refit_exposures_guarded, which runs the one shared
    # monolithic program unless a program-seconds budget is set (then big
    # refits run as capped segments; ops/assign.py)
    from .ops.assign import refit_exposures_guarded as refit

    rows = []
    consensus_by_rank: dict[int, pd.DataFrame] = {}
    exposures_by_rank: dict[int, pd.DataFrame] = {}
    silhouettes: dict[int, np.ndarray] = {}
    matched_by_rank: dict[int, np.ndarray] = {}
    losses_by_rank: dict[int, np.ndarray] = {}
    iterations_by_rank: dict[int, np.ndarray] = {}
    X64 = np.asarray(X_host, dtype=np.float64)
    norm_X = np.linalg.norm(X64)
    for rank in ranks:
        total = n_given + rank
        lanes = lane_ranks == rank
        # consensus-cluster the NEW signatures only: the given columns are
        # frozen identical across replicates, so they carry no stability
        # signal (and would trivially inflate silhouettes)
        stack = np.transpose(
            W_lanes[lanes][:, :, n_given:total], (0, 2, 1)
        )
        lane_losses = losses[lanes]
        consensus, matched, _, _ = _consensus_cluster(
            stack, int(np.argmin(lane_losses))
        )
        silhouette = _cluster_silhouettes(matched)

        H = None
        if ckpt is not None:
            # the cached refit counts only if it was computed from EXACTLY
            # this consensus (the clustering is deterministic host math, so
            # a resumed run reproduces it bit-for-bit from restored chunks)
            cached = ckpt.load(
                f"rank_{rank:03d}", match={"consensus": consensus}
            )
            if cached is not None:
                H = np.asarray(cached["H"], dtype=np.float64)
        if H is None:
            W_pad = np.full((n_features, n_padded), 1.0 / n_features)
            if n_given:
                W_pad[:, :n_given] = W_given_host
            W_pad[:, n_given:total] = consensus.T
            mask2d = jnp.asarray(
                np.arange(n_padded)[:, None] < np.full((1, n_samples), total)
            )
            H_pad, _ = refit(
                X, jnp.asarray(W_pad, dtype=dtype), mask2d,
                max_iterations=max_iterations, tol=tol,
                conv_test_freq=conv_test_freq,
            )
            H = np.asarray(H_pad, dtype=np.float64)[:total]  # (G + k, D)
            if ckpt is not None:
                ckpt.save(
                    f"rank_{rank:03d}", match={"consensus": consensus}, H=H
                )
        if n_given:
            W_full = np.concatenate(
                [np.asarray(W_given_host, np.float64),
                 consensus.T.astype(np.float64)], axis=1
            )  # (V, G + k)
        else:
            W_full = consensus.T.astype(np.float64)
        recon = W_full @ H                              # (V, D)
        positive = X64 > 0
        consensus_kl = float(
            np.sum(X64[positive] * np.log(X64[positive] / recon[positive]))
            - X64.sum() + recon.sum()
        )
        cos = np.sum(X64 * recon, axis=0) / np.maximum(
            np.linalg.norm(X64, axis=0) * np.linalg.norm(recon, axis=0),
            np.finfo(np.float64).tiny,
        )
        best_loss = consensus_kl
        if model == "mvnmf":
            # volume penalty over the FULL signature matrix (given + new),
            # matching what the lanes minimized
            _, logdet = np.linalg.slogdet(
                W_full.T @ W_full + delta * np.eye(total)
            )
            best_loss = consensus_kl + lam * logdet
        # new signature names roll past any collision with the given names
        # (reference initialize_base name-rolling semantics)
        new_names: list[str] = []
        existing = set(given_names)
        j = 1
        while len(new_names) < rank:
            candidate = f"Sig{j}"
            if candidate not in existing:
                new_names.append(candidate)
            j += 1
        names = given_names + new_names
        consensus_by_rank[rank] = pd.DataFrame(
            W_full.T, index=names, columns=var_names
        )
        exposures_by_rank[rank] = pd.DataFrame(
            H.T, index=obs_names, columns=names
        )
        silhouettes[rank] = silhouette
        matched_by_rank[rank] = matched
        losses_by_rank[rank] = lane_losses
        iterations_by_rank[rank] = lane_iterations[lanes]
        rows.append({
            "n_signatures": rank,
            "best_loss": best_loss,
            "mean_stability": float(np.mean(silhouette)),
            "min_stability": float(np.min(silhouette)),
            "mean_sample_cosine": float(np.mean(cos)),
            "relative_error": float(np.linalg.norm(X64 - recon) / norm_X),
            "mean_replicate_loss": float(np.mean(lane_losses)),
        })
    table = pd.DataFrame(rows).set_index("n_signatures")

    suggested = _suggest_rank(
        np.asarray(table.index), table["min_stability"].to_numpy(),
        min_stability, rank_rule,
    )

    fitted = None
    if fit_final and suggested is not None:
        from .models import KLNMF, MvNMF

        asignatures = containers.AnnData(consensus_by_rank[suggested])
        adata = containers.AnnData(
            pd.DataFrame(X_host.T, index=obs_names, columns=var_names)
        )
        shared_kwargs = dict(
            n_signatures=n_given + suggested,
            min_iterations=min_iterations, max_iterations=max_iterations,
            conv_test_freq=conv_test_freq, tol=tol,
            dtype=np.dtype(dtype).name,
        )
        if model == "mvnmf":
            fitted = MvNMF(lam=lam, delta=delta, **shared_kwargs)
        else:
            fitted = KLNMF(**shared_kwargs)
        fitted.fit(
            adata,
            given_parameters={"asignatures": asignatures},
            init_kwargs={"seed": seed},
        )

    return ExtractionResult(
        table=table,
        consensus=consensus_by_rank,
        exposures=exposures_by_rank,
        silhouettes=silhouettes,
        matched=matched_by_rank,
        replicate_losses=losses_by_rank,
        replicate_iterations=iterations_by_rank,
        suggested_rank=suggested,
        model=fitted,
    )

"""Signature assignment: refit a cohort's exposures against a FIXED,
known signature catalog (e.g. COSMIC), densely or sparsely.

The reference covers the dense case only, one model at a time, via
``fit(given_parameters={"asignatures": ...})`` (reference
src/salamander/models/klnmf.py:83-121); the sparse per-sample support
search is the job of external host-loop tools (SigProfilerAssignment).
Here both are single batched device programs (ops/assign.py): the dense
refit is one masked MU solve over the whole cohort, and the sparse search
is greedy backward elimination with all (sample, candidate-removal) pairs
evaluated as one vmapped lane axis per round, zero host round-trips.

Typical use::

    catalog = sal.datasets.load_cosmic_sbs_catalog()   # signatures x 96
    res = sal.assign_signatures(adata, catalog, rel_tol=0.02)
    res.exposures     # samples x signatures, exact zeros off-support
    res.active        # bool samples x signatures
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from .device import memory_budget
from .engine.transfer import fetch_pytree
from .ops import assign as ops
from .ops.klnmf import EPSILON

__all__ = [
    "AssignmentResult",
    "BootstrapExposuresResult",
    "assign_exposures",
    "assign_signatures",
    "bootstrap_exposures",
]


def _extract_counts(data) -> tuple[np.ndarray, pd.Index, pd.Index]:
    """Counts as (V, D) float plus (obs_names, var_names).

    Accepts the package/scverse AnnData duck type (samples x features) or
    a samples-x-features DataFrame. The input is never modified.
    """
    if hasattr(data, "obsm") and hasattr(data, "X"):
        X = np.asarray(data.X, dtype=np.float64)
        return X.T.copy(), pd.Index(data.obs_names), pd.Index(data.var_names)
    if isinstance(data, pd.DataFrame):
        return (
            data.to_numpy(dtype=np.float64).T.copy(),
            pd.Index(data.index.astype(str)),
            pd.Index(data.columns.astype(str)),
        )
    raise TypeError(
        "data must be an AnnData-like container or a samples-x-features "
        f"DataFrame, got {type(data).__name__}."
    )


def _align_catalog(catalog, var_names: pd.Index) -> tuple[np.ndarray, list[str]]:
    """Catalog -> column-stochastic W (V, K) aligned to the data's feature
    order, plus signature names.

    Accepts a signatures-x-features DataFrame (the datasets loader
    convention), a features-x-signatures DataFrame (auto-detected via the
    index), or an AnnData-like of signatures. Features must match the
    data's as a set; order is realigned here. Columns are EPSILON-floored
    and renormalized to sum one (the package-wide signature convention).
    """
    if hasattr(catalog, "obsm") and hasattr(catalog, "X"):
        catalog = pd.DataFrame(
            np.asarray(catalog.X),
            index=pd.Index(catalog.obs_names),
            columns=pd.Index(catalog.var_names),
        )
    if not isinstance(catalog, pd.DataFrame):
        raise TypeError(
            "catalog must be a DataFrame or an AnnData-like of signatures, "
            f"got {type(catalog).__name__}."
        )
    features = set(var_names)
    if set(catalog.columns.astype(str)) == features:
        frame = catalog
    elif set(catalog.index.astype(str)) == features:
        frame = catalog.T
    else:
        raise ValueError(
            "catalog features do not match the data's var_names: "
            f"{len(features)} data features, catalog is "
            f"{catalog.shape[0]} x {catalog.shape[1]}."
        )
    frame = frame.loc[:, var_names]
    W = np.maximum(frame.to_numpy(dtype=np.float64).T, EPSILON)
    W = W / W.sum(axis=0, keepdims=True)
    return W, [str(name) for name in frame.index]


def _sample_putter(mesh):
    """(put2d, sample_ways) for sharding (·, D) arrays over the mesh's
    sample axis. Samples are mathematically independent in every assignment
    problem (each sample's support search and exposure column depend only on
    its own counts), so sample sharding is pure data parallelism: the only
    collectives XLA inserts are the aggregated convergence-test sums.
    mesh=None returns a plain device put (single-device semantics)."""
    if mesh is None:
        return (lambda arr: jnp.asarray(arr)), 1
    from jax.sharding import NamedSharding, PartitionSpec

    from .parallel.mesh import SAMPLE_AXIS

    ways = mesh.shape[SAMPLE_AXIS]
    sharding = NamedSharding(mesh, PartitionSpec(None, SAMPLE_AXIS))

    def put2d(arr):
        arr = np.asarray(arr)
        if arr.shape[-1] % ways:
            raise ValueError(
                f"the sample axis ({arr.shape[-1]}) must divide the mesh's "
                f"{ways} sample ways; pass a batch_size that is a multiple "
                f"of {ways} or pad the cohort"
            )
        return jax.device_put(arr, sharding)

    return put2d, ways


def _replicated(mesh, arr):
    if mesh is None:
        return jnp.asarray(arr)
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(
        np.asarray(arr), NamedSharding(mesh, PartitionSpec())
    )


@dataclass
class AssignmentResult:
    """Sparse catalog assignment of a cohort.

    exposures: (samples x signatures) refit exposures, exact zeros off the
      per-sample support. active: bool (samples x signatures) supports.
    kl_dense / kl_sparse: per-sample KL of the full-catalog refit vs the
      sparse one. n_active: per-sample support sizes.
    """

    exposures: pd.DataFrame
    active: pd.DataFrame
    kl_dense: pd.Series
    kl_sparse: pd.Series
    n_active: pd.Series
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def signature_names(self) -> list[str]:
        return list(self.exposures.columns)

    def assigned_signatures(self) -> list[str]:
        """Catalog signatures active in at least one sample."""
        return list(self.active.columns[self.active.to_numpy().any(axis=0)])


def assign_exposures(data, catalog, max_iterations: int = 10_000,
                     tol: float = 1e-7, mesh=None) -> pd.DataFrame:
    """Dense catalog refit: exposures for every sample over the FULL
    catalog (all signatures active), KLNMF H-updates to convergence.

    One batched device program for the whole cohort. Equivalent to the
    reference's fit(given_parameters={'asignatures': catalog}) exposures,
    without learning anything. Returns a samples x signatures DataFrame.

    ``mesh``: a ``parallel.make_mesh()`` shards the cohort's sample axis
    across devices (n_samples must divide the mesh's sample ways) — pure
    data parallelism; only the aggregated convergence sums all-reduce.
    """
    X, obs_names, var_names = _extract_counts(data)
    W, sig_names = _align_catalog(catalog, var_names)
    put2d, _ = _sample_putter(mesh)
    mask = put2d(np.ones((W.shape[1], X.shape[1]), dtype=bool))
    # guarded: under a program-seconds budget big-D refits run as capped
    # segments; otherwise (the default) this is one program
    H, _ = ops.refit_exposures_guarded(
        put2d(X), _replicated(mesh, W), mask,
        max_iterations=max_iterations, tol=tol,
    )
    return pd.DataFrame(
        fetch_pytree(H).T, index=obs_names, columns=sig_names
    )


def assign_signatures(
    data,
    catalog,
    rel_tol: float = 0.02,
    abs_tol: float = 0.0,
    candidate_iters: int = 50,
    polish_iterations: int = 200,
    max_iterations: int = 10_000,
    tol: float = 1e-7,
    batch_size: int | None = None,
    mesh=None,
    checkpoint_dir=None,
) -> AssignmentResult:
    """Sparse per-sample signature assignment against a fixed catalog.

    Greedy backward elimination from the dense refit: each sample keeps
    the (greedily) smallest signature subset whose KL stays within
    ``(1 + rel_tol) * kl_dense + abs_tol`` of its full-catalog refit.
    All samples and all candidate removals evaluate in parallel on device
    (ops/assign.py:eliminate_signatures).

    ``batch_size`` bounds device memory (the candidate tensor is
    O(K^2 * batch) floats): samples are processed in equal-shape chunks
    sharing one compiled program (the tail chunk is padded and trimmed).
    Samples are mathematically independent; the only chunking effect is
    that the convergence test aggregates the objective per chunk, so
    refits may stop a block earlier/later — results agree to the
    convergence tolerance, supports are identical in practice.

    Under a program-seconds budget (forced in tests through the
    parallel.compaction.PROGRAM_SECONDS_OVERRIDE hook; none by default),
    batch_size=None
    additionally auto-chunks so one elimination ROUND's modeled duration
    fits the budget, and the search runs host-driven - one program per
    round, capped segments for the dense/final refits (ops/assign.py
    eliminate_signatures_guarded) - instead of as one monolithic program.
    Accepted supports honor the KL budget to float roundoff: removals are
    accepted inside one program and the final per-sample KL is recomputed
    in another, so on f32 accelerators borderline samples can exceed the
    budget by cross-program reduction-regrouping ulps.

    ``mesh``: a ``parallel.make_mesh()`` shards each chunk's sample axis
    over the mesh's sample ways (chunk widths must divide the ways —
    ``batch_size`` is rounded up to a multiple automatically). Samples are
    independent, so this is pure data parallelism: every (sample,
    candidate-removal) lane stays device-local and only the aggregated
    convergence sums all-reduce. Sharded supports match unsharded exactly
    on CPU; on an accelerator borderline samples may differ within the acceptance
    budget (reduction-regrouping ulps, the package-wide split-program
    lesson).

    ``checkpoint_dir``: preemption-safe resume (checkpoint.ChunkStore).
    Cohort-scale assignment is minutes of device compute across many
    sample chunks; every completed chunk's result is written atomically as
    it finishes, and re-running with the same data and arguments (and the
    same backend chunk layout) skips past completed chunks. A store from
    a different run is warned about and discarded.
    """
    X, obs_names, var_names = _extract_counts(data)
    W, sig_names = _align_catalog(catalog, var_names)
    V, D = X.shape
    K = W.shape[1]
    put2d, sample_ways = _sample_putter(mesh)
    W_dev = _replicated(mesh, W)

    budget = ops._program_budget(None)
    use_guarded = False
    if budget is not None:
        from .parallel.compaction import _MODEL_BYTES_PER_SECOND

        itemsize = np.result_type(X, W).itemsize
        per_sample_iter_bytes = 3.5 * itemsize * (V + 2 * K)
        round_iters = K * candidate_iters + polish_iterations
        # monolithic worst case: K rounds + the dense/final refits, all in
        # ONE program (the same pessimistic bytes model as the engine's
        # CappedFitDispatcher, with the same 2x slack)
        size = D if batch_size is None else min(D, int(batch_size))
        est = (
            (K * round_iters + 2 * max_iterations)
            * per_sample_iter_bytes * size / _MODEL_BYTES_PER_SECOND
        )
        use_guarded = est > 2.0 * budget
        if use_guarded and batch_size is None:
            per_sample_round_bytes = round_iters * per_sample_iter_bytes
            b_time = int(
                budget * _MODEL_BYTES_PER_SECOND / per_sample_round_bytes
            )
            # the vmapped candidate axis holds (K, K, B) exposures twice
            b_mem = int(memory_budget(4 * 2**30)
                        / (2.5 * itemsize * K * K))
            batch_size = min(D, max(64, min(b_time, b_mem)))
    if batch_size is not None and batch_size % sample_ways:
        batch_size += sample_ways - batch_size % sample_ways

    store = None
    if checkpoint_dir is not None:
        from .checkpoint import ChunkStore, data_fingerprint

        store = ChunkStore(checkpoint_dir, {
            "pipeline": "assign_signatures",
            "format": 1,
            "data": data_fingerprint(X, W),
            "rel_tol": float(rel_tol),
            "abs_tol": float(abs_tol),
            "candidate_iters": int(candidate_iters),
            "polish_iterations": int(polish_iterations),
            "max_iterations": int(max_iterations),
            "tol": float(tol),
            "batch_size": None if batch_size is None else int(batch_size),
            "use_guarded": bool(use_guarded),
            "mesh": mesh is not None,
        })

    def run(chunk: np.ndarray) -> dict[str, np.ndarray]:
        if use_guarded:
            out = ops.eliminate_signatures_guarded(
                put2d(chunk), W_dev, rel_tol, abs_tol,
                candidate_iters=candidate_iters,
                polish_iterations=polish_iterations,
                max_polish_iterations=max_iterations,
                polish_tol=tol,
            )
        else:
            out = ops.eliminate_signatures(
                put2d(chunk), W_dev, rel_tol, abs_tol,
                candidate_iters=candidate_iters,
                polish_iterations=polish_iterations,
                max_polish_iterations=max_iterations,
                polish_tol=tol,
            )
        out = dict(out)
        n_rounds = out.pop("n_rounds")
        fetched = fetch_pytree(out)
        fetched["n_rounds"] = int(n_rounds)
        return fetched

    width = D if batch_size is None or batch_size >= D else batch_size
    parts = []
    for start in range(0, D, width):
        stop = min(start + width, D)
        name = f"chunk_{start:08d}"
        if store is not None:
            cached = store.load(name, match={"start": start, "stop": stop})
            if cached is not None:
                cached["n_rounds"] = int(cached["n_rounds"])
                parts.append(cached)
                continue
        chunk = X[:, start:stop]
        pad = width - chunk.shape[1]
        if pad:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[:, :1], pad, axis=1)], axis=1
            )
        out = run(chunk)
        if pad:
            out = {
                key: value[..., :-pad] if np.ndim(value) else value
                for key, value in out.items()
            }
        if store is not None:
            store.save(name, match={"start": start, "stop": stop}, **out)
        parts.append(out)

    def cat(key):
        return np.concatenate([part[key] for part in parts], axis=-1)

    active = cat("mask").astype(bool)
    return AssignmentResult(
        exposures=pd.DataFrame(cat("H").T, index=obs_names, columns=sig_names),
        active=pd.DataFrame(active.T, index=obs_names, columns=sig_names),
        kl_dense=pd.Series(cat("kl_dense"), index=obs_names, name="kl_dense"),
        kl_sparse=pd.Series(cat("kl_sparse"), index=obs_names,
                            name="kl_sparse"),
        n_active=pd.Series(cat("n_active"), index=obs_names, name="n_active"),
        meta={
            "rel_tol": rel_tol,
            "abs_tol": abs_tol,
            "candidate_iters": candidate_iters,
            "n_rounds": max(part["n_rounds"] for part in parts),
        },
    )


@dataclass
class BootstrapExposuresResult:
    """Bootstrap uncertainty of catalog-refit exposures.

    mean/std: (samples x signatures) over replicates (replicate 0, the
    point estimate on the original counts, is excluded from the moments).
    quantiles: {q: DataFrame} over replicates. presence: P(relative
    exposure >= min_fraction) per (sample, signature). point: the
    original-counts refit.
    """

    point: pd.DataFrame
    mean: pd.DataFrame
    std: pd.DataFrame
    quantiles: dict[float, pd.DataFrame]
    presence: pd.DataFrame
    meta: dict[str, Any] = field(default_factory=dict)


def bootstrap_exposures(
    data,
    catalog,
    n_replicates: int = 200,
    seed: int = 0,
    method: str = "multinomial",
    quantiles: tuple[float, ...] = (0.05, 0.5, 0.95),
    min_fraction: float = 0.05,
    active=None,
    max_iterations: int = 10_000,
    tol: float = 1e-7,
    replicate_batch: int | None = None,
    mesh=None,
    checkpoint_dir=None,
) -> BootstrapExposuresResult:
    """Uncertainty of catalog-refit exposures by count bootstrap.

    Resamples every sample's counts ``n_replicates - 1`` times
    ('multinomial': redraw each sample's total over features, the
    SigProfiler-style nonparametric bootstrap; 'poisson': X_b ~ Poisson(X),
    the parametric bootstrap under the model's own likelihood) and refits
    exposures against the FIXED catalog - ALL replicates and samples as
    one batched device program per replicate chunk (ops/assign.py
    bootstrap_refit), no host loops.

    ``active`` restricts each sample to a support (bool samples x
    signatures DataFrame/array, e.g. ``AssignmentResult.active``): the
    bootstrap then quantifies uncertainty of the SPARSE assignment's
    exposures; off-support entries are exact zeros in every replicate.

    ``replicate_batch`` bounds device memory (the resampled tensor is
    (B, V, D) floats): replicates run in equal-size chunks sharing one
    compiled program. Chunking never changes results beyond the usual
    convergence-tolerance noise (each chunk's refit convergence aggregates
    its own columns).

    Returns a BootstrapExposuresResult; `presence` is the fraction of
    replicates where a signature carries at least ``min_fraction`` of the
    sample's exposure mass - a direct "is this signature really there"
    probability.

    ``mesh``: shards the cohort's sample axis over the mesh's sample ways
    (n_samples must divide the ways); resampling and every replicate's
    refit column are sample-local, so the flat (V, B*D) refit partitions
    cleanly and only the aggregated convergence sums all-reduce.

    ``checkpoint_dir``: preemption-safe resume — every completed replicate
    chunk's exposures are written atomically; re-running with the same
    data/arguments (and chunk layout) resumes past them. ``quantiles`` and
    ``min_fraction`` are host post-processing and deliberately NOT part of
    the store's identity: rerun with different summaries at zero device
    cost.
    """
    X, obs_names, var_names = _extract_counts(data)
    W, sig_names = _align_catalog(catalog, var_names)
    K, D = W.shape[1], X.shape[1]
    if n_replicates < 2:
        raise ValueError("n_replicates must be >= 2")

    if active is None:
        mask = np.ones((K, D), dtype=bool)
    else:
        mask_arr = (
            active.to_numpy() if hasattr(active, "to_numpy")
            else np.asarray(active)
        )
        if mask_arr.shape != (D, K):
            raise ValueError(
                f"active must be (n_samples, n_signatures) = ({D}, {K}), "
                f"got {mask_arr.shape}"
            )
        mask = mask_arr.T.astype(bool)

    put2d, _ = _sample_putter(mesh)
    X_dev = put2d(X)
    W_dev = _replicated(mesh, W)
    mask_dev = put2d(mask)

    budget = ops._program_budget(None)
    if replicate_batch is None and budget is not None:
        # memory auto-chunk: the resample + flat-refit buffers hold
        # ~(X_boot, X_flat, H pair, aux) per replicate; keep one chunk's
        # residency under a quarter of the device (program DURATION is
        # handled separately by the guarded refit's capped segments)
        itemsize = np.result_type(X, W).itemsize
        per_rep = 3.5 * itemsize * D * (2 * X.shape[0] + 2 * K)
        replicate_batch = max(2, int(memory_budget(4 * 2**30) / per_rep))
    chunk = n_replicates if replicate_batch is None else int(replicate_batch)
    chunk = max(2, min(chunk, n_replicates))
    # each chunk runs one compiled program of batch `chunk`: replicate 0
    # of every chunk is the ORIGINAL X (kept once as the point estimate),
    # the other chunk-1 are fresh resamples under that chunk's key
    n_resamples = n_replicates - 1
    n_chunks = -(-n_resamples // (chunk - 1))
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)
    store = None
    if checkpoint_dir is not None:
        from .checkpoint import ChunkStore, data_fingerprint

        store = ChunkStore(checkpoint_dir, {
            "pipeline": "bootstrap_exposures",
            "format": 1,
            "data": data_fingerprint(X, W, mask),
            "n_replicates": int(n_replicates),
            "seed": int(seed),
            "method": str(method),
            "max_iterations": int(max_iterations),
            "tol": float(tol),
            "chunk": int(chunk),
            "mesh": mesh is not None,
        })
    point_H = None
    resamples_H = []
    got = 0
    refit = (ops.bootstrap_refit_guarded if budget is not None
             else ops.bootstrap_refit)
    for i in range(n_chunks):
        name = f"chunk_{i:06d}"
        cached = store.load(name) if store is not None else None
        if cached is not None:
            H = cached["H"]
        else:
            H = fetch_pytree(refit(
                X_dev, W_dev, mask_dev, keys[i], chunk, method=method,
                max_iterations=max_iterations, tol=tol,
            ))
            if store is not None:
                store.save(name, H=H)
        if point_H is None:
            point_H = H[:1]
        take = min(chunk - 1, n_resamples - got)
        resamples_H.append(H[1:1 + take])
        got += take
    H_all = np.concatenate([point_H] + resamples_H, axis=0)  # (B, K, D)
    E = np.swapaxes(H_all, 1, 2)                             # (B, D, K)
    # exact zeros stay exact zeros off-support by construction

    def frame(a):
        return pd.DataFrame(a, index=obs_names, columns=sig_names)

    resamples = E[1:]
    fractions = resamples / np.maximum(
        resamples.sum(axis=2, keepdims=True), EPSILON
    )
    return BootstrapExposuresResult(
        point=frame(E[0]),
        mean=frame(resamples.mean(axis=0)),
        std=frame(resamples.std(axis=0, ddof=1)),
        quantiles={
            float(q): frame(np.quantile(resamples, q, axis=0))
            for q in quantiles
        },
        presence=frame((fractions >= min_fraction).mean(axis=0)),
        meta={
            "n_replicates": n_replicates,
            "method": method,
            "seed": seed,
            "min_fraction": min_fraction,
            "sparse": active is not None,
        },
    )

"""Lane compaction (parallel/compaction.py): host-driven segment loop with
shrinking batches must reproduce the uncompacted lockstep fit exactly.

The invariant being pinned: a lane's trajectory never depends on its
co-tenants (frozen lanes are where-selected, batched contractions reduce
within a lane), so gathering survivors into a smaller batch mid-fit -
with finished passengers padding the bucket - changes wall time only.
Reference baseline: the reference fits restarts one at a time on the host
(models/signature_nmf.py:315-385), so per-lane independence is also what
ties both engines to its semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from salamander_tpu.engine import FitConfig, fit_loop_lockstep
from salamander_tpu.ops import klnmf as ops
from salamander_tpu.parallel import (
    fit_klnmf_restarts,
    fit_klnmf_restarts_compacting,
)
from salamander_tpu.parallel.compaction import CompactingRunner


def _counts(V=14, D=26, k=3, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(V), size=k).T
    H = rng.gamma(2.0, 40.0, size=(k, D))
    return rng.poisson(W @ H).astype(np.float64) + 1.0


# convergence-based: lanes finish at different blocks, so several
# compactions actually happen (min_bucket=2 drives 8 -> 4 -> 2)
CONFIG = FitConfig(min_iterations=20, max_iterations=3000,
                   conv_test_freq=10, tol=1e-6)


@pytest.mark.parametrize("n_restarts", [8, 7])  # odd R: 7 -> 3 schedule
def test_compacting_matches_plain_restarts(n_restarts):
    X = _counts()
    base = fit_klnmf_restarts(X, 3, n_restarts, seed=0, config=CONFIG)
    compact = fit_klnmf_restarts_compacting(
        X, 3, n_restarts, seed=0, config=CONFIG, min_bucket=2
    )
    # dispersion sanity: the test only exercises compaction if lanes
    # actually finish at different blocks
    assert len(np.unique(base.n_iterations)) > 1
    np.testing.assert_array_equal(compact.n_iterations, base.n_iterations)
    np.testing.assert_allclose(compact.losses, base.losses, rtol=1e-12)
    assert compact.best_index == base.best_index
    np.testing.assert_allclose(np.asarray(compact.W), np.asarray(base.W),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(compact.H), np.asarray(base.H),
                               rtol=1e-12)


def test_compacting_history_matches_lockstep():
    """Per-lane histories/n_evals (the audit trail) survive compaction."""
    X = jnp.asarray(_counts(seed=1), jnp.float32)
    update_fn, objective_fn = ops.make_step_functions()
    data = {"X": X}
    key = jax.random.PRNGKey(3)
    from salamander_tpu.initialization.methods import random_init_batch

    W0, H0 = random_init_batch(key, X, 3, 8, jnp.float32)
    params0 = {"W": W0, "H": H0}

    batched_objective = jax.vmap(objective_fn, in_axes=(0, None))
    batched_update = jax.vmap(update_fn, in_axes=(0, None))

    # data must ride as a jit ARGUMENT (as every real runner passes it):
    # closing over X bakes it in as a constant, and XLA's constant folding
    # produces ulp-different f32 objectives than the argument path -
    # enough to shift convergence blocks for borderline lanes
    def run(p, d):
        def block(params, steps):
            return jax.lax.fori_loop(
                0, steps, lambda _, q: batched_update(q, d), params
            )

        return fit_loop_lockstep(
            lambda q: batched_objective(q, d), p, CONFIG, block
        )

    baseline = jax.jit(run)(params0, data)

    def make_block_update(data, n_lanes):
        def block(params, steps):
            return jax.lax.fori_loop(
                0, steps, lambda _, q: batched_update(q, data), params
            )

        return block

    runner = CompactingRunner(CONFIG, objective_fn, make_block_update,
                              min_bucket=2)
    result, losses = runner.run(params0, data)
    np.testing.assert_array_equal(np.asarray(result.n_evals),
                                  np.asarray(baseline.n_evals))
    np.testing.assert_array_equal(np.asarray(result.n_iterations),
                                  np.asarray(baseline.n_iterations))
    np.testing.assert_allclose(np.asarray(result.history),
                               np.asarray(baseline.history), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(result.initial_objective),
                               np.asarray(baseline.initial_objective),
                               rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(losses),
        np.asarray(jax.jit(batched_objective)(baseline.params, data)),
        rtol=1e-6,  # separately-jitted final eval: f32 fusion-order ulps
    )


def test_compacting_degenerate_small_batch():
    """R <= min_bucket never compacts and still matches (single segment)."""
    X = _counts(seed=2)
    base = fit_klnmf_restarts(X, 2, 3, seed=5, config=CONFIG)
    compact = fit_klnmf_restarts_compacting(
        X, 2, 3, seed=5, config=CONFIG, min_bucket=16
    )
    np.testing.assert_array_equal(compact.n_iterations, base.n_iterations)
    np.testing.assert_allclose(compact.losses, base.losses, rtol=1e-12)


def test_compacting_fixed_schedule():
    """A fixed-length schedule (no lane finishes early) exercises the
    iteration-limit exit path: one segment, no compaction, equal results."""
    config = FitConfig(min_iterations=60, max_iterations=60,
                       conv_test_freq=10, tol=1e-6)
    X = _counts(seed=3)
    base = fit_klnmf_restarts(X, 3, 4, seed=1, config=config)
    compact = fit_klnmf_restarts_compacting(
        X, 3, 4, seed=1, config=config, min_bucket=2
    )
    np.testing.assert_array_equal(compact.n_iterations, base.n_iterations)
    np.testing.assert_allclose(compact.losses, base.losses, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(compact.W), np.asarray(base.W),
                               rtol=1e-12)


def test_rank_scan_klnmf_compact_matches():
    """compact=True through the K-padded rank scan (masked lanes) must not
    change any per-rank result. pad_ranks is pinned on BOTH sides: the
    None default resolves it against the compaction decision (per-rank
    programs under compaction), and cross-layout comparisons only agree
    to f32 contraction-width ulps, not bitwise."""
    from salamander_tpu.parallel import rank_scan_klnmf

    X = _counts(seed=6)
    base = rank_scan_klnmf(X, range(2, 5), n_restarts=6, seed=0,
                           config=CONFIG, rank_bucket=4,
                           pad_ranks=True)
    compact = rank_scan_klnmf(
        X, range(2, 5), n_restarts=6, seed=0, config=CONFIG, rank_bucket=4,
        pad_ranks=True, compact=True, compact_min_bucket=2,
    )
    for k in base:
        np.testing.assert_array_equal(compact[k].n_iterations,
                                      base[k].n_iterations)
        np.testing.assert_allclose(compact[k].losses, base[k].losses,
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(compact[k].W),
                                   np.asarray(base[k].W), rtol=1e-12)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_rank_scan_klnmf_compact_mesh_matches():
    """Compaction composes with meshes: a compacting sharded scan must
    reproduce the plain sharded scan rank for rank (the survivor gather
    lowers to collectives; compacted lane counts stay multiples of the
    restart-axis device count)."""
    from salamander_tpu.parallel import make_mesh, rank_scan_klnmf

    X = _counts(seed=7, D=32)
    mesh = make_mesh(jax.devices()[:8], sample_ways=2)  # 4 restart ways
    base = rank_scan_klnmf(
        X, range(2, 4), n_restarts=8, seed=0, config=CONFIG, mesh=mesh,
        compact=False, pad_ranks=False,
    )
    compact = rank_scan_klnmf(
        X, range(2, 4), n_restarts=8, seed=0, config=CONFIG, mesh=mesh,
        compact=True, compact_min_bucket=2, pad_ranks=False,
    )
    for k in base:
        np.testing.assert_array_equal(compact[k].n_iterations,
                                      base[k].n_iterations)
        np.testing.assert_allclose(compact[k].losses, base[k].losses,
                                   rtol=1e-10)
        np.testing.assert_allclose(np.asarray(compact[k].W),
                                   np.asarray(base[k].W), rtol=1e-10)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_rank_scan_corrnmf_compact_mesh_matches():
    from salamander_tpu.parallel import make_mesh, rank_scan_corrnmf

    rng = np.random.default_rng(21)
    X = rng.poisson(40.0, size=(32, 12)).astype(float) + 1.0
    config = FitConfig(min_iterations=10, max_iterations=150,
                       conv_test_freq=5, tol=1e-7)
    mesh = make_mesh(jax.devices()[:8], sample_ways=4)  # 2 restart ways
    base = rank_scan_corrnmf(
        X, range(2, 4), dim_embeddings=2, n_restarts=8, base_seed=0,
        config=config, build_models=False, mesh=mesh, compact=False,
    )
    compact = rank_scan_corrnmf(
        X, range(2, 4), dim_embeddings=2, n_restarts=8, base_seed=0,
        config=config, build_models=False, mesh=mesh, compact=True,
        compact_min_bucket=2,
    )
    for k in base:
        np.testing.assert_allclose(compact[k].losses, base[k].losses,
                                   rtol=1e-8)
        np.testing.assert_array_equal(compact[k].n_iterations,
                                      base[k].n_iterations)
        assert compact[k].best_index == base[k].best_index


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_fit_klnmf_restarts_compact_mesh_matches_unsharded():
    """The compacting sharded multi-start equals the single-device
    compacting run lane for lane. Compared at float64: partitioned
    reductions change summation order, and at float32 those ulps shift
    borderline convergence blocks (the package-wide cross-layout lesson);
    at f64 the jitter sits ~1e-16, far from the 1e-6 tolerance."""
    from salamander_tpu.parallel import make_mesh

    X = _counts(seed=13, D=32)
    mesh = make_mesh(jax.devices()[:8], sample_ways=2)
    plain = fit_klnmf_restarts_compacting(
        X, 3, 8, seed=0, config=CONFIG, min_bucket=2, dtype=jnp.float64
    )
    sharded = fit_klnmf_restarts_compacting(
        X, 3, 8, seed=0, config=CONFIG, min_bucket=2, mesh=mesh,
        dtype=jnp.float64
    )
    np.testing.assert_array_equal(sharded.n_iterations, plain.n_iterations)
    np.testing.assert_allclose(sharded.losses, plain.losses, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sharded.W), np.asarray(plain.W),
                               rtol=1e-10)


def test_next_bucket_schedule():
    """The compaction schedule rounds bucket sizes up to lane_multiple
    (device-aligned levels under a mesh) and reduces to plain halving at
    lane_multiple=1."""
    def runner(min_bucket, lane_multiple):
        return CompactingRunner(
            CONFIG, lambda p, d: jnp.zeros(()), lambda d, n: None,
            min_bucket=min_bucket, lane_multiple=lane_multiple,
        )

    plain = runner(2, 1)
    assert plain._next_bucket(8) == 4
    assert plain._next_bucket(7) == 3
    assert plain._next_bucket(3) is None  # 3 // 2 = 1 < min_bucket
    legacy = runner(8, 1)
    assert legacy._next_bucket(100) == 50
    assert legacy._next_bucket(25) == 12
    assert legacy._next_bucket(12) is None  # 6 < 8: original stop point

    meshy = runner(2, 4)  # 4 restart ways
    assert meshy._next_bucket(100) == 52   # 50 -> next multiple of 4
    assert meshy._next_bucket(52) == 28
    assert meshy._next_bucket(8) == 4
    assert meshy._next_bucket(4) is None   # would not shrink


def test_rank_scan_mvnmf_compact_matches():
    """compact=True through the K-padded MvNMF scan (masked lanes with
    per-lane line-search gamma) must not change any per-rank result."""
    from salamander_tpu.parallel import rank_scan_mvnmf

    X = _counts(seed=8)
    config = FitConfig(min_iterations=10, max_iterations=300,
                       conv_test_freq=10, tol=1e-4)
    base = rank_scan_mvnmf(X, range(2, 5), n_restarts=6, seed=0,
                           config=config, rank_bucket=4)
    compact = rank_scan_mvnmf(
        X, range(2, 5), n_restarts=6, seed=0, config=config, rank_bucket=4,
        compact=True, compact_min_bucket=2,
    )
    for k in base:
        np.testing.assert_array_equal(compact[k].n_iterations,
                                      base[k].n_iterations)
        np.testing.assert_allclose(compact[k].losses, base[k].losses,
                                   rtol=1e-10)
        np.testing.assert_allclose(np.asarray(compact[k].W),
                                   np.asarray(base[k].W), rtol=1e-10)


def test_fit_klnmf_restarts_compact_kwarg_weighted():
    """compact=True on fit_klnmf_restarts with KL weights matches the
    plain weighted path (weights ride in the data pytree either way)."""
    rng = np.random.default_rng(9)
    X = _counts(seed=9)
    weights = rng.uniform(0.5, 2.0, size=X.shape[1])
    base = fit_klnmf_restarts(X, 3, 8, seed=4, config=CONFIG,
                              weights_kl=weights)
    compact = fit_klnmf_restarts(X, 3, 8, seed=4, config=CONFIG,
                                 weights_kl=weights, compact=True,
                                 compact_min_bucket=2)
    np.testing.assert_array_equal(compact.n_iterations, base.n_iterations)
    np.testing.assert_allclose(compact.losses, base.losses, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(compact.H), np.asarray(base.H),
                               rtol=1e-10)


def test_rank_scan_corrnmf_compact_matches():
    """compact=True through the CorrNMF scan: per-point losses and
    winner ELBOs must match the monolithic path (CPU/f64: split-program
    ulps are ~1e-16 and do not shift the branchy Newton trajectories at
    these tolerances)."""
    from salamander_tpu.parallel import rank_scan_corrnmf

    rng = np.random.default_rng(11)
    X = rng.poisson(40.0, size=(30, 12)).astype(float) + 1.0
    config = FitConfig(min_iterations=10, max_iterations=150,
                       conv_test_freq=5, tol=1e-7)
    base = rank_scan_corrnmf(
        X, range(2, 4), dim_embeddings=2, n_restarts=8, base_seed=0,
        config=config, build_models=False,
    )
    compact = rank_scan_corrnmf(
        X, range(2, 4), dim_embeddings=2, n_restarts=8, base_seed=0,
        config=config, build_models=False, compact=True,
        compact_min_bucket=2,
    )
    for k in base:
        np.testing.assert_allclose(compact[k].losses, base[k].losses,
                                   rtol=1e-8)
        np.testing.assert_array_equal(compact[k].n_iterations,
                                      base[k].n_iterations)
        assert compact[k].best_index == base[k].best_index
        for key, value in base[k].best_params.items():
            np.testing.assert_allclose(compact[k].best_params[key], value,
                                       rtol=1e-6, atol=1e-10,
                                       err_msg=f"k={k} {key}")


def test_fit_best_of_compact_matches():
    """compact=True through the generic fit_best_of (model-API multi-start)
    must reproduce the monolithic engine's summary for a maximize-direction
    family (CorrNMFDet) and leave the fitted model identical."""
    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu.parallel import fit_best_of

    rng = np.random.default_rng(12)
    counts = rng.poisson(30.0, size=(25, 14)).astype(float) + 1.0

    def make_model():
        return CorrNMFDet(n_signatures=3, dim_embeddings=2,
                          init_method="random", min_iterations=10,
                          max_iterations=200, conv_test_freq=5, tol=1e-6)

    model_a = make_model()
    base = fit_best_of(model_a, AnnData(counts.copy()), n_restarts=8,
                       base_seed=0, compact=False)
    model_b = make_model()
    compact = fit_best_of(model_b, AnnData(counts.copy()), n_restarts=8,
                          base_seed=0, compact=True, compact_min_bucket=2)
    np.testing.assert_array_equal(compact.n_iterations, base.n_iterations)
    np.testing.assert_allclose(compact.losses, base.losses, rtol=1e-8)
    assert compact.best_index == base.best_index
    np.testing.assert_allclose(model_b.signatures.values,
                               model_a.signatures.values, rtol=1e-6)


def test_compacting_remainder_tail():
    """max_iterations not divisible by conv_test_freq: the never-evaluated
    remainder advance must hit unconverged lanes exactly once."""
    config = FitConfig(min_iterations=64, max_iterations=64,
                       conv_test_freq=10, tol=1e-6)
    X = _counts(seed=4)
    base = fit_klnmf_restarts(X, 3, 4, seed=2, config=config)
    compact = fit_klnmf_restarts_compacting(
        X, 3, 4, seed=2, config=config, min_bucket=2
    )
    np.testing.assert_array_equal(compact.n_iterations, base.n_iterations)
    np.testing.assert_allclose(compact.losses, base.losses, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(compact.H), np.asarray(base.H),
                               rtol=1e-12)


def test_fit_best_of_compacting_runner_reused_across_calls():
    """Repeated fit_best_of calls with the same family/hyperparams/shapes
    must reuse ONE CompactingRunner (= one compiled-program cache): each
    runner's segment programs are fresh compiles, so warm+timed call
    pairs and scan loops would otherwise recompile every call. Results
    must stay identical to the first call's."""
    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import KLNMF
    from salamander_tpu.parallel import fit_best_of, multistart

    rng = np.random.default_rng(5)
    counts = rng.poisson(25.0, size=(20, 12)).astype(float) + 1.0

    def make_model():
        return KLNMF(n_signatures=3, init_method="random",
                     min_iterations=10, max_iterations=300,
                     conv_test_freq=5, tol=1e-6)

    multistart._RUNNER_CACHE.clear()
    first = fit_best_of(make_model(), AnnData(counts.copy()), n_restarts=8,
                        base_seed=0, compact=True, compact_min_bucket=2)
    assert len(multistart._RUNNER_CACHE) == 1
    runner = next(iter(multistart._RUNNER_CACHE.values()))
    second = fit_best_of(make_model(), AnnData(counts.copy()), n_restarts=8,
                         base_seed=0, compact=True, compact_min_bucket=2)
    assert next(iter(multistart._RUNNER_CACHE.values())) is runner
    assert len(multistart._RUNNER_CACHE) == 1
    np.testing.assert_array_equal(second.losses, first.losses)

    # different shapes (rank) must get their own entry, not a stale reuse
    other = KLNMF(n_signatures=4, init_method="random", min_iterations=10,
                  max_iterations=300, conv_test_freq=5, tol=1e-6)
    fit_best_of(other, AnnData(counts.copy()), n_restarts=8,
                base_seed=0, compact=True, compact_min_bucket=2)
    assert len(multistart._RUNNER_CACHE) == 2


def test_rank_scan_pad_false_respects_explicit_compact_false(monkeypatch):
    """rank_scan_klnmf(pad_ranks=False, compact=False) must pass the
    resolved decision into fit_klnmf_restarts - the inner call used to
    re-auto-resolve compact=None, silently overriding an explicit opt-out
    on an accelerator (where auto enables compaction). Simulated here by
    making auto-resolution return True, as it does there."""
    from salamander_tpu.parallel import compaction, restarts

    def fake_resolve(compact, config, mesh, n_restarts, min_bucket):
        return True if compact is None else bool(compact)

    def boom(*args, **kwargs):
        raise AssertionError("compacting path used despite compact=False")

    monkeypatch.setattr(restarts, "resolve_compact", fake_resolve)
    monkeypatch.setattr(compaction, "fit_klnmf_restarts_compacting", boom)
    X = _counts()
    config = FitConfig(min_iterations=10, max_iterations=40,
                       conv_test_freq=10, tol=1e-6)
    results = restarts.rank_scan_klnmf(
        X, [2, 3], 4, seed=0, config=config, pad_ranks=False,
        compact=False,
    )
    assert set(results) == {2, 3}


def test_rank_scan_pad_auto_resolves_against_compaction(monkeypatch):
    """pad_ranks=None must resolve to per-rank programs (pad off) exactly
    when compaction triggers - each rank then drops its own converged
    lanes - and to
    padded buckets when it does not (e.g. fixed-length schedules)."""
    from salamander_tpu.parallel import compaction, restarts

    monkeypatch.setattr(restarts, "resolve_compact",
                        lambda compact, *a: True if compact is None
                        else bool(compact))
    seen = []
    real = compaction.klnmf_restarts_compacting_device

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(
        compaction, "klnmf_restarts_compacting_device", spy
    )
    X = _counts()
    config = FitConfig(min_iterations=10, max_iterations=60,
                       conv_test_freq=10, tol=1e-6)
    restarts.rank_scan_klnmf(X, [2, 3], 4, seed=0, config=config,
                             compact_min_bucket=2)
    # compaction on -> pad resolved off -> one (dispatch-only) compacting
    # run per rank, fetched after all ranks are in flight
    assert len(seen) == 2

    seen.clear()
    restarts.rank_scan_klnmf(X, [2, 3], 4, seed=0, config=config,
                             compact=False)
    # compaction off -> pad resolved on -> the padded bucket path, no
    # compacting calls
    assert seen == []


def test_resolve_compact_auto_policy(monkeypatch):
    """Auto compaction needs: a convergence rule, an accelerator
    backend, and room for at least one halving (n_restarts >=
    2 * min_bucket)."""
    from salamander_tpu.parallel import compaction

    conv = FitConfig(min_iterations=10, max_iterations=100,
                     conv_test_freq=10, tol=1e-6)
    fixed = FitConfig(min_iterations=100, max_iterations=100,
                      conv_test_freq=10, tol=1e-6)

    # explicit always wins, any backend
    assert compaction.resolve_compact(True, conv, None, 4, 4) is True
    assert compaction.resolve_compact(False, conv, None, 64, 4) is False
    # CPU backend: auto stays off (bit-exactness reference path)
    assert compaction.resolve_compact(None, conv, None, 64, 4) is False

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert compaction.resolve_compact(None, conv, None, 16, 4) is True
    # one halving suffices (fetch-free driver); below that, off
    assert compaction.resolve_compact(None, conv, None, 8, 4) is True
    assert compaction.resolve_compact(None, conv, None, 7, 4) is False
    # fixed-length schedule never frees a lane: off
    assert compaction.resolve_compact(None, fixed, None, 64, 4) is False
    # meshes compose: auto stays on when at least one device-aligned
    # halving exists (floor = max(min_bucket, restart ways))
    from salamander_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices("cpu")[:8], sample_ways=2)  # 4 ways
    assert compaction.mesh_restart_ways(mesh) == 4
    assert compaction.resolve_compact(None, conv, mesh, 64, 4) is True
    assert compaction.resolve_compact(None, conv, mesh, 8, 1) is True
    assert compaction.resolve_compact(None, conv, mesh, 7, 1) is False


def test_deferred_fetch_budget_flush(monkeypatch):
    """Scan results are identical when the in-flight byte budget forces
    mid-scan drains (several small flushes) vs one deferred drain."""
    from salamander_tpu.parallel import restarts

    from salamander_tpu.parallel import rank_scan_corrnmf

    X = _counts(seed=8)
    config = FitConfig(min_iterations=10, max_iterations=200,
                       conv_test_freq=10, tol=1e-6)
    kwargs = dict(seed=0, config=config, pad_ranks=True)
    co_cfg = FitConfig(min_iterations=10, max_iterations=60,
                       conv_test_freq=10, tol=1e-5)

    base = restarts.rank_scan_klnmf(X, range(2, 5), 4, **kwargs)
    co_base = rank_scan_corrnmf(X.T.copy(), range(2, 4), dim_embeddings=2,
                                n_restarts=3, base_seed=0, config=co_cfg,
                                build_models=False)

    monkeypatch.setattr(restarts, "_INFLIGHT_BUDGET_BYTES", 1)  # flush always
    tiny = restarts.rank_scan_klnmf(X, range(2, 5), 4, **kwargs)
    for k in base:
        np.testing.assert_array_equal(tiny[k].losses, base[k].losses)
        np.testing.assert_array_equal(np.asarray(tiny[k].W),
                                      np.asarray(base[k].W))
    # the CorrNMF scan reads the budget at call time from restarts
    co_tiny = rank_scan_corrnmf(X.T.copy(), range(2, 4), dim_embeddings=2,
                                n_restarts=3, base_seed=0, config=co_cfg,
                                build_models=False)
    for k in co_base:
        np.testing.assert_array_equal(co_tiny[k].losses, co_base[k].losses)
        # fitted parameters survive mid-scan drains too (the budget is
        # read at call time from restarts, so the monkeypatch applies)
        np.testing.assert_array_equal(np.asarray(co_tiny[k].signatures),
                                      np.asarray(co_base[k].signatures))


def test_capped_segments_match_fused_levels():
    """The time-capped level driver (program_seconds: a budget on one
    device program's duration, so big-D levels run as chains of capped
    segments) is the SAME while_loop paused and resumed: every result leaf
    must be bitwise-equal to the fused zero-fetch chain's, here forced onto
    the capped path with a tiny budget (cap = 1 block per dispatch, the
    worst case for pause/resume bookkeeping)."""
    update_fn, objective_fn = ops.make_step_functions()

    def make_block(data, n_lanes):
        batched = jax.vmap(update_fn, in_axes=(0, None))

        def block(params, steps):
            return jax.lax.fori_loop(
                0, steps, lambda _, q: batched(q, data), params
            )

        return block

    X = jnp.asarray(_counts())
    rng = np.random.default_rng(3)
    n_restarts, k = 8, 3
    W0 = jnp.asarray(rng.random((n_restarts, X.shape[0], k)) + 0.1)
    H0 = jnp.asarray(rng.random((n_restarts, k, X.shape[1])) + 0.1)
    params0, data = {"W": W0, "H": H0}, {"X": X}

    fused = CompactingRunner(CONFIG, objective_fn, make_block, min_bucket=2)
    base, base_loss = fused.run(params0, data)
    capped = CompactingRunner(CONFIG, objective_fn, make_block, min_bucket=2,
                              program_seconds=1e-9)
    got, got_loss = capped.run(params0, data)

    assert capped._measured_per_block  # the feedback loop actually measured
    np.testing.assert_array_equal(np.asarray(got_loss), np.asarray(base_loss))
    np.testing.assert_array_equal(np.asarray(got.n_iterations),
                                  np.asarray(base.n_iterations))
    np.testing.assert_array_equal(np.asarray(got.n_evals),
                                  np.asarray(base.n_evals))
    np.testing.assert_array_equal(np.asarray(got.params["W"]),
                                  np.asarray(base.params["W"]))
    np.testing.assert_array_equal(np.asarray(got.params["H"]),
                                  np.asarray(base.params["H"]))
    hist_base, hist_got = np.asarray(base.history), np.asarray(got.history)
    np.testing.assert_array_equal(np.isnan(hist_got), np.isnan(hist_base))
    np.testing.assert_array_equal(hist_got[~np.isnan(hist_got)],
                                  hist_base[~np.isnan(hist_base)])


def test_capped_segments_batched_data_extraction_lanes():
    """Capped path under batched_data=True (extraction lanes: each lane its
    own bootstrap counts, compactions gather data rows too)."""
    from salamander_tpu.parallel.compaction import (
        _cached_extraction_compacting_runner,
    )

    rng = np.random.default_rng(5)
    L, V, D, Kp = 8, 10, 16, 3
    X_lanes = jnp.asarray(rng.poisson(6.0, (L, V, D)).astype(np.float64) + 1.0)
    W0 = jnp.asarray(rng.random((L, V, Kp)) + 0.1)
    H0 = jnp.asarray(rng.random((L, Kp, D)) + 0.1)
    masks = jnp.asarray(np.stack([np.arange(Kp) < 2 + (i % 2)
                                  for i in range(L)]))
    H0 = jnp.where(masks[:, :, None], H0, 0.0)
    params0 = {"W": W0, "H": H0, "mask": masks}
    data = {"X": X_lanes}
    config = FitConfig(min_iterations=10, max_iterations=400,
                       conv_test_freq=10, tol=1e-6)

    base_runner = _cached_extraction_compacting_runner(config, False, 2)
    base, base_loss = base_runner.run(params0, data)

    capped = CompactingRunner(
        config, base_runner.objective_fn, base_runner.make_block_update,
        min_bucket=2, batched_data=True, program_seconds=1e-9,
    )
    got, got_loss = capped.run(params0, data)
    np.testing.assert_array_equal(np.asarray(got_loss), np.asarray(base_loss))
    np.testing.assert_array_equal(np.asarray(got.n_iterations),
                                  np.asarray(base.n_iterations))
    np.testing.assert_array_equal(np.asarray(got.params["W"]),
                                  np.asarray(base.params["W"]))


def test_program_kill_guard_single_fit_matches(monkeypatch):
    """make_fit_function's call-time program-duration guard (a forced
    program_seconds budget): a rerouted single fit must reproduce the
    monolithic engine fit exactly up to split-program fusion ulps - the
    monolithic unbatched engine UNROLLS conv_test_freq blocks while the
    capped route runs a
    vmapped R=1 fori loop, so f64 values differ at ~1e-16 relative (the
    package-wide separately-compiled-programs lesson); convergence blocks
    and iteration counts must still agree exactly."""
    from salamander_tpu.models import KLNMF
    from salamander_tpu.containers import AnnData
    from salamander_tpu.parallel import compaction

    X = _counts(seed=11)
    adata = AnnData(X.T)  # samples x features

    def fit_once():
        model = KLNMF(n_signatures=3, min_iterations=20, max_iterations=500,
                      conv_test_freq=10, tol=1e-6)
        model.fit(adata, init_kwargs={"seed": 1})
        return model

    base = fit_once()
    # force every backend onto the guard and the estimate over threshold
    monkeypatch.setattr(compaction, "PROGRAM_SECONDS_OVERRIDE", 1e-12)
    guarded = fit_once()
    monkeypatch.setattr(compaction, "PROGRAM_SECONDS_OVERRIDE", None)

    assert guarded.history["n_iterations"] == base.history["n_iterations"]
    np.testing.assert_allclose(
        np.asarray(guarded.history["objective_function"]),
        np.asarray(base.history["objective_function"]), rtol=1e-12,
    )
    np.testing.assert_allclose(np.asarray(guarded.signatures.to_numpy()),
                               np.asarray(base.signatures.to_numpy()),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(guarded.exposures.to_numpy()),
                               np.asarray(base.exposures.to_numpy()),
                               rtol=1e-9)


def test_program_kill_guard_verbose_prints_segments(monkeypatch, capsys):
    """verbose=1 on a rerouted (capped-segment) fit prints live progress
    at the segment boundaries - the mid-fit reporting channel on backends
    that reject host callbacks - and the results are unchanged."""
    from salamander_tpu.models import KLNMF
    from salamander_tpu.containers import AnnData
    from salamander_tpu.parallel import compaction

    from salamander_tpu.engine import fit as engine_fit

    X = _counts(seed=11)
    adata = AnnData(X.T)

    def fit_once(verbose):
        model = KLNMF(n_signatures=3, min_iterations=20, max_iterations=500,
                      conv_test_freq=10, tol=1e-6)
        model.fit(adata, init_kwargs={"seed": 1}, verbose=verbose)
        return model

    # simulate a backend that rejects host callbacks: verbose must fall
    # back to segment-boundary progress + the post-fit trace
    monkeypatch.setattr(engine_fit, "backend_supports_callbacks",
                        lambda: False)
    monkeypatch.setattr(compaction, "PROGRAM_SECONDS_OVERRIDE", 1e-12)
    quiet = fit_once(0)
    assert "iteration:" not in capsys.readouterr().out
    loud = fit_once(1)
    out = capsys.readouterr().out
    monkeypatch.setattr(compaction, "PROGRAM_SECONDS_OVERRIDE", None)

    # one line per capped segment: "iteration: N; objective: X"
    lines = [ln for ln in out.splitlines()
             if ln.startswith("iteration:") and "objective" in ln]
    assert len(lines) >= 2  # a 1e-12 budget chops the fit into many segments
    iters = [int(ln.split("iteration:")[1].split(";")[0]) for ln in lines]
    assert iters == sorted(iters)  # monotone progress
    assert quiet.history["n_iterations"] == loud.history["n_iterations"]
    np.testing.assert_array_equal(quiet.signatures.to_numpy(),
                                  loud.signatures.to_numpy())


def test_program_kill_guard_batched_fit_matches(monkeypatch):
    """The guard on the batched (lockstep) monolithic path: rerouted
    multi-start results equal the monolithic lockstep's bitwise (CPU).
    min_bucket = lane count, so the guard never COMPACTS - paths that
    chose the monolithic engine keep their layout, only chunked in time."""
    from salamander_tpu.engine import make_fit_function
    from salamander_tpu.parallel import compaction

    update_fn, objective_fn = ops.make_step_functions()
    X = jnp.asarray(_counts(seed=12))
    rng = np.random.default_rng(7)
    R, k = 6, 3
    params0 = {
        "W": jnp.asarray(rng.random((R, X.shape[0], k)) + 0.1),
        "H": jnp.asarray(rng.random((R, k, X.shape[1])) + 0.1),
    }
    cfg = FitConfig(min_iterations=20, max_iterations=400,
                    conv_test_freq=10, tol=1e-6)
    run = make_fit_function(update_fn, objective_fn, cfg, batched=True)
    base = run(params0, {"X": X})
    monkeypatch.setattr(compaction, "PROGRAM_SECONDS_OVERRIDE", 1e-12)
    got = make_fit_function(update_fn, objective_fn, cfg, batched=True)(
        params0, {"X": X}
    )
    np.testing.assert_array_equal(np.asarray(got.n_iterations),
                                  np.asarray(base.n_iterations))
    np.testing.assert_array_equal(np.asarray(got.params["W"]),
                                  np.asarray(base.params["W"]))
    np.testing.assert_array_equal(np.asarray(got.params["H"]),
                                  np.asarray(base.params["H"]))
    hist_b, hist_g = np.asarray(base.history), np.asarray(got.history)
    np.testing.assert_array_equal(np.isnan(hist_g), np.isnan(hist_b))
    np.testing.assert_array_equal(hist_g[~np.isnan(hist_g)],
                                  hist_b[~np.isnan(hist_b)])


def test_fit_best_of_verbose_prints_capped_segments(monkeypatch, capsys):
    """fit_best_of(verbose=1): live objective-range lines at capped
    segment boundaries (compacting runner under a forced tiny program
    budget); results unchanged vs the quiet run."""
    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import KLNMF
    from salamander_tpu.parallel import compaction, fit_best_of

    X = _counts(seed=13)

    def run(verbose):
        model = KLNMF(n_signatures=3, init_method="random",
                      min_iterations=20, max_iterations=300,
                      conv_test_freq=10, tol=1e-6)
        return fit_best_of(model, AnnData(X.T.copy()), 16, base_seed=0,
                           compact=True, verbose=verbose)

    monkeypatch.setattr(compaction, "PROGRAM_SECONDS_OVERRIDE", 1e-12)
    quiet = run(0)
    assert "lanes alive" not in capsys.readouterr().out
    loud = run(1)
    out = capsys.readouterr().out
    monkeypatch.setattr(compaction, "PROGRAM_SECONDS_OVERRIDE", None)

    lines = [ln for ln in out.splitlines() if "lanes alive" in ln]
    assert len(lines) >= 2
    np.testing.assert_array_equal(quiet.losses, loud.losses)

"""Fit-engine semantics: convergence rule parity with the reference's host
loop, history buffer contents, max-iteration capping, vmap lane freezing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from salamander_tpu.engine import (
    FitConfig,
    fit_loop,
    fit_loop_lockstep,
    make_fit_function,
)
from salamander_tpu.ops import klnmf


def quadratic_problem(rate):
    """x <- rate * x decays geometrically; objective = x^2 (minimized)."""

    def update(x):
        return rate * x

    def objective(x):
        return jnp.sum(x**2)

    return update, objective


def reference_host_loop(x0, rate, config):
    """The reference's Python while loop, verbatim semantics
    (signature_nmf.py:361-383), as ground truth for the engine."""
    x = np.asarray(x0, dtype=float)
    of_values = [float(np.sum(x**2))]
    n_iteration = 0
    converged = False
    while not converged:
        n_iteration += 1
        x = rate * x
        if n_iteration % config.conv_test_freq == 0:
            prev = of_values[-1]
            of_values.append(float(np.sum(x**2)))
            rel_change = abs(prev - of_values[-1]) / abs(prev)
            converged = (
                rel_change < config.tol and n_iteration >= config.min_iterations
            )
        converged |= n_iteration >= config.max_iterations
    return x, of_values[1:], n_iteration


@pytest.mark.parametrize("rate,config", [
    (0.9, FitConfig(min_iterations=20, max_iterations=500, conv_test_freq=10,
                    tol=1e-6)),
    (0.99999, FitConfig(min_iterations=10, max_iterations=73,
                        conv_test_freq=10, tol=1e-12)),
    (0.5, FitConfig(min_iterations=0, max_iterations=100, conv_test_freq=5,
                    tol=1e-3)),
])
def test_engine_matches_reference_loop(rate, config):
    update, objective = quadratic_problem(rate)
    x0 = jnp.asarray([1.0, 2.0, 3.0])
    result = fit_loop(update, objective, x0, config)
    x_ref, history_ref, n_iter_ref = reference_host_loop(x0, rate, config)

    assert int(result.n_iterations) == n_iter_ref
    assert int(result.n_evals) == len(history_ref)
    np.testing.assert_allclose(np.asarray(result.params), x_ref, rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(result.history)[: len(history_ref)], history_ref, rtol=1e-6
    )
    # the unused tail of the buffer stays NaN
    assert np.all(np.isnan(np.asarray(result.history)[len(history_ref):]))


def test_engine_partial_final_block():
    """max_iterations not divisible by conv_test_freq: the loop stops exactly
    at max_iterations and the last partial block is never evaluated."""
    config = FitConfig(min_iterations=0, max_iterations=27, conv_test_freq=10,
                       tol=0.0)
    update, objective = quadratic_problem(0.999)
    result = fit_loop(update, objective, jnp.asarray([1.0]), config)
    assert int(result.n_iterations) == 27
    assert int(result.n_evals) == 2  # evals at 10 and 20 only


def test_engine_batched_lanes_converge_independently():
    """Under vmap, lanes with different decay rates converge at different
    iterations and frozen lanes stop changing."""
    config = FitConfig(min_iterations=10, max_iterations=1000,
                       conv_test_freq=10, tol=1e-8)

    def update(p, data):
        return {"x": p["x"] * p["rate"], "rate": p["rate"]}

    def objective(p, data):
        return jnp.sum(p["x"] ** 2) + 1.0

    run = make_fit_function(update, objective, config, batched=True)
    rates = jnp.asarray([0.1, 0.9, 0.99])
    params0 = {"x": jnp.ones((3, 2)), "rate": rates}
    result = run(params0, {})
    iterations = np.asarray(result.n_iterations)
    assert iterations[0] < iterations[1] < iterations[2]
    # each lane's history tail is NaN past its own eval count
    for lane in range(3):
        n_evals = int(result.n_evals[lane])
        lane_history = np.asarray(result.history[lane])
        assert np.all(np.isfinite(lane_history[:n_evals]))
        assert np.all(np.isnan(lane_history[n_evals:]))


def test_engine_is_jittable_and_donatable():
    config = FitConfig(min_iterations=0, max_iterations=50, conv_test_freq=10,
                       tol=1e-4)
    update, objective = quadratic_problem(0.8)
    jitted = jax.jit(lambda x0: fit_loop(update, objective, x0, config))
    result = jitted(jnp.asarray([4.0, 5.0]))
    assert int(result.n_iterations) <= 50


def test_backend_supports_callbacks_on_cpu():
    from salamander_tpu.engine.fit import backend_supports_callbacks

    assert backend_supports_callbacks() is True  # CPU backend has callbacks


def test_print_history_trace(capsys):
    from salamander_tpu.engine.fit import print_history_trace

    history = np.array([100.0, 90.0, 80.0, 70.0, 60.0, np.nan])
    print_history_trace(history, n_evals=5, conv_test_freq=10,
                        verbosity_freq=20)
    out = capsys.readouterr().out.splitlines()
    assert out == [
        "iteration: 20; objective: 90.00",
        "iteration: 40; objective: 70.00",
    ]


def test_fetch_pytree_packed_is_bit_exact():
    """The batched device->host fetch (one transfer for a whole pytree)
    must reproduce per-leaf np.asarray bit for bit across dtypes, shapes
    and scalars (engine/transfer.py packs via uint8 bitcasts)."""
    import jax.numpy as jnp

    from salamander_tpu.engine import transfer

    rng = np.random.default_rng(0)
    tree = {
        "f64": jnp.asarray(rng.standard_normal((7, 5))),
        "f32": jnp.asarray(rng.standard_normal((3, 128)).astype(np.float32)),
        "i32": jnp.asarray(rng.integers(-1000, 1000, 11), jnp.int32),
        "bool": jnp.asarray([True, False, True]),
        "scalar": jnp.asarray(3.5, jnp.float32),
        "nested": [jnp.arange(6, dtype=jnp.int32).reshape(2, 3)],
    }
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    unpacked = jax.tree_util.tree_unflatten(
        treedef, transfer._fetch_packed(leaves)
    )
    for path_a, path_b in zip(
        jax.tree_util.tree_leaves_with_path(tree),
        jax.tree_util.tree_leaves_with_path(unpacked),
    ):
        expected = np.asarray(path_a[1])
        got = path_b[1]
        assert got.dtype == expected.dtype, path_a[0]
        np.testing.assert_array_equal(got, expected, err_msg=str(path_a[0]))

    # the public API short-circuits on CPU but must be structurally equal
    host = transfer.fetch_pytree(tree)
    np.testing.assert_array_equal(host["f64"], np.asarray(tree["f64"]))


def test_fetch_pytree_mixed_host_leaves_pass_through():
    """Mixed pytrees (host numpy + device arrays) must not upload the host
    leaves just to fetch them back: every leaf comes back as numpy with
    identical values, and numpy leaves are returned without copying through
    the packer."""
    from salamander_tpu.engine.transfer import fetch_pytree

    host_leaf = np.arange(12, dtype=np.float32).reshape(3, 4)
    tree = {
        "host": host_leaf,
        "device": jnp.asarray([1.0, 2.0], jnp.float32),
        "python_scalar": 2.5,
    }
    out = fetch_pytree(tree)
    np.testing.assert_array_equal(out["host"], host_leaf)
    np.testing.assert_array_equal(out["device"], [1.0, 2.0])
    assert float(out["python_scalar"]) == 2.5
    assert all(isinstance(leaf, np.ndarray) for leaf in jax.tree.leaves(out))


def test_effective_tolerance_floor_and_recording():
    """float32 parameters floor the enforceable tolerance at 10*eps(f32)
    even under a float64 objective; float64 keeps the user's tol. The model
    layer records the enforced value in history['tol_effective']."""
    from salamander_tpu.engine import FitConfig, effective_tolerance

    config = FitConfig(tol=1e-7)
    floor32 = 10.0 * float(np.finfo(np.float32).eps)
    params32 = {"W": jnp.zeros((2, 2), jnp.float32)}
    assert effective_tolerance(config, np.float64, params32) == floor32
    params64 = {"W": jnp.zeros((2, 2), jnp.float64)}
    assert effective_tolerance(config, np.float64, params64) == 1e-7

    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import KLNMF

    rng = np.random.default_rng(0)
    adata = AnnData(rng.poisson(5.0, (12, 8)).astype(float))
    with pytest.warns(UserWarning, match="convergence resolution"):
        model = KLNMF(n_signatures=2, dtype="float32", min_iterations=10,
                      max_iterations=50, init_method="random")
        model.fit(adata, init_kwargs={"seed": 0})
    assert model.history["tol_effective"] == pytest.approx(floor32)

    model64 = KLNMF(n_signatures=2, min_iterations=10, max_iterations=50,
                    init_method="random")
    model64.fit(adata, init_kwargs={"seed": 0})
    assert model64.history["tol_effective"] == pytest.approx(1e-7)


# --------------------------------------------------------------------- #
# fit-runner cache correctness (round 5): models reuse one jitted runner
# across fit() calls; nothing from a previous fit may leak into the next
# --------------------------------------------------------------------- #


def _toy_counts(seed):
    rng = np.random.default_rng(seed)
    return rng.poisson(30.0, size=(20, 12)).astype(np.float64) + 1.0


def test_fit_runner_cache_new_data_matches_fresh_model():
    """Refitting the SAME model instance on different counts must equal a
    fresh model's fit bitwise (data rides as a jit argument - a baked-in
    X would reproduce the first cohort)."""
    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import KLNMF, MvNMF

    for cls in (KLNMF, MvNMF):
        kwargs = dict(n_signatures=3, min_iterations=20, max_iterations=80,
                      conv_test_freq=10, tol=1e-6)
        reused = cls(**kwargs)
        reused.fit(AnnData(_toy_counts(1)), init_kwargs={"seed": 0})
        first_sigs = np.asarray(reused.asignatures.X).copy()
        reused.fit(AnnData(_toy_counts(2)), init_kwargs={"seed": 0})

        fresh = cls(**kwargs)
        fresh.fit(AnnData(_toy_counts(2)), init_kwargs={"seed": 0})
        np.testing.assert_array_equal(
            np.asarray(reused.asignatures.X), np.asarray(fresh.asignatures.X)
        )
        assert (reused.history["n_iterations"]
                == fresh.history["n_iterations"])
        # and the refit really changed the model (guards a stale absorb)
        assert not np.array_equal(
            first_sigs, np.asarray(reused.asignatures.X)
        )


def test_fit_runner_cache_invalidates_on_hyperparameters():
    """Mutating a baked hyperparameter (MvNMF lam) between fits must not
    reuse the stale runner: the refit equals a fresh model built with the
    new value."""
    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import MvNMF

    X = _toy_counts(3)
    kwargs = dict(n_signatures=3, min_iterations=20, max_iterations=80,
                  conv_test_freq=10, tol=1e-6)
    reused = MvNMF(lam=1.0, **kwargs)
    reused.fit(AnnData(X), init_kwargs={"seed": 0})
    reused.lam = 5.0
    reused.fit(AnnData(X), init_kwargs={"seed": 0})

    fresh = MvNMF(lam=5.0, **kwargs)
    fresh.fit(AnnData(X), init_kwargs={"seed": 0})
    np.testing.assert_array_equal(
        np.asarray(reused.asignatures.X), np.asarray(fresh.asignatures.X)
    )


def test_fit_runner_cache_invalidates_on_config():
    """Changing the convergence budget between fits rebuilds the runner
    (config is part of the cache key)."""
    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import KLNMF

    X = _toy_counts(4)
    reused = KLNMF(n_signatures=3, min_iterations=20, max_iterations=40,
                   conv_test_freq=10, tol=0.0)
    reused.fit(AnnData(X), init_kwargs={"seed": 0})
    assert reused.history["n_iterations"] == 40
    reused.max_iterations = 80
    reused.fit(AnnData(X), init_kwargs={"seed": 0})
    assert reused.history["n_iterations"] == 80

@pytest.fixture(scope="module")
def mu_problem():
    rng = np.random.default_rng(0)
    V, D = 16, 32
    return jnp.asarray(
        np.clip(rng.poisson(30, (V, D)), klnmf.EPSILON, None), jnp.float32
    )


def test_lockstep_loop_matches_vmap(mu_problem):
    """fit_loop_lockstep must reproduce vmap(fit_loop) exactly: per-lane
    histories, eval counts, iteration counts and final params."""
    X = mu_problem
    rng = np.random.default_rng(2)
    R, V, K, D = 4, X.shape[0], 3, X.shape[1]
    W0 = jnp.asarray(rng.dirichlet(np.ones(V), (R, K)).transpose(0, 2, 1),
                     jnp.float32)
    H0 = jnp.asarray(rng.uniform(size=(R, K, D)).astype(np.float32) * 30)
    params0 = {"W": W0, "H": H0}
    config = FitConfig(min_iterations=10, max_iterations=200,
                       conv_test_freq=10, tol=1e-5)

    def update(p):
        W, H = klnmf.update_WH(X, p["W"], p["H"])
        return {"W": W, "H": H}

    def objective(p):
        return klnmf.kl_divergence(X, p["W"], p["H"])

    vmapped = jax.jit(jax.vmap(
        lambda p: fit_loop(update, objective, p, config)
    ))(params0)

    batched_update = jax.vmap(update)

    def block_update(p, steps):
        return jax.lax.fori_loop(0, steps, lambda _, q: batched_update(q), p)

    lockstep = jax.jit(lambda p: fit_loop_lockstep(
        jax.vmap(objective), p, config, block_update
    ))(params0)

    assert np.array_equal(np.asarray(lockstep.n_iterations),
                          np.asarray(vmapped.n_iterations))
    assert np.array_equal(np.asarray(lockstep.n_evals),
                          np.asarray(vmapped.n_evals))
    np.testing.assert_allclose(np.asarray(lockstep.params["W"]),
                               np.asarray(vmapped.params["W"]), rtol=1e-6)
    lh, vh = np.asarray(lockstep.history), np.asarray(vmapped.history)
    np.testing.assert_allclose(
        np.where(np.isnan(lh), -1.0, lh), np.where(np.isnan(vh), -1.0, vh),
        rtol=1e-6,
    )

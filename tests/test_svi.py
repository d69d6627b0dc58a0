"""Stochastic (minibatch) variational EM for CorrNMF.

Anchors:
  * EXACTNESS: with batch_size = n_samples and rho = 1 (step 0, delay 1),
    one SVI step equals one deterministic EM cycle (CorrNMFDet._build_step)
    up to summation reordering - the statistics are the full-batch ones and
    the blending is the identity.
  * PROGRESS: minibatch steps raise the full-data ELBO far above the
    initialization on synthetic data and approach the full-batch optimum.
  * MODEL API: fit_minibatch fills the containers, records the ELBO trace,
    and honors given-parameter freezing.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from salamander_tpu.containers import AnnData
from salamander_tpu.models import CorrNMFDet
from salamander_tpu.ops import svi


def make_synthetic(n_samples=60, n_features=24, n_signatures=3, seed=0):
    rng = np.random.default_rng(seed)
    signatures = rng.dirichlet(np.full(n_features, 0.5), size=n_signatures)
    exposures = rng.gamma(2.0, 50.0, size=(n_samples, n_signatures))
    X = rng.poisson(exposures @ signatures).astype(float)
    X[X == 0] = 1.0
    return X


@pytest.fixture(scope="module")
def fitted_state():
    """A CorrNMFDet initialized on synthetic counts (no fitting yet)."""
    X = make_synthetic()
    model = CorrNMFDet(n_signatures=3, dim_embeddings=2)
    adata = AnnData(X.copy())
    model._setup_adata(adata)
    model._initialize(init_kwargs={"seed": 11})
    model._setup_fitting_parameters()
    return model


def test_full_batch_rho_one_equals_em_cycle(fitted_state):
    model = fitted_state
    params, data = model._device_state()
    update_fn, _ = model._build_step()
    expected = update_fn(params, data)

    config = svi.SVIConfig(
        batch_size=int(model.adata.n_obs),
        delay=1.0,  # rho_0 = (0 + 1)^(-f) = 1 for any forgetting
        signature_newton_iters=100,  # match the batch signature-side cap
    )
    step_fn = svi.make_svi_step(int(model.adata.n_obs), config)
    state = svi.svi_init(params)
    state = jax.jit(step_fn)(state, data["X"], jax.random.PRNGKey(3))

    for name in (
        "signatures",
        "signature_scalings",
        "sample_scalings",
        "signature_embeddings",
        "sample_embeddings",
        "variance",
    ):
        np.testing.assert_allclose(
            np.asarray(state.params[name]),
            np.asarray(expected[name]),
            rtol=1e-8,
            atol=1e-10,
            err_msg=name,
        )


def test_minibatch_steps_raise_full_elbo(fitted_state):
    model = fitted_state
    params, data = model._device_state()
    config = svi.SVIConfig(batch_size=16)
    step_fn = svi.make_svi_step(int(model.adata.n_obs), config)
    state0 = svi.svi_init(params)

    elbo0 = float(svi.full_elbo(state0.params, data["X"]))
    state, history = svi.run_svi(
        step_fn, state0, data["X"], jax.random.PRNGKey(0),
        n_steps=300, eval_freq=50,
    )
    history = np.asarray(history)
    assert history.shape == (6,)
    assert np.all(np.isfinite(history))
    elbo_final = float(svi.full_elbo(state.params, data["X"]))
    assert elbo_final > elbo0
    # the trace should climb overall (stochastic, so endpoints only)
    assert history[-1] > history[0]

    # and land within 2% of a same-budget full-batch EM fit's ELBO
    batch = CorrNMFDet(
        n_signatures=3, dim_embeddings=2,
        min_iterations=10, max_iterations=80, tol=0.0,
    )
    adata = AnnData(np.asarray(data["X"]).copy())
    batch.fit(adata, init_kwargs={"seed": 11})
    elbo_batch = batch.history["objective_function"][-1]
    assert elbo_final > elbo_batch - 0.02 * abs(elbo_batch)


def test_fit_minibatch_model_api():
    X = make_synthetic(seed=5)
    model = CorrNMFDet(n_signatures=2, dim_embeddings=2)
    adata = AnnData(X.copy())
    model.fit_minibatch(
        adata, batch_size=20, n_steps=120, eval_freq=30, seed=1,
        init_kwargs={"seed": 2},
    )
    assert model._is_fitted
    assert len(model.history["objective_function"]) == 4
    assert model.history["n_iterations"] == 120
    exposures = model.adata.obsm["exposures"]
    assert exposures.shape == (X.shape[0], 2)
    assert np.all(np.isfinite(exposures))
    # signatures are row-stochastic (rows = signatures over features)
    np.testing.assert_allclose(model.asignatures.X.sum(axis=1), 1.0, rtol=1e-5)
    # the fitted ELBO improves on a freshly initialized model's
    fresh = CorrNMFDet(n_signatures=2, dim_embeddings=2)
    fresh_adata = AnnData(X.copy())
    fresh._setup_adata(fresh_adata)
    fresh._initialize(init_kwargs={"seed": 2})
    assert model.objective_function() > fresh.objective_function()


def test_fit_minibatch_given_parameters_frozen():
    X = make_synthetic(seed=7)
    sig_scalings = np.array([-0.3, 0.4])
    variance = 1.7
    model = CorrNMFDet(n_signatures=2, dim_embeddings=2)
    adata = AnnData(X.copy())
    model.fit_minibatch(
        adata, batch_size=16, n_steps=60, eval_freq=30, seed=4,
        given_parameters={
            "signature_scalings": sig_scalings,
            "variance": variance,
        },
        init_kwargs={"seed": 3},
    )
    np.testing.assert_array_equal(
        np.asarray(model.asignatures.obs["scalings"], float), sig_scalings
    )
    assert model.variance == variance


def test_batch_size_validation(fitted_state):
    with pytest.raises(ValueError, match="batch_size"):
        svi.make_svi_step(10, svi.SVIConfig(batch_size=11))
    with pytest.raises(ValueError, match="batch_size"):
        svi.make_svi_step(10, svi.SVIConfig(batch_size=0))


def test_schedule_validation():
    """delay < 1 silently NaN-poisons the blend, forgetting outside
    (0.5, 1] breaks Robbins-Monro - both must be rejected eagerly."""
    with pytest.raises(ValueError, match="delay"):
        svi.make_svi_step(10, svi.SVIConfig(batch_size=5, delay=0.0))
    with pytest.raises(ValueError, match="delay"):
        svi.make_mm_svi_step(
            10, ["a"], [2], svi.SVIConfig(batch_size=5, delay=0.5)
        )
    with pytest.raises(ValueError, match="forgetting"):
        svi.make_svi_step(10, svi.SVIConfig(batch_size=5, forgetting=0.5))
    with pytest.raises(ValueError, match="forgetting"):
        svi.make_svi_step(10, svi.SVIConfig(batch_size=5, forgetting=1.5))
    with pytest.raises(ValueError, match="Newton"):
        svi.make_svi_step(
            10, svi.SVIConfig(batch_size=5, signature_newton_iters=0)
        )


def test_run_svi_eval_freq_validation_and_disable(fitted_state):
    model = fitted_state
    params, data = model._device_state()
    step_fn = svi.make_svi_step(
        int(model.adata.n_obs), svi.SVIConfig(batch_size=16)
    )
    state0 = svi.svi_init(params)
    with pytest.raises(ValueError, match="eval_freq"):
        svi.run_svi(step_fn, state0, data["X"], jax.random.PRNGKey(0),
                    n_steps=10, eval_freq=-1)
    with pytest.raises(ValueError, match="n_steps"):
        svi.run_svi(step_fn, state0, data["X"], jax.random.PRNGKey(0),
                    n_steps=0, eval_freq=5)
    # eval_freq=0: steps run, no full-data ELBO is ever evaluated
    state, history = svi.run_svi(
        step_fn, state0, data["X"], jax.random.PRNGKey(0),
        n_steps=25, eval_freq=0,
    )
    assert history.shape == (0,)
    assert int(state.step) == 25


def test_epoch_sampler_covers_every_sample(fitted_state):
    """Minibatches are cut from a per-epoch permutation: one epoch of steps
    refreshes the local parameters of EVERY sample exactly once."""
    model = fitted_state
    params, data = model._device_state()
    n_samples = int(model.adata.n_obs)  # 60
    batch = 12
    step_fn = jax.jit(svi.make_svi_step(n_samples, svi.SVIConfig(
        batch_size=batch)))
    state = svi.svi_init(params)
    before = np.asarray(params["sample_scalings"])
    seen = []
    for i in range(n_samples // batch):
        state = step_fn(state, data["X"], jax.random.PRNGKey(100 + i))
        seen.append(np.asarray(state.perm[i * batch:(i + 1) * batch]))
    assert sorted(np.concatenate(seen).tolist()) == list(range(n_samples))
    after = np.asarray(state.params["sample_scalings"])
    assert np.all(after != before)  # every sample's local state refreshed
    # running sum-of-squares statistic stayed exact through the epoch
    np.testing.assert_allclose(
        float(state.stat_usq),
        float(np.sum(np.asarray(state.params["sample_embeddings"]) ** 2)),
        rtol=1e-10,
    )


def test_fit_minibatch_clamps_default_batch_size():
    """fit_minibatch() with defaults must work on cohorts smaller than the
    default batch_size=128 (clamped to n_samples)."""
    X = make_synthetic(seed=9)  # 60 samples < 128
    model = CorrNMFDet(n_signatures=2, dim_embeddings=2)
    model.fit_minibatch(AnnData(X.copy()), n_steps=20, eval_freq=10,
                        init_kwargs={"seed": 0})
    assert model._is_fitted
    assert len(model.history["objective_function"]) == 2


def test_fit_minibatch_rejects_newton_cg_compat():
    model = CorrNMFDet(n_signatures=2, dim_embeddings=2,
                       newton_cg_compat=True)
    with pytest.raises(ValueError, match="newton_cg_compat"):
        model.fit_minibatch(AnnData(make_synthetic(seed=2)))


def test_mm_fit_minibatch_rejects_newton_cg_compat():
    from salamander_tpu.models import MultimodalCorrNMF

    _, mdata = make_mm_model(seed=1)
    model = MultimodalCorrNMF(ns_signatures=[2, 2], dim_embeddings=2,
                              newton_cg_compat=True)
    with pytest.raises(ValueError, match="newton_cg_compat"):
        model.fit_minibatch(mdata)


def test_plot_history_raises_clearly_on_empty_trace():
    """fit_minibatch(eval_freq=0) records no trace; plot_history must raise
    a clear error instead of an IndexError from the plotting layer."""
    X = make_synthetic(seed=6)
    model = CorrNMFDet(n_signatures=2, dim_embeddings=2)
    model.fit_minibatch(AnnData(X.copy()), batch_size=16, n_steps=20,
                        eval_freq=0, init_kwargs={"seed": 1})
    with pytest.raises(ValueError, match="eval_freq"):
        model.plot_history()


def test_plot_history_uses_minibatch_eval_spacing():
    """The x-axis of plot_history must be spaced by eval_freq after
    fit_minibatch (not conv_test_freq), and by conv_test_freq after fit."""
    import matplotlib
    matplotlib.use("Agg")
    X = make_synthetic(seed=4)
    model = CorrNMFDet(n_signatures=2, dim_embeddings=2)
    model.fit_minibatch(AnnData(X.copy()), batch_size=20, n_steps=120,
                        eval_freq=40, init_kwargs={"seed": 1})
    ax = model.plot_history()
    xdata = ax.lines[0].get_xdata()
    np.testing.assert_array_equal(xdata, [40, 80, 120])
    import matplotlib.pyplot as plt
    plt.close("all")

    refit = CorrNMFDet(n_signatures=2, dim_embeddings=2,
                       min_iterations=10, max_iterations=30, tol=0.0)
    refit.fit(AnnData(X.copy()), init_kwargs={"seed": 1})
    ax = refit.plot_history()
    assert ax.lines[0].get_xdata()[0] == refit.conv_test_freq
    plt.close("all")


def test_minibatch_statistics_are_unbiased(fitted_state):
    """The scaled minibatch sufficient statistics average to the full-batch
    statistics: each sample's local refresh is a deterministic function of
    its own data and the shared globals, so a uniformly drawn batch gives an
    exactly unbiased estimator (checked by Monte Carlo over 512 batches)."""
    model = fitted_state
    params, data = model._device_state()
    n_samples = int(model.adata.n_obs)

    def one_step_stats(batch_size, key):
        config = svi.SVIConfig(batch_size=batch_size, delay=1.0)
        step_fn = svi.make_svi_step(n_samples, config)
        state = step_fn(svi.svi_init(params), data["X"], key)
        return state.stat_observed, state.stat_predicted, state.stat_counts

    # full batch = the exact statistics (rho=1 writes them verbatim)
    exact = one_step_stats(n_samples, jax.random.PRNGKey(0))

    keys = jax.random.split(jax.random.PRNGKey(1), 512)
    sampled = jax.jit(
        jax.vmap(lambda key: one_step_stats(12, key))
    )(keys)

    for estimate, truth, name in zip(
        sampled, exact, ("observed", "predicted", "counts")
    ):
        mean = np.asarray(jnp.mean(estimate, axis=0))
        np.testing.assert_allclose(
            mean, np.asarray(truth), rtol=0.05, err_msg=name
        )


# --------------------------------------------------------------------- #
# KLNMF online NMF
# --------------------------------------------------------------------- #


from salamander_tpu.models import KLNMF  # noqa: E402
from salamander_tpu.ops import klnmf as klops  # noqa: E402


@pytest.fixture(scope="module")
def kl_state():
    """KLNMF device state on synthetic counts (kernel orientation)."""
    X = make_synthetic(n_samples=60, n_features=24, seed=1)
    model = KLNMF(n_signatures=3)
    model._setup_adata(AnnData(X.copy()))
    model._initialize(init_kwargs={"seed": 5})
    model._setup_fitting_parameters()
    return model


@pytest.mark.parametrize("weighted", [False, True])
def test_klnmf_full_batch_rho_one_equals_serial_cycle(kl_state, weighted):
    """B=D, rho=1, h_inner_iters=1 == update_H followed by update_W (the
    serial Lee-Seung cycle), including weighted KL."""
    model = kl_state
    params, data = model._device_state()
    D = int(model.adata.n_obs)
    if weighted:
        data = dict(data)
        data["weights_kl"] = jnp.asarray(
            np.random.default_rng(0).uniform(0.5, 2.0, D)
        )

    H_new = klops.update_H(
        data["X"], params["W"], params["H"], data.get("weights_kl")
    )
    W_new = klops.update_W(
        data["X"], params["W"], H_new, data.get("weights_kl")
    )

    step_fn = svi.make_klnmf_svi_step(
        D, svi.SVIConfig(batch_size=D, delay=1.0)
    )
    state = jax.jit(step_fn)(
        svi.klnmf_svi_init(params), data, jax.random.PRNGKey(0)
    )
    np.testing.assert_allclose(
        np.asarray(state.params["H"]), np.asarray(H_new),
        rtol=1e-10, err_msg="H",
    )
    np.testing.assert_allclose(
        np.asarray(state.params["W"]), np.asarray(W_new),
        rtol=1e-10, err_msg="W",
    )


def test_klnmf_full_batch_anchor_with_lhalf_sparsity(kl_state):
    """The exactness anchor also holds under the l1/2 sparsity closed form
    (it only alters the local H update, which the online step reuses)."""
    model = kl_state
    params, data = model._device_state()
    D = int(model.adata.n_obs)
    data = dict(data)
    data["weights_lhalf"] = jnp.asarray(
        np.random.default_rng(2).uniform(0.1, 1.0, D)
    )

    H_new = klops.update_H(
        data["X"], params["W"], params["H"],
        weights_lhalf=data["weights_lhalf"],
    )
    W_new = klops.update_W(data["X"], params["W"], H_new)

    step_fn = svi.make_klnmf_svi_step(
        D, svi.SVIConfig(batch_size=D, delay=1.0)
    )
    state = jax.jit(step_fn)(
        svi.klnmf_svi_init(params), data, jax.random.PRNGKey(0)
    )
    np.testing.assert_allclose(
        np.asarray(state.params["H"]), np.asarray(H_new), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(state.params["W"]), np.asarray(W_new), rtol=1e-10
    )


def test_run_svi_remainder_steps(fitted_state):
    """n_steps not divisible by eval_freq: the remainder steps still run
    (step counter reaches n_steps; history has floor(n/freq) entries)."""
    model = fitted_state
    params, data = model._device_state()
    step_fn = svi.make_svi_step(
        int(model.adata.n_obs), svi.SVIConfig(batch_size=16)
    )
    state, history = svi.run_svi(
        step_fn, svi.svi_init(params), data["X"], jax.random.PRNGKey(0),
        n_steps=47, eval_freq=20,
    )
    assert history.shape == (2,)
    assert int(state.step) == 47


def test_klnmf_minibatch_steps_reduce_objective(kl_state):
    model = kl_state
    params, data = model._device_state()
    state0 = svi.klnmf_svi_init(params)
    obj0 = float(svi.klnmf_full_objective(state0.params, data))

    step_fn = svi.make_klnmf_svi_step(
        int(model.adata.n_obs), svi.SVIConfig(batch_size=16, delay=20.0),
        h_inner_iters=2,
    )
    state, trace = svi.run_svi(
        step_fn, state0, data, jax.random.PRNGKey(0),
        n_steps=800, eval_freq=100, elbo_fn=svi.klnmf_full_objective,
    )
    trace = np.asarray(trace)
    assert trace.shape == (8,)
    assert np.all(np.isfinite(trace))
    obj_final = float(svi.klnmf_full_objective(state.params, data))
    assert obj_final < obj0
    assert trace[-1] < trace[0]  # KL objective decreases

    # within 2% of a same-budget full-batch fit's objective
    batch = KLNMF(n_signatures=3, min_iterations=10, max_iterations=100,
                  tol=0.0)
    batch.fit(AnnData(np.asarray(data["X"]).T.copy()),
              init_kwargs={"seed": 5})
    obj_batch = batch.history["objective_function"][-1]
    assert obj_final < obj_batch + 0.02 * abs(obj_batch)


def test_klnmf_fit_minibatch_model_api():
    X = make_synthetic(n_samples=60, n_features=24, seed=8)
    model = KLNMF(n_signatures=2)
    model.fit_minibatch(
        AnnData(X.copy()), batch_size=20, n_steps=120, eval_freq=30,
        seed=1, init_kwargs={"seed": 2},
        fitting_kwargs={"weights_kl": 1.5},
    )
    assert model._is_fitted
    assert len(model.history["objective_function"]) == 4
    assert model.history["step_freq"] == 30
    # signatures sum to one over features (container orientation: K x V)
    np.testing.assert_allclose(
        model.asignatures.X.sum(axis=1), 1.0, rtol=1e-5
    )
    assert np.all(np.isfinite(model.adata.obsm["exposures"]))


def test_klnmf_fit_minibatch_given_signatures_frozen():
    X = make_synthetic(n_samples=40, n_features=24, seed=3)
    donor = KLNMF(n_signatures=2)
    donor_adata = AnnData(X.copy())
    donor._setup_adata(donor_adata)
    donor._initialize(init_kwargs={"seed": 7})
    given_sigs = donor.asignatures[:1].copy()

    model = KLNMF(n_signatures=3)
    model.fit_minibatch(
        AnnData(X.copy()), batch_size=16, n_steps=60, eval_freq=30,
        seed=0, given_parameters={"asignatures": given_sigs},
        init_kwargs={"seed": 4},
    )
    np.testing.assert_array_equal(
        model.asignatures.X[0], given_sigs.X[0]
    )
    assert not np.array_equal(model.asignatures.X[1], given_sigs.X[0])


# --------------------------------------------------------------------- #
# multimodal
# --------------------------------------------------------------------- #


def make_mm_model(seed=0, n_samples=50):
    from salamander_tpu.containers import MuData
    from salamander_tpu.models import MultimodalCorrNMF

    rng = np.random.default_rng(seed)
    mods = {}
    for name, n_features in (("sbs", 20), ("indel", 12)):
        signatures = rng.dirichlet(np.full(n_features, 0.5), size=2)
        exposures = rng.gamma(2.0, 40.0, size=(n_samples, 2))
        X = rng.poisson(exposures @ signatures).astype(float)
        X[X == 0] = 1.0
        mods[name] = X
    from salamander_tpu.containers import AnnData

    mdata = MuData({name: AnnData(X) for name, X in mods.items()})
    model = MultimodalCorrNMF(ns_signatures=[2, 2], dim_embeddings=2)
    return model, mdata


def test_mm_full_batch_rho_one_equals_em_cycle():
    model, mdata = make_mm_model()
    model._setup_mdata(mdata)
    model._initialize(init_kwargs={"seed": 4})
    params, data = model._device_state()
    update_fn, _ = model._build_step()
    expected = update_fn(params, data)

    config = svi.SVIConfig(
        batch_size=int(model.mdata.n_obs),
        delay=1.0,
        signature_newton_iters=100,
    )
    step_fn = svi.make_mm_svi_step(
        int(model.mdata.n_obs), model.mod_names, model.ns_signatures, config
    )
    state = svi.mm_svi_init(params)
    state = jax.jit(step_fn)(state, data["X"], jax.random.PRNGKey(9))

    np.testing.assert_allclose(
        np.asarray(state.params["sample_embeddings"]),
        np.asarray(expected["sample_embeddings"]),
        rtol=1e-8, atol=1e-10,
    )
    np.testing.assert_allclose(
        float(state.params["variance"]), float(expected["variance"]),
        rtol=1e-10,
    )
    for name in model.mod_names:
        for field in ("signatures", "signature_scalings",
                      "sample_scalings", "signature_embeddings"):
            np.testing.assert_allclose(
                np.asarray(state.params["mods"][name][field]),
                np.asarray(expected["mods"][name][field]),
                rtol=1e-8, atol=1e-10,
                err_msg=f"{name}/{field}",
            )


def test_mm_fit_minibatch_model_api():
    model, mdata = make_mm_model(seed=3)
    model.fit_minibatch(
        mdata, batch_size=16, n_steps=150, eval_freq=50, seed=2,
        init_kwargs={"seed": 1},
    )
    assert model._is_fitted
    hist = model.history["objective_function"]
    assert len(hist) == 3
    assert np.all(np.isfinite(hist))
    assert hist[-1] > hist[0]
    for name in model.mod_names:
        sigs = model.asignatures[name].X
        np.testing.assert_allclose(sigs.sum(axis=1), 1.0, rtol=1e-5)
        assert model.mdata[name].obsm["exposures"].shape == (50, 2)
    assert model.mdata.obsm["embeddings"].shape == (50, 2)


def test_mm_fit_minibatch_given_parameters_frozen():
    model, mdata = make_mm_model(seed=6)
    sig_scalings = np.array([0.25, -0.5])
    model.fit_minibatch(
        mdata, batch_size=16, n_steps=60, eval_freq=30, seed=0,
        given_parameters={"sbs": {"signature_scalings": sig_scalings}},
        init_kwargs={"seed": 8},
    )
    np.testing.assert_array_equal(
        np.asarray(model.asignatures["sbs"].obs["scalings"], float),
        sig_scalings,
    )
    assert not np.array_equal(
        np.asarray(model.asignatures["indel"].obs["scalings"], float),
        sig_scalings,
    )


def test_step_builders_are_cached_no_retrace():
    """Repeated fit_minibatch calls with identical shapes/config must reuse
    ONE compiled run_svi program: the step builders are lru_cached so the
    jit's static step_fn argument is the same object across calls (a fresh
    closure per call would retrace and recompile every call)."""
    from salamander_tpu.ops import svi

    config = svi.SVIConfig(batch_size=16, forgetting=0.6, delay=2.0)
    assert svi.make_svi_step(100, config) is svi.make_svi_step(100, config)
    assert svi.make_klnmf_svi_step(100, config) is svi.make_klnmf_svi_step(
        100, config
    )
    assert svi.make_mm_svi_step(
        100, ["a", "b"], [2, 3], config,
        mod_flags={"a": {"n_given": 1}},
    ) is svi.make_mm_svi_step(
        100, ["a", "b"], [2, 3], config,
        mod_flags={"a": {"n_given": 1}},
    )
    # different flags must NOT collide
    assert svi.make_svi_step(100, config) is not svi.make_svi_step(
        100, config, fix_variance=True
    )

    # end to end: the second identical fit_minibatch adds no jit cache entry
    X = make_synthetic(seed=13)
    def run_once():
        model = CorrNMFDet(n_signatures=2, dim_embeddings=2)
        model.fit_minibatch(
            AnnData(X.copy()), batch_size=20, n_steps=12, eval_freq=6,
            seed=1, init_kwargs={"seed": 2},
        )
        return model

    first = run_once()
    size_after_first = svi.run_svi._cache_size()
    second = run_once()
    assert svi.run_svi._cache_size() == size_after_first
    np.testing.assert_array_equal(
        first.adata.obsm["exposures"], second.adata.obsm["exposures"]
    )


# --------------------------------------------------------------------- #
# program-kill guard: run_svi_guarded == run_svi, segment by segment
# --------------------------------------------------------------------- #


def test_run_svi_guarded_segmented_matches_monolithic(fitted_state):
    """A forced tiny program budget chops the run into one-block segments;
    the chained segments must reproduce the monolithic program exactly
    (same step sequence, same key splits, evals at the same positions) -
    including a non-divisible remainder tail. CPU, so bitwise."""
    model = fitted_state
    params, data = model._device_state()
    n_samples = int(model.adata.n_obs)
    config = svi.SVIConfig(batch_size=16)
    step_fn = svi.make_svi_step(n_samples, config)

    state0 = svi.svi_init(params)
    key = jax.random.PRNGKey(7)
    mono_state, mono_hist = svi.run_svi(
        step_fn, state0, data["X"], key, n_steps=130, eval_freq=40,
    )
    seg_state, seg_hist = svi.run_svi_guarded(
        step_fn, state0, data["X"], key, n_steps=130, eval_freq=40,
        batch_size=16, n_samples=n_samples, program_seconds=1e-9,
    )
    np.testing.assert_array_equal(
        np.asarray(mono_hist), np.asarray(seg_hist)
    )
    for name in mono_state.params:
        np.testing.assert_array_equal(
            np.asarray(mono_state.params[name]),
            np.asarray(seg_state.params[name]),
            err_msg=name,
        )
    np.testing.assert_array_equal(
        np.asarray(mono_state.perm), np.asarray(seg_state.perm)
    )
    assert int(mono_state.step) == int(seg_state.step) == 130


def test_run_svi_guarded_eval_free_and_safe_paths(kl_state):
    """eval_freq=0 runs segment raw steps; a generous budget defers to the
    monolithic program. Both must equal run_svi bitwise (CPU)."""
    model = kl_state
    params, data = model._device_state()
    n_samples = int(model.adata.n_obs)
    config = svi.SVIConfig(batch_size=16, forgetting=0.51)
    step_fn = svi.make_klnmf_svi_step(n_samples, config)

    state0 = svi.klnmf_svi_init(params)
    key = jax.random.PRNGKey(3)
    mono_state, mono_hist = svi.run_svi(
        step_fn, state0, data, key, n_steps=25, eval_freq=0,
        elbo_fn=svi.klnmf_full_objective,
    )
    assert mono_hist.shape == (0,)
    for budget in (1e-9, 1e9):  # forced segmentation vs safe-deferral
        state, hist = svi.run_svi_guarded(
            step_fn, state0, data, key, n_steps=25, eval_freq=0,
            elbo_fn=svi.klnmf_full_objective,
            batch_size=16, n_samples=n_samples, program_seconds=budget,
        )
        assert hist.shape == (0,)
        np.testing.assert_array_equal(
            np.asarray(mono_state.params["W"]), np.asarray(state.params["W"])
        )
        np.testing.assert_array_equal(
            np.asarray(mono_state.params["H"]), np.asarray(state.params["H"])
        )

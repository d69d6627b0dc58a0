"""K-padded rank scans: masked lanes must behave exactly like unpadded fits.

The masked step functions (ops/klnmf.py make_masked_step_functions) let many
ranks share one compiled program; these tests pin that padding is inert -
a rank-k lane inside a K-padded program produces the same updates, losses
and convergence behavior as the plain rank-k program.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from salamander_tpu.engine import FitConfig
from salamander_tpu.ops import klnmf as ops
from salamander_tpu.parallel.restarts import rank_scan_klnmf


def problem(V=12, D=20, k=3, seed=0):
    rng = np.random.default_rng(seed)
    Wt = rng.dirichlet(np.ones(V), size=k).T
    Ht = rng.gamma(2.0, 50.0, size=(k, D))
    X = np.clip(rng.poisson(Wt @ Ht), np.finfo(np.float32).eps, None)
    W0 = rng.dirichlet(np.ones(V), size=k).T
    H0 = rng.uniform(0.5, 2.0, size=(k, D)) * X.sum(0) / k
    return jnp.asarray(X), jnp.asarray(W0), jnp.asarray(H0)


def test_pad_rank_shapes_and_mask():
    _, W, H = problem()
    W_pad, H_pad, mask = ops.pad_rank(W, H, 8)
    assert W_pad.shape == (12, 8) and H_pad.shape == (8, 20)
    assert mask.tolist() == [True] * 3 + [False] * 5
    np.testing.assert_array_equal(np.asarray(H_pad[3:]), 0.0)
    with pytest.raises(ValueError):
        ops.pad_rank(W, H, 2)


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_update_equals_unpadded(weighted):
    X, W, H = problem()
    data = {"X": X}
    if weighted:
        data["weights_kl"] = jnp.linspace(0.5, 2.0, X.shape[1])
        data["weights_lhalf"] = jnp.linspace(0.0, 1.0, X.shape[1])
    plain_update, plain_objective = ops.make_step_functions()
    masked_update, masked_objective = ops.make_masked_step_functions()

    W_pad, H_pad, mask = ops.pad_rank(W, H, 8)
    plain = {"W": W, "H": H}
    masked = {"W": W_pad, "H": H_pad, "mask": mask}
    for _ in range(5):
        plain = plain_update(plain, data)
        masked = masked_update(masked, data)
        np.testing.assert_allclose(
            np.asarray(masked["W"][:, :3]), np.asarray(plain["W"]), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(masked["H"][:3]), np.asarray(plain["H"]), rtol=1e-12
        )
        np.testing.assert_array_equal(np.asarray(masked["H"][3:]), 0.0)
        np.testing.assert_allclose(
            float(masked_objective(masked, data)),
            float(plain_objective(plain, data)),
            rtol=1e-12,
        )


def test_masked_update_respects_given_signatures():
    X, W, H = problem()
    data = {"X": X}
    update_fn, _ = ops.make_masked_step_functions(n_given_signatures=2)
    W_pad, H_pad, mask = ops.pad_rank(W, H, 8)
    out = update_fn({"W": W_pad, "H": H_pad, "mask": mask}, data)
    np.testing.assert_array_equal(np.asarray(out["W"][:, :2]),
                                  np.asarray(W[:, :2]))
    assert not np.array_equal(np.asarray(out["W"][:, 2]), np.asarray(W[:, 2]))


def test_padded_rank_scan_matches_unpadded():
    rng = np.random.default_rng(3)
    X = np.clip(
        rng.poisson(30.0, size=(16, 24)).astype(np.float64),
        np.finfo(np.float32).eps, None,
    )
    config = FitConfig(min_iterations=20, max_iterations=200,
                       conv_test_freq=10, tol=1e-6)
    ranks = range(2, 6)
    padded = rank_scan_klnmf(X, ranks, n_restarts=4, seed=11, config=config,
                             dtype=jnp.float64, pad_ranks=True, rank_bucket=4)
    plain = rank_scan_klnmf(X, ranks, n_restarts=4, seed=11, config=config,
                            dtype=jnp.float64, pad_ranks=False)
    assert sorted(padded) == sorted(plain) == list(ranks)
    for k in ranks:
        np.testing.assert_allclose(padded[k].losses, plain[k].losses,
                                   rtol=1e-9)
        np.testing.assert_array_equal(padded[k].n_iterations,
                                      plain[k].n_iterations)
        assert padded[k].best_index == plain[k].best_index
        np.testing.assert_allclose(np.asarray(padded[k].W),
                                   np.asarray(plain[k].W), rtol=1e-9)
        assert np.asarray(padded[k].W).shape == (4, 16, k)


def test_padded_rank_scan_under_mesh():
    import jax

    from salamander_tpu.parallel import make_mesh

    rng = np.random.default_rng(4)
    X = np.clip(
        rng.poisson(30.0, size=(8, 16)).astype(np.float32),
        np.finfo(np.float32).eps, None,
    )
    mesh = make_mesh(jax.devices("cpu")[:4], sample_ways=2)
    config = FitConfig(min_iterations=10, max_iterations=50,
                       conv_test_freq=10, tol=0.0)
    results = rank_scan_klnmf(X, [2, 3], n_restarts=4, seed=0, config=config,
                              mesh=mesh, pad_ranks=True, rank_bucket=4)
    for k in (2, 3):
        assert np.all(np.isfinite(results[k].losses))
        assert np.asarray(results[k].W).shape == (4, 8, k)


# --------------------------------------------------------------------- #
# CorrNMF K-padding
# --------------------------------------------------------------------- #


def test_masked_corrnmf_cycles_equal_unpadded():
    """A rank-k CorrNMF lane padded to Kp runs the rank-k EM cycles up to
    dot-product rounding: padded exposures are exact zeros
    (NEG_PAD_SCALING underflow), but XLA picks different fma/reduction
    kernels for different contraction widths, so trajectories agree to
    ~1e-9 over short horizons (the branchy Newton amplifies ulps over long
    ones - convergence-level equivalence is pinned separately below)."""
    import jax

    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu.ops import corrnmf

    rng = np.random.default_rng(3)
    V, D, k = 18, 30, 2
    S = rng.dirichlet(np.ones(V), size=k)
    E = rng.gamma(2.0, 40.0, size=(D, k))
    X = np.clip(rng.poisson(E @ S).astype(float), 1.0, None)

    model = CorrNMFDet(n_signatures=k, dim_embeddings=2)
    model._setup_adata(AnnData(X.copy()))
    model._initialize(init_kwargs={"seed": 4})
    model._setup_fitting_parameters()
    params, data = model._device_state()

    plain_update, plain_obj = model._build_step()
    masked_update, masked_obj = corrnmf.make_masked_corrnmf_step()
    padded = corrnmf.pad_rank_corrnmf(params, 6)
    assert padded["signatures"].shape == (6, V)
    assert bool(np.all(np.asarray(padded["mask"])[:k]))
    assert not np.any(np.asarray(padded["mask"])[k:])

    p_plain, p_masked = params, padded
    plain_update = jax.jit(plain_update)
    masked_update = jax.jit(masked_update)
    for cycle in range(2):
        p_plain = plain_update(p_plain, data)
        p_masked = masked_update(p_masked, data)
        np.testing.assert_allclose(
            float(masked_obj(p_masked, data)),
            float(plain_obj(p_plain, data)),
            rtol=1e-9, err_msg=f"ELBO cycle {cycle}",
        )
    for name in ("signatures", "signature_scalings", "signature_embeddings",
                 "exposures"):
        active = np.asarray(p_masked[name])
        active = active[:k] if name != "exposures" else active[:, :k]
        np.testing.assert_allclose(
            active, np.asarray(p_plain[name]), rtol=1e-8, atol=1e-10,
            err_msg=name,
        )
    for name in ("sample_scalings", "sample_embeddings", "variance"):
        np.testing.assert_allclose(
            np.asarray(p_masked[name]), np.asarray(p_plain[name]),
            rtol=1e-8, atol=1e-10, err_msg=name,
        )
    # padded lanes stayed inert
    np.testing.assert_array_equal(
        np.asarray(p_masked["signature_embeddings"])[k:], 0.0
    )
    assert np.all(np.asarray(p_masked["exposures"])[:, k:] == 0.0)

    # convergence-level equivalence: run both programs to (near) fixed
    # point - final ELBOs agree far inside model-selection resolution
    def run_many(update, obj, p, n=150):
        update_j = jax.jit(
            lambda q: jax.lax.fori_loop(0, n, lambda _, r: update(r, data), q)
        )
        p = update_j(p)
        return float(obj(p, data)), p

    elbo_plain, _ = run_many(plain_update, plain_obj, p_plain)
    elbo_masked, p_final = run_many(masked_update, masked_obj, p_masked)
    np.testing.assert_allclose(elbo_masked, elbo_plain, rtol=1e-8)
    assert np.all(np.asarray(p_final["exposures"])[:, k:] == 0.0)


def test_rank_scan_corrnmf_padded_matches_unpadded():
    """The K-padded CorrNMF rank scan gives the same per-rank losses and
    best parameters as the one-program-per-rank path (same seeds)."""
    from salamander_tpu.engine import FitConfig
    from salamander_tpu.parallel import rank_scan_corrnmf

    rng = np.random.default_rng(0)
    V, D = 16, 24
    S = rng.dirichlet(np.ones(V), size=3)
    E = rng.gamma(2.0, 40.0, size=(D, 3))
    X = np.clip(rng.poisson(E @ S).astype(float), 1.0, None)

    config = FitConfig(min_iterations=20, max_iterations=40,
                       conv_test_freq=10, tol=0.0)
    padded = rank_scan_corrnmf(
        X, range(2, 5), dim_embeddings=2, n_restarts=2, base_seed=0,
        config=config, pad_ranks=True, rank_bucket=4,
    )
    plain = rank_scan_corrnmf(
        X, range(2, 5), dim_embeddings=2, n_restarts=2, base_seed=0,
        config=config, pad_ranks=False,
    )
    assert set(padded) == {2, 3, 4}
    for k in padded:
        np.testing.assert_allclose(
            padded[k].losses, plain[k].losses, rtol=1e-6,
            err_msg=f"k={k} losses",
        )
        assert padded[k].best_index == plain[k].best_index
        bp, pp = padded[k].best_params, plain[k].best_params
        assert bp["signatures"].shape == (k, V)
        assert bp["signature_embeddings"].shape == (k, 2)
        assert bp["exposures"].shape == (D, k)
        np.testing.assert_allclose(
            bp["signatures"], pp["signatures"], rtol=1e-5, atol=1e-8,
            err_msg=f"k={k} signatures",
        )


def _planted_counts(seed=3, V=18, D=30, k=2):
    rng = np.random.default_rng(seed)
    S = rng.dirichlet(np.ones(V), size=k)
    E = rng.gamma(2.0, 40.0, size=(D, k))
    return np.clip(rng.poisson(E @ S).astype(float), 1.0, None)


def test_masked_corrnmf_m_padding_cycles_equal_unpadded():
    """A rank-k, dim-m lane padded to (Kp, mp) runs the (k, m) EM cycles:
    zero-padded embedding dimensions have identically zero gradient and a
    block-diagonal Hessian row, so they stay exactly zero and every
    contraction equals its m-dimensional value (pad_rank_corrnmf). Same
    trajectory-level tolerance as K-padding (XLA kernel selection differs
    per contraction width)."""
    import jax

    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu.ops import corrnmf

    X = _planted_counts()
    k, m = 2, 2
    model = CorrNMFDet(n_signatures=k, dim_embeddings=m)
    model._setup_adata(AnnData(X.copy()))
    model._initialize(init_kwargs={"seed": 4})
    model._setup_fitting_parameters()
    params, data = model._device_state()

    plain_update, plain_obj = model._build_step()
    masked_update, masked_obj = corrnmf.make_masked_corrnmf_step()
    padded = corrnmf.pad_rank_corrnmf(params, 6, dim_padded=4)
    assert padded["signature_embeddings"].shape == (6, 4)
    assert padded["sample_embeddings"].shape == (X.shape[0], 4)
    assert np.asarray(padded["m_mask"]).tolist() == [True, True, False, False]

    p_plain, p_masked = params, padded
    plain_update = jax.jit(plain_update)
    masked_update = jax.jit(masked_update)
    for cycle in range(3):
        p_plain = plain_update(p_plain, data)
        p_masked = masked_update(p_masked, data)
        np.testing.assert_allclose(
            float(masked_obj(p_masked, data)),
            float(plain_obj(p_plain, data)),
            rtol=1e-9, err_msg=f"ELBO cycle {cycle}",
        )
        # padded dimensions stay EXACTLY zero
        np.testing.assert_array_equal(
            np.asarray(p_masked["signature_embeddings"])[:, m:], 0.0
        )
        np.testing.assert_array_equal(
            np.asarray(p_masked["sample_embeddings"])[:, m:], 0.0
        )
    np.testing.assert_allclose(
        np.asarray(p_masked["signature_embeddings"])[:k, :m],
        np.asarray(p_plain["signature_embeddings"]),
        rtol=1e-7, atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(p_masked["sample_embeddings"])[:, :m],
        np.asarray(p_plain["sample_embeddings"]),
        rtol=1e-7, atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(p_masked["variance"]), np.asarray(p_plain["variance"]),
        rtol=1e-8,
    )


def test_corrnmf_grid_scan_matches_fixed_m_scans():
    """The (k, m) grid scan returns per-point results matching separate
    fixed-m scans (same seeds per grid offset ordering), with fitted models
    exposing the full model surface."""
    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu.parallel import rank_scan_corrnmf

    X = _planted_counts(seed=0, V=16, D=24, k=3)
    config = FitConfig(min_iterations=20, max_iterations=40,
                       conv_test_freq=10, tol=0.0)
    grid = rank_scan_corrnmf(
        X, range(2, 4), dim_embeddings_range=[2, 3], n_restarts=2,
        base_seed=0, config=config, pad_ranks=True, rank_bucket=4,
        dim_bucket=2,
    )
    assert set(grid) == {(2, 2), (3, 2), (2, 3), (3, 3)}
    # m-major offset ordering: the m=2 row of the grid has offsets 0,1 -
    # exactly a fixed-m scan's offsets
    fixed = rank_scan_corrnmf(
        X, range(2, 4), dim_embeddings=2, n_restarts=2, base_seed=0,
        config=config, pad_ranks=False,
    )
    for k in (2, 3):
        np.testing.assert_allclose(
            grid[(k, 2)].losses, fixed[k].losses, rtol=1e-6,
            err_msg=f"k={k}",
        )
    # the fitted model surface
    for (k, m), res in grid.items():
        model = res.model
        assert isinstance(model, CorrNMFDet)
        assert model._is_fitted
        assert model.n_signatures == k and model.dim_embeddings == m
        assert model.asignatures.X.shape == (k, X.shape[1])
        assert model.asignatures.obsm["embeddings"].shape == (k, m)
        assert model.adata.obsm["embeddings"].shape == (X.shape[0], m)
        assert model.exposures.shape == (X.shape[0], k)
        assert len(model.history["objective_function"]) > 0
        # the absorbed winner evaluates to the recorded loss
        np.testing.assert_allclose(
            model.objective_function(), res.best_loss, rtol=1e-6,
        )


def test_corrnmf_scan_under_mesh_matches_unmeshed():
    """Lane sharding over the mesh 'restarts' axis must not change any
    scan result (communication is only the final argmax)."""
    import jax

    from salamander_tpu.parallel import make_mesh, rank_scan_corrnmf

    X = _planted_counts(seed=1, V=14, D=22, k=2)
    config = FitConfig(min_iterations=10, max_iterations=20,
                       conv_test_freq=10, tol=0.0)
    mesh = make_mesh(jax.devices("cpu")[:4], sample_ways=2)
    kwargs = dict(
        n_signatures_range=range(2, 4), dim_embeddings=2, n_restarts=2,
        base_seed=0, config=config, pad_ranks=True, rank_bucket=4,
        build_models=False,
    )
    plain = rank_scan_corrnmf(X, **kwargs)
    meshed = rank_scan_corrnmf(X, mesh=mesh, **kwargs)
    for k in plain:
        np.testing.assert_allclose(
            meshed[k].losses, plain[k].losses, rtol=1e-9, err_msg=f"k={k}"
        )
        np.testing.assert_allclose(
            meshed[k].best_params["signatures"],
            plain[k].best_params["signatures"],
            rtol=1e-7, atol=1e-10,
        )


def test_corrnmf_scan_model_factory_override():
    """model_factory drives both the lane init and the winner class."""
    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu.parallel import rank_scan_corrnmf

    X = _planted_counts(seed=2, V=12, D=18, k=2)
    config = FitConfig(min_iterations=10, max_iterations=20,
                       conv_test_freq=10, tol=0.0)

    calls = []

    def factory(k, m):
        calls.append((k, m))
        return CorrNMFDet(n_signatures=k, dim_embeddings=m,
                          init_method="random")

    results = rank_scan_corrnmf(
        X, [2], dim_embeddings=3, n_restarts=2, config=config,
        model_factory=factory,
    )
    assert (2, 3) in calls
    assert results[2].model.init_method == "random"
    assert results[2].model.dim_embeddings == 3


def test_masked_mvnmf_update_equals_unpadded():
    """A rank-k MvNMF lane padded to Kp runs the rank-k iteration: padded H
    rows are exact zeros, the volume term and the (Kp, Kp) Gram inverse see
    identity padding (block-diagonal logdet/inverse restrict exactly), and
    the line search walks the same gamma trajectory. Tolerance-level pin
    (the padded Cholesky/logdet lower differently than the k x k ones)."""
    import jax

    from salamander_tpu.ops import mvnmf as mv

    X, W, H = problem(V=14, D=22, k=3, seed=5)
    lam, delta = 1.0, 1.0
    gamma = jnp.asarray(1.0, X.dtype)

    def plain_update(W, H, gamma):
        H = ops.update_H(X, W, H)
        W_unc = mv.update_W_unconstrained(X, W, H, lam, delta)
        return mv.line_search(X, W, H, lam, delta, gamma, W_unc)

    masked_update, masked_obj = mv.make_masked_step_functions(lam, delta)
    W_pad, H_pad, mask = ops.pad_rank(W, H, 6)
    params = {"W": W_pad, "H": H_pad, "gamma": gamma, "mask": mask}
    data = {"X": X}

    plain_jit = jax.jit(plain_update)
    masked_jit = jax.jit(masked_update)
    Wp, Hp, gp = W, H, gamma
    for cycle in range(5):
        Wp, Hp, gp = plain_jit(Wp, Hp, gp)
        params = masked_jit(params, data)
        np.testing.assert_allclose(
            float(masked_obj(params, data)),
            float(mv.kl_divergence_penalized(X, Wp, Hp, lam, delta)),
            rtol=1e-9, err_msg=f"objective cycle {cycle}",
        )
    np.testing.assert_allclose(
        np.asarray(params["W"])[:, :3], np.asarray(Wp), rtol=1e-7, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(params["H"])[:3], np.asarray(Hp), rtol=1e-7, atol=1e-10
    )
    np.testing.assert_allclose(
        float(params["gamma"]), float(gp), rtol=1e-9
    )
    # padding stayed inert: H rows exact zeros, W columns untouched
    np.testing.assert_array_equal(np.asarray(params["H"])[3:], 0.0)
    np.testing.assert_array_equal(
        np.asarray(params["W"])[:, 3:], np.asarray(W_pad)[:, 3:]
    )


def test_rank_scan_mvnmf_padded_matches_unpadded():
    """The K-padded MvNMF rank scan gives the same per-rank losses and best
    signatures as one-program-per-rank (same seeds), sharing compiled
    programs per bucket."""
    from salamander_tpu.parallel import rank_scan_mvnmf

    X, _, _ = problem(V=14, D=22, k=3, seed=0)
    X = np.asarray(X)
    config = FitConfig(min_iterations=20, max_iterations=40,
                       conv_test_freq=10, tol=0.0)
    padded = rank_scan_mvnmf(
        X, range(2, 6), n_restarts=3, seed=0, config=config,
        pad_ranks=True, rank_bucket=4,
    )
    plain = rank_scan_mvnmf(
        X, range(2, 6), n_restarts=3, seed=0, config=config,
        pad_ranks=False,
    )
    assert set(padded) == {2, 3, 4, 5}
    for k in padded:
        np.testing.assert_allclose(
            padded[k].losses, plain[k].losses, rtol=1e-5,
            err_msg=f"k={k} losses",
        )
        assert padded[k].best_index == plain[k].best_index
        assert padded[k].W.shape == (3, 14, k)
        np.testing.assert_allclose(
            np.asarray(padded[k].best_W), np.asarray(plain[k].best_W),
            rtol=1e-4, atol=1e-7, err_msg=f"k={k} best W",
        )
    # objective decreased and is the MINIMIZED penalized KL
    for k in padded:
        assert padded[k].best_loss <= float(np.max(padded[k].losses))


def test_rank_scan_mvnmf_pack_points_invariant():
    """Packing several ranks into one lockstep call vs one call per rank
    must not change any result (per-lane freezing makes each lane's
    trajectory independent of its call's co-tenants) - only wall time
    differs (packing a convergence-based scan makes fast ranks run the
    slow ranks' iterations, hence the auto policy packs fixed-length runs
    only)."""
    from salamander_tpu.parallel import rank_scan_mvnmf

    X, _, _ = problem(V=14, D=22, k=3, seed=1)
    X = np.asarray(X)
    # convergence-based: lanes finish at different iterations
    config = FitConfig(min_iterations=10, max_iterations=200,
                       conv_test_freq=10, tol=1e-4)
    packed = rank_scan_mvnmf(
        X, range(2, 6), n_restarts=2, seed=0, config=config,
        rank_bucket=4, pack_points=True,
    )
    per_point = rank_scan_mvnmf(
        X, range(2, 6), n_restarts=2, seed=0, config=config,
        rank_bucket=4, pack_points=False,
    )
    for k in packed:
        np.testing.assert_array_equal(
            packed[k].n_iterations, per_point[k].n_iterations,
            err_msg=f"k={k} iteration counts",
        )
        np.testing.assert_allclose(
            packed[k].losses, per_point[k].losses, rtol=1e-12,
            err_msg=f"k={k} losses",
        )
        np.testing.assert_allclose(
            np.asarray(packed[k].W), np.asarray(per_point[k].W),
            rtol=1e-12, err_msg=f"k={k} W",
        )


def test_rank_scan_mvnmf_under_mesh():
    """Restart sharding over the mesh must not change MvNMF scan results."""
    import jax

    from salamander_tpu.parallel import make_mesh, rank_scan_mvnmf

    X, _, _ = problem(V=12, D=16, k=2, seed=7)
    X = np.asarray(X)
    config = FitConfig(min_iterations=10, max_iterations=20,
                       conv_test_freq=10, tol=0.0)
    mesh = make_mesh(jax.devices("cpu")[:4], sample_ways=2)
    plain = rank_scan_mvnmf(X, range(2, 4), n_restarts=2, seed=0,
                            config=config)
    meshed = rank_scan_mvnmf(X, range(2, 4), n_restarts=2, seed=0,
                             config=config, mesh=mesh)
    for k in plain:
        np.testing.assert_allclose(
            meshed[k].losses, plain[k].losses, rtol=1e-6, err_msg=f"k={k}"
        )

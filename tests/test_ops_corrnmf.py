"""Parity of the CorrNMF kernels against the reference goldens: exposures,
aux sufficient statistic, ELBO, closed-form scalings, the vmap-batched Newton
embedding updates (vs scipy Newton-CG, incl. the maxiter=3 sample cap), and
the variance M-step."""

import numpy as np
import pandas as pd
import pytest

from salamander_tpu.ops import corrnmf, klnmf


@pytest.fixture(scope="module")
def data_dir(reference_data_path):
    return reference_data_path / "models" / "corrnmf"


@pytest.fixture(params=[(1, 1), (2, 2)], ids=["nsigs1_dim1", "nsigs2_dim2"])
def state(request, data_dir):
    nsigs, dim = request.param
    sfx = f"nsigs{nsigs}_dim{dim}.npy"

    def load(name):
        return np.load(data_dir / f"{name}_{sfx}")

    counts = pd.read_csv(data_dir / "counts.csv", index_col=0).T
    return {
        "sfx": sfx,
        "load": load,
        "X": counts.values.astype(float),                # (D, V)
        "signatures": load("signatures_mat_init").T,     # (K, V)
        "signature_scalings": load("signature_scalings_init"),
        "sample_scalings": load("sample_scalings_init"),
        "signature_embeddings": load("signature_embeddings_init").T,  # (K, m)
        "sample_embeddings": load("sample_embeddings_init").T,        # (D, m)
        "variance": float(load("variance_init")),
        "aux": load("aux"),
    }


def exposures_of(state):
    return np.asarray(
        corrnmf.compute_exposures(
            state["signature_scalings"],
            state["sample_scalings"],
            state["signature_embeddings"],
            state["sample_embeddings"],
        )
    )


def test_host_exposures_twin_matches_device_op(state):
    """utils.compute_exposures_numpy (the eager container-refresh path, used
    to avoid a device round-trip at COSMIC scale) must equal the
    device kernel."""
    from salamander_tpu.utils import compute_exposures_numpy

    np.testing.assert_allclose(
        compute_exposures_numpy(
            state["signature_scalings"],
            state["sample_scalings"],
            state["signature_embeddings"],
            state["sample_embeddings"],
        ),
        exposures_of(state),
        rtol=1e-12,
    )


def test_compute_aux(state):
    aux = corrnmf.compute_aux(state["X"], state["signatures"], exposures_of(state))
    assert np.allclose(aux, state["aux"])


def test_elbo(state):
    expected = state["load"]("objective_init")
    elbo = corrnmf.elbo_corrnmf(
        state["X"],
        state["signatures"],
        exposures_of(state),
        state["signature_embeddings"],
        state["sample_embeddings"],
        state["variance"],
    )
    assert np.allclose(elbo, expected)


def test_update_signature_scalings(state):
    expected = state["load"]("signature_scalings_updated")
    result = corrnmf.update_signature_scalings(
        state["aux"],
        state["sample_scalings"],
        state["signature_embeddings"],
        state["sample_embeddings"],
    )
    assert np.allclose(result, expected)


def test_update_sample_scalings(state):
    expected = state["load"]("sample_scalings_updated")
    result = corrnmf.update_sample_scalings(
        state["X"],
        state["signature_scalings"],
        state["signature_embeddings"],
        state["sample_embeddings"],
    )
    assert np.allclose(result, expected)


def test_update_signature_embeddings(state):
    """Full-convergence Newton must land on scipy Newton-CG's optimum."""
    expected = state["load"]("signature_embeddings_updated").T
    result = corrnmf.update_embeddings(
        state["signature_embeddings"],
        state["sample_embeddings"],
        state["signature_scalings"],
        state["sample_scalings"],
        state["variance"],
        state["aux"],
        max_iter=100,
    )
    assert np.allclose(result, expected)


def test_update_sample_embeddings_maxiter3(state):
    """Three batched Newton steps reproduce scipy Newton-CG with maxiter=3."""
    expected = state["load"]("sample_embeddings_updated").T
    result = corrnmf.update_embeddings(
        state["sample_embeddings"],
        state["signature_embeddings"],
        state["sample_scalings"],
        state["signature_scalings"],
        state["variance"],
        state["aux"].T,
        max_iter=3,
    )
    assert np.allclose(result, expected)


def test_update_variance(state):
    expected = state["load"]("variance_updated")
    result = corrnmf.update_variance(
        state["signature_embeddings"], state["sample_embeddings"]
    )
    assert np.allclose(result, expected)


def test_update_signatures(state):
    expected = state["load"]("signatures_mat_updated").T
    W_new = klnmf.update_W(state["X"].T, state["signatures"].T, exposures_of(state).T)
    assert np.allclose(np.asarray(W_new).T, expected)


def test_embedding_update_improves_surrogate(state):
    """Each updated embedding must not worsen its own surrogate objective."""
    aux = state["aux"]
    updated = np.asarray(
        corrnmf.update_embeddings(
            state["signature_embeddings"],
            state["sample_embeddings"],
            state["signature_scalings"],
            state["sample_scalings"],
            state["variance"],
            aux,
            max_iter=50,
        )
    )
    for k in range(updated.shape[0]):
        before = float(
            corrnmf.embedding_objective(
                state["signature_embeddings"][k],
                state["sample_embeddings"],
                state["signature_scalings"][k],
                state["sample_scalings"],
                state["variance"],
                aux[k],
            )
        )
        after = float(
            corrnmf.embedding_objective(
                updated[k],
                state["sample_embeddings"],
                state["signature_scalings"][k],
                state["sample_scalings"],
                state["variance"],
                aux[k],
            )
        )
        assert after <= before + 1e-10 * abs(before)


def test_multimodal_vector_scalings_shape():
    """The joint sample update accepts per-row scaling VECTORS (multimodal)."""
    rng = np.random.default_rng(0)
    n, m, dim = 5, 4, 2
    emb0 = rng.normal(size=(n, dim))
    others = rng.normal(size=(m, dim))
    scalings_vec = rng.normal(size=(n, m)) * 0.1
    scalings_other = rng.normal(size=m) * 0.1
    aux = np.abs(rng.normal(size=(n, m))) + 0.5
    out = corrnmf.update_embeddings(
        emb0, others, scalings_vec, scalings_other, 1.0, aux, max_iter=10
    )
    assert np.asarray(out).shape == (n, dim)
    assert np.all(np.isfinite(np.asarray(out)))


def test_embedding_gradient_and_hessian_consistency():
    """Public gradient/Hessian kernels agree with autodiff of the objective."""
    import jax

    rng = np.random.default_rng(3)
    m, M = 3, 7
    embedding = rng.normal(size=m)
    others = rng.normal(size=(M, m)) * 0.5
    scaling = 0.2
    scalings_other = rng.normal(size=M) * 0.1
    aux_vec = np.abs(rng.normal(size=M)) + 0.5
    variance = 1.5

    def objective(b):
        return corrnmf.embedding_objective(
            b, others, scaling, scalings_other, variance, aux_vec
        )

    grad_auto = jax.grad(objective)(embedding)
    grad_kernel = corrnmf.embedding_gradient(
        embedding, others, scaling, scalings_other, variance, aux_vec
    )
    np.testing.assert_allclose(grad_kernel, grad_auto, rtol=1e-8)

    hess_auto = jax.hessian(objective)(embedding)
    hess_kernel = corrnmf.embedding_hessian(
        embedding, others, scaling, scalings_other, variance
    )
    np.testing.assert_allclose(hess_kernel, hess_auto, rtol=1e-8)
    # SPD: all eigenvalues positive
    assert np.all(np.linalg.eigvalsh(np.asarray(hess_kernel)) > 0)


def test_vectorized_backtracking_matches_serial_armijo():
    """The 41-candidate vectorized Armijo search must accept exactly the
    step the reference-style serial halving loop (shrink 0.5 while the
    Armijo condition fails and t > 1e-12) would accept."""
    import jax.numpy as jnp

    from salamander_tpu.ops import corrnmf as ops

    rng = np.random.default_rng(0)
    for trial in range(20):
        m, M = rng.integers(1, 5), rng.integers(2, 12)
        embeddings_other = rng.normal(size=(M, m))
        offsets = rng.normal(size=M)
        linear_term = rng.normal(size=m) * rng.uniform(0.5, 50)
        variance = rng.uniform(0.05, 2.0)
        b = rng.normal(size=m) * rng.uniform(0.5, 3)

        def f(x):
            z = offsets + embeddings_other @ x
            return (-linear_term @ x + np.sum(np.exp(z))
                    + x @ x / (2 * variance))

        rates = np.exp(offsets + embeddings_other @ b)
        grad = -linear_term + embeddings_other.T @ rates + b / variance
        hess = ((embeddings_other * rates[:, None]).T @ embeddings_other
                + np.eye(m) / variance)
        direction = -np.linalg.solve(hess, grad)
        f0, slope = f(b), grad @ direction

        t_serial = 1.0
        while f(b + t_serial * direction) > f0 + 1e-4 * t_serial * slope \
                and t_serial > 1e-12:
            t_serial *= 0.5

        ts = 0.5 ** np.arange(ops._N_BACKTRACK)
        candidates = b[None] + ts[:, None] * direction[None]
        f_cand = np.array([f(c) for c in candidates])
        ok = f_cand <= f0 + 1e-4 * ts * slope
        ok[-1] = True
        t_vector = ts[np.argmax(ok)]
        assert t_vector == t_serial, (trial, t_vector, t_serial)


def test_solve_spd_small_matches_linalg():
    import jax.numpy as jnp

    from salamander_tpu.ops.corrnmf import _solve_spd_small

    rng = np.random.default_rng(1)
    for dim in (1, 2, 3, 5):
        A = rng.normal(size=(dim, dim))
        hess = A @ A.T + np.eye(dim)  # SPD
        grad = rng.normal(size=dim)
        expected = np.linalg.solve(hess, grad)
        result = np.asarray(_solve_spd_small(jnp.asarray(hess),
                                             jnp.asarray(grad)))
        np.testing.assert_allclose(result, expected, rtol=1e-10)


def test_unrolled_cholesky_solve_matches_numpy():
    """The dim>3 Newton systems use a fully unrolled scalar Cholesky (no
    linalg custom call, and a library cho_factor of a not-quite-SPD
    Hessian NaNs inside the m-padded scan program). Pin it against numpy
    across dims and under vmap."""
    import jax
    import jax.numpy as jnp

    from salamander_tpu.ops.corrnmf import (
        _cholesky_solve_unrolled,
        _solve_spd_small,
    )

    rng = np.random.default_rng(0)
    for dim in (4, 5, 8):
        A = rng.normal(size=(dim, dim))
        spd = A @ A.T + 3.0 * np.eye(dim)
        b = rng.normal(size=dim)
        x = np.asarray(
            _cholesky_solve_unrolled(jnp.asarray(spd), jnp.asarray(b))
        )
        np.testing.assert_allclose(x, np.linalg.solve(spd, b), rtol=1e-9)

    # batched through _solve_spd_small (the update_embeddings path)
    dim = 4
    mats = np.stack([
        (m := rng.normal(size=(dim, dim))) @ m.T + (2 + i) * np.eye(dim)
        for i in range(6)
    ])
    vecs = rng.normal(size=(6, dim))
    got = np.asarray(
        jax.vmap(_solve_spd_small)(jnp.asarray(mats), jnp.asarray(vecs))
    )
    expected = np.stack(
        [np.linalg.solve(mats[i], vecs[i]) for i in range(6)]
    )
    np.testing.assert_allclose(got, expected, rtol=1e-8)

    # the m-padded block-diagonal shape: padded rows/cols = I/var
    var = 0.7
    hess = np.zeros((4, 4))
    hess[:2, :2] = (m := rng.normal(size=(2, 2))) @ m.T + np.eye(2) / var
    hess[2, 2] = hess[3, 3] = 1.0 / var
    grad = np.array([0.3, -0.2, 0.0, 0.0])
    x = np.asarray(
        _cholesky_solve_unrolled(jnp.asarray(hess), jnp.asarray(grad))
    )
    np.testing.assert_allclose(x[:2], np.linalg.solve(hess[:2, :2], grad[:2]),
                               rtol=1e-9)
    np.testing.assert_array_equal(x[2:], 0.0)


def test_unrolled_cholesky_indefinite_stays_finite():
    """Regression for an accelerator NaN: an embedding Hessian
    that is SPD in exact arithmetic reached the solve INDEFINITE after
    bf16-precision matmuls (rank-k + I/var structure, condition ~1e5, so
    ~4e-3-relative roundoff overwhelmed the smallest eigenvalue). The
    Newton products now run at Precision.HIGHEST, and the unrolled
    Cholesky floors each pivot at EPSILON * hess[i, i] as a backstop - an
    indefinite input must yield a FINITE (Armijo-vetted) direction, never
    NaN."""
    import jax.numpy as jnp

    from salamander_tpu.ops.corrnmf import _cholesky_solve_unrolled

    # the structure observed on hardware: rank-2 outer-product sum with
    # huge rates + I, whose smallest ACTIVE eigenvalue (exactly 1 from the
    # prior term) is deterministically pushed negative at the magnitude
    # bf16 roundoff reached (~4e-3 x the 1e4-scale rates ~ 40), plus the
    # observed bf16-scale asymmetry
    rng = np.random.default_rng(1)
    o = rng.normal(size=(2, 4))
    o[:, 3] = 0.0  # padded embedding dim
    hess = 3e4 * o[0, :, None] * o[0] + 2e4 * o[1, :, None] * o[1] + np.eye(4)
    w, V = np.linalg.eigh(hess[:3, :3])
    hess[:3, :3] -= (w[0] + 40.0) * np.outer(V[:, 0], V[:, 0])
    hess[0, 1] += 8.0  # |H - H^T| at bf16-relative scale, as on hardware
    assert np.linalg.eigvalsh(0.5 * (hess + hess.T)).min() < 0  # indefinite
    grad = rng.normal(size=4) * 1e4
    x = np.asarray(
        _cholesky_solve_unrolled(jnp.asarray(hess), jnp.asarray(grad))
    )
    assert np.all(np.isfinite(x))


def test_reference_named_embedding_adapters():
    """objective_function_embedding / gradient_embedding / hessian_embedding
    accept the reference's precomputed-term conventions
    (models/_utils_corrnmf.py:182-351) and match the fused kernels."""
    rng = np.random.default_rng(7)
    m, M = 3, 6
    embedding = rng.normal(size=m)
    others = rng.normal(size=(M, m)) * 0.5
    scaling = -0.1
    scalings_other = rng.normal(size=M) * 0.2
    aux_vec = np.abs(rng.normal(size=M)) + 0.5
    variance = 2.0

    np.testing.assert_array_equal(
        corrnmf.objective_function_embedding(
            embedding, others, scaling, scalings_other, variance, aux_vec),
        corrnmf.embedding_objective(
            embedding, others, scaling, scalings_other, variance, aux_vec))

    summand_grad = aux_vec @ others  # the reference precomputes this per row
    np.testing.assert_allclose(
        corrnmf.gradient_embedding(
            embedding, others, scaling, scalings_other, variance,
            summand_grad),
        corrnmf.embedding_gradient(
            embedding, others, scaling, scalings_other, variance, aux_vec),
        rtol=1e-12)

    outer_prods = np.einsum("ij,ik->ijk", others, others)
    np.testing.assert_allclose(
        corrnmf.hessian_embedding(
            embedding, others, scaling, scalings_other, variance,
            outer_prods),
        corrnmf.embedding_hessian(
            embedding, others, scaling, scalings_other, variance),
        rtol=1e-12)

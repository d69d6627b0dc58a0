"""Matmul precision policy: no dot_general on the device fit path may run
off the policy in ops/precision.py.

A reduced-precision f32 matmul (TF32, or bf16 passes) moves MU fixed points
and convergence decisions; measured on an H100 (ops/precision.py has the
table), DEFAULT and HIGH leave 200 MU steps three and two orders of
magnitude further from float64 than full f32 does. CPU ignores the
setting, so golden-fixture equality cannot catch a regression; this test
instead inspects the traced jaxprs:

- UPDATE-path programs (multiplicative updates, SVI steps): every dot at
  MATMUL_PRECISION (HIGHEST) - never DEFAULT/None or HIGH.
- DECISION-path programs (objectives, acceptance/convergence evaluations,
  Newton solves): every dot at HIGHEST.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from salamander_tpu.ops import ardnmf as ardops
from salamander_tpu.ops import assign as assignops
from salamander_tpu.ops import corrnmf as corrops
from salamander_tpu.ops import klnmf as klops
from salamander_tpu.ops import mvnmf as mvops
from salamander_tpu.ops import svi as sviops
from salamander_tpu.ops.precision import (
    MATMUL_PRECISION,
    OBJECTIVE_PRECISION,
    mm,
    omm,
)

HIGHEST = lax.Precision.HIGHEST
ALLOWED_UPDATE = {HIGHEST}


def _iter_eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for value in eqn.params.values():
            for sub in jax.core.jaxprs_in_params({"_": value}):
                yield from _iter_eqns(sub)


def _bad_dots(fn, args, allowed):
    """dot_general eqns traced from fn(*args) outside the allowed set."""
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    bad = []
    for eqn in _iter_eqns(jaxpr):
        if eqn.primitive.name != "dot_general":
            continue
        precision = eqn.params.get("precision")
        flat = precision if isinstance(precision, tuple) else (precision,)
        if any(p not in allowed for p in flat):
            bad.append(f"{eqn} precision={precision}")
    return bad


V, K, D, M = 8, 3, 6, 2


def _wh():
    rng = np.random.default_rng(0)
    W = rng.random((V, K)) + 0.1
    W = W / W.sum(axis=0)
    H = rng.random((K, D)) * 50 + 1.0
    X = np.maximum(np.round(W @ H), 1.0)
    return jnp.asarray(X), jnp.asarray(W), jnp.asarray(H)


# --------------------------------------------------------------------- #
# update path: at MATMUL_PRECISION (HIGHEST)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize(
    "name, build",
    [
        ("klnmf.update_WH", lambda X, W, H: (klops.update_WH, (X, W, H))),
        (
            "mvnmf.update_W_unconstrained",
            lambda X, W, H: (
                lambda x, w, h: mvops.update_W_unconstrained(
                    x, w, h, 1.0, 1.0
                ),
                (X, W, H),
            ),
        ),
        (
            "mvnmf.line_search",
            lambda X, W, H: (
                lambda x, w, h: mvops.line_search(
                    x, w, h, 1.0, 1.0, jnp.asarray(1.0), w
                ),
                (X, W, H),
            ),
        ),
        (
            "ardnmf.update_whl",
            lambda X, W, H: (
                lambda x, w, h: ardops.update_whl(
                    x, w, h, jnp.ones(K), jnp.asarray([10.0, 5.0]), "L2"
                ),
                (X, W, H),
            ),
        ),
    ],
)
def test_update_path_never_default(name, build):
    X, W, H = _wh()
    fn, args = build(X, W, H)
    bad = _bad_dots(fn, args, ALLOWED_UPDATE)
    assert not bad, f"{name}: off-policy dot_general(s):\n" + "\n".join(
        bad
    )


def test_svi_klnmf_step_never_default():
    X, W, H = _wh()
    config = sviops.SVIConfig(batch_size=2)
    step = sviops.make_klnmf_svi_step(D, config)
    state = sviops.klnmf_svi_init({"W": W, "H": H})
    key = jax.random.PRNGKey(1)
    bad = _bad_dots(step, (state, {"X": X}, key), ALLOWED_UPDATE)
    assert not bad, "svi step: DEFAULT dot_general(s):\n" + "\n".join(bad)


def _corrnmf_parts():
    rng = np.random.default_rng(1)
    X, W, H = _wh()
    sig_emb = jnp.asarray(rng.normal(size=(K, M)))
    smp_emb = jnp.asarray(rng.normal(size=(D, M)))
    sig_scal = jnp.zeros(K)
    variance = jnp.asarray(1.0)
    return X, W, sig_scal, sig_emb, smp_emb, variance


def test_corrnmf_em_cycle_never_default():
    """CorrNMF's bulk EM products (exposures, aux statistics, scaling
    M-steps, the masked W update) run at the update tier; only the
    decision pieces (Newton systems, ELBO) require HIGHEST."""
    X, W, sig_scal, sig_emb, smp_emb, variance = _corrnmf_parts()

    def em_pieces(X, signatures, sig_scal, sig_emb, smp_emb, variance):
        smp_scal = corrops.update_sample_scalings(
            X, sig_scal, sig_emb, smp_emb
        )
        exposures = corrops.compute_exposures(
            sig_scal, smp_scal, sig_emb, smp_emb
        )
        aux = corrops.compute_aux(X, signatures, exposures)
        sig_scal = corrops.update_signature_scalings(
            aux, smp_scal, sig_emb, smp_emb
        )
        sig_emb = corrops.update_embeddings(
            sig_emb, smp_emb, sig_scal, smp_scal, variance, aux, max_iter=2
        )
        return sig_emb

    bad = _bad_dots(
        em_pieces,
        (X.T, W.T, sig_scal, sig_emb, smp_emb, variance),
        ALLOWED_UPDATE,
    )
    assert not bad, "corrnmf EM: DEFAULT dot_general(s):\n" + "\n".join(bad)


def test_corrnmf_decisions_are_highest():
    """ELBO and the Newton embedding solves make decisions: HIGHEST only.
    (update_embeddings internally mixes aux statistics with its HIGHEST
    solver products, so it is covered by the never-default test above;
    the pure solver pieces are pinned here.)"""
    X, W, sig_scal, sig_emb, smp_emb, variance = _corrnmf_parts()
    exposures = corrops.compute_exposures(
        sig_scal, jnp.zeros(D), sig_emb, smp_emb
    )

    def elbo(X, signatures, exposures, sig_emb, smp_emb, variance):
        return corrops.elbo_corrnmf(
            X, signatures, exposures, sig_emb, smp_emb, variance
        )

    bad = _bad_dots(
        elbo, (X.T, W.T, exposures, sig_emb, smp_emb, variance), {HIGHEST}
    )

    outer = jnp.asarray(
        np.einsum("km,kn->kmn", np.asarray(sig_emb), np.asarray(sig_emb))
    )

    def newton_pieces(embedding, sig_emb, scalings, variance, aux_vec,
                      outer):
        summand_grad = jnp.sum(aux_vec[:, None] * sig_emb, axis=0)
        grad = corrops.gradient_embedding(
            embedding, sig_emb, 0.0, scalings, variance, summand_grad
        )
        hess = corrops.hessian_embedding(
            embedding, sig_emb, 0.0, scalings, variance, outer
        )
        return grad, hess

    bad += _bad_dots(
        newton_pieces,
        (smp_emb[0], sig_emb, jnp.zeros(K), variance, jnp.ones(K), outer),
        {HIGHEST},
    )
    assert not bad, "corrnmf decisions: non-HIGHEST:\n" + "\n".join(bad)


# --------------------------------------------------------------------- #
# decision path: HIGHEST only
# --------------------------------------------------------------------- #

@pytest.mark.parametrize(
    "name, build",
    [
        (
            "klnmf.kl_divergence",
            lambda X, W, H: (klops.kl_divergence, (X, W, H)),
        ),
        (
            "klnmf.samplewise_kl",
            lambda X, W, H: (klops.samplewise_kl_divergence, (X, W, H)),
        ),
        (
            "klnmf.poisson_llh",
            lambda X, W, H: (klops.poisson_llh, (X, W, H)),
        ),
        (
            "mvnmf.objective",
            lambda X, W, H: (
                lambda x, w, h: mvops.kl_divergence_penalized(
                    x, w, h, 1.0, 1.0
                ),
                (X, W, H),
            ),
        ),
        (
            "assign.eliminate",
            lambda X, W, H: (
                lambda x, w: assignops.eliminate_signatures(
                    x, w, 0.02, candidate_iters=2, polish_iterations=2,
                    max_polish_iterations=4,
                ),
                (X, W),
            ),
        ),
    ],
)
def test_decision_path_is_highest(name, build):
    X, W, H = _wh()
    fn, args = build(X, W, H)
    bad = _bad_dots(fn, args, {HIGHEST})
    assert not bad, f"{name}: non-HIGHEST dot_general(s):\n" + "\n".join(bad)


def test_policy_constants():
    assert MATMUL_PRECISION == HIGHEST
    assert OBJECTIVE_PRECISION == HIGHEST
    a, b = jnp.ones((2, 3)), jnp.ones((3, 2))
    for fn, expected in ((mm, MATMUL_PRECISION), (omm, OBJECTIVE_PRECISION)):
        jaxpr = jax.make_jaxpr(fn)(a, b).jaxpr
        (eqn,) = [
            e for e in jaxpr.eqns if e.primitive.name == "dot_general"
        ]
        assert all(p == expected for p in eqn.params["precision"])

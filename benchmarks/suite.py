"""Full benchmark suite: the reference-workload configs, on one NVIDIA GPU.

  1. KLNMF k=5, 100 restarts, PCAWG-breast SBS (the headline; also bench.py)
  2. MvNMF k=5..10, PCAWG-breast SBS
  3. CorrNMF dim=2, PCAWG-breast SBS
  4. Multimodal CorrNMF over {sbs, indel, sv}
  5. KLNMF rank scan k=2..20 x 100 restarts on a 96 x 10k synthetic catalog
  6. ARDNMF rank inference (one K_max=20 fit) on the same synthetic catalog
  7. De novo consensus extraction (ranks 2..10 x 20 bootstraps, PCAWG SBS)
  8. Catalog assignment + decomposition vs COSMIC (dense, sparse, decompose)

Each config reports device wall time / throughput and, where a faithful
CPU stand-in of the reference hot path is feasible in-process, the speedup
over it (the reference itself needs numba, which is not installed; for
CorrNMF the stand-in uses the same scipy Newton-CG per-row loop the
reference runs, so that ratio is the most meaningful one).

Writes results as JSON lines to stdout; run from the repo root:
    python benchmarks/suite.py [config ...]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from salamander_tpu import datasets  # noqa: E402
from salamander_tpu.containers import AnnData, MuData  # noqa: E402
from salamander_tpu.engine import FitConfig  # noqa: E402


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def emit(record):
    print(json.dumps(record), flush=True)


# --------------------------------------------------------------------- #
# config 1: headline (delegates to bench.py's logic)
# --------------------------------------------------------------------- #

def config1_klnmf_restarts():
    import bench

    X = bench.load_counts()
    cpu = bench.measure_cpu_baseline(X)
    device_rate, best_loss, total_iters = bench.measure_device(X)
    emit({
        "config": "1_klnmf_100restarts",
        "device_aggregate_mu_iterations_per_sec": round(device_rate, 1),
        "cpu_equivalent_iterations_per_sec": round(cpu, 1),
        "speedup": round(device_rate / cpu, 1),
        "best_loss": round(best_loss, 2),
    })


# --------------------------------------------------------------------- #
# config 2: MvNMF rank sweep
# --------------------------------------------------------------------- #

def _cpu_mvnmf_iterations_per_sec(X, n_signatures=5, lam=1.0, delta=1.0,
                                  n_iterations=60):
    """The reference's MvNMF iteration in literal numpy: MU H update, the
    Leplat-Gillis-Ang closed-form W step with the (K,K) inverse, and the
    0.8-shrink backtracking line search re-evaluating the penalized KL per
    trial (reference mvnmf.py:37-92, :197-210), objective every 10 iters."""
    rng = np.random.default_rng(1)
    V, D = X.shape
    K = n_signatures
    eps = float(np.finfo(np.float32).eps)
    W = rng.dirichlet(np.ones(V), size=K).T
    H = rng.uniform(size=(K, D)) * X.sum(0) / K
    gamma = 1.0

    def kl(W, H):
        WH = W @ H
        pos = X > 0
        return float(
            np.sum(X[pos] * np.log(X[pos] / WH[pos])) - X.sum() + WH.sum()
        )

    def objective(W, H):
        _, logdet = np.linalg.slogdet(W.T @ W + delta * np.eye(K))
        return kl(W, H) + lam * logdet

    def normalize(W_trial, H):
        sums = W_trial.sum(0)
        return W_trial / sums, H * sums[:, None]

    def iteration(W, H, gamma):
        H = np.maximum(H * (W.T @ (X / (W @ H))), eps)
        Y = np.linalg.inv(W.T @ W + delta * np.eye(K))
        WY_minus = W @ np.maximum(0.0, -Y)
        WY_abs = W @ np.abs(Y)
        linear = H.sum(1) - 4.0 * lam * WY_minus
        disc = linear**2 + 8.0 * lam * WY_abs * ((X / (W @ H)) @ H.T)
        W_un = np.maximum(
            W * (np.sqrt(disc) - linear) / (4.0 * lam * WY_abs), eps
        )
        prev = objective(W, H)
        g = gamma
        W_new, H_new = normalize(W_un, H)
        W_new, H_new = np.maximum(W_new, eps), np.maximum(H_new, eps)
        of_value = objective(W_new, H_new)
        while of_value > prev and g > 1e-16:
            g *= 0.8
            W_trial = (1.0 - g) * W + g * W_un
            W_new, H_new = normalize(W_trial, H)
            W_new, H_new = np.maximum(W_new, eps), np.maximum(H_new, eps)
            of_value = objective(W_new, H_new)
        return W_new, H_new, min(1.0, 1.2 * g)

    for _ in range(5):  # warm caches
        W, H, gamma = iteration(W, H, gamma)
    start = time.perf_counter()
    for i in range(1, n_iterations + 1):
        W, H, gamma = iteration(W, H, gamma)
        if i % 10 == 0:
            objective(W, H)
    return n_iterations / (time.perf_counter() - start)


def config2_mvnmf():
    from salamander_tpu.models import MvNMF

    sbs = datasets.load_pcawg_sbs()
    results = {}
    for k in range(5, 11):
        cpu_ips = _cpu_mvnmf_iterations_per_sec(
            sbs.values.T.astype(float), n_signatures=k
        )
        model = MvNMF(n_signatures=k, lam=1.0, delta=1.0)
        start = time.perf_counter()
        model.fit(AnnData(sbs.copy()), init_kwargs={"seed": 1})
        cold = time.perf_counter() - start
        # steady state: refit (program cached)
        start = time.perf_counter()
        model.fit(AnnData(sbs.copy()), init_kwargs={"seed": 1})
        elapsed = time.perf_counter() - start
        iters = model.history["n_iterations"]
        device_ips = iters / elapsed
        results[k] = {
            "seconds_incl_compile": round(cold, 2),
            "steady_seconds": round(elapsed, 2),
            "iterations": iters,
            "device_iterations_per_sec": round(device_ips, 1),
            "cpu_iterations_per_sec": round(cpu_ips, 1),
            "speedup_vs_cpu": round(device_ips / cpu_ips, 1),
            "objective": round(model.objective_function(), 1),
        }
        log(f"config2 k={k}: {iters} iters, device {device_ips:.0f} it/s vs "
            f"CPU {cpu_ips:.0f} it/s ({device_ips / cpu_ips:.1f}x)")
    emit({"config": "2_mvnmf_k5_10", "per_rank": results})


def config2d_mvnmf_multistart():
    """MvNMF where the device pays off: 50 batched restarts in one lockstep
    program (a single 96x192 fit is latency-bound - the backtracking line
    search serializes tiny KL evaluations - so config 2's per-fit ratios
    sit near 1x; the reference runs restarts one at a time, so the honest
    comparison is aggregate it/s across a multi-start)."""
    from salamander_tpu import fit_best_of
    from salamander_tpu.models import MvNMF

    sbs = datasets.load_pcawg_sbs()
    cpu_ips = _cpu_mvnmf_iterations_per_sec(
        sbs.values.T.astype(float), n_signatures=5
    )

    def run():
        model = MvNMF(n_signatures=5, init_method="random")
        start = time.perf_counter()
        summary = fit_best_of(model, AnnData(sbs.copy()), n_restarts=50,
                              base_seed=0)
        return summary, time.perf_counter() - start

    _, cold = run()           # compile + run
    summary, elapsed = run()  # steady
    total_iters = int(np.sum(summary.n_iterations))
    agg = total_iters / elapsed
    emit({
        "config": "2d_mvnmf_multistart_50",
        "cold_seconds_incl_compile": round(cold, 1),
        "steady_seconds": round(elapsed, 2),
        "total_iterations": total_iters,
        "device_aggregate_iterations_per_sec": round(agg, 1),
        "cpu_iterations_per_sec": round(cpu_ips, 1),
        "speedup_vs_cpu": round(agg / cpu_ips, 1),
        "best_loss": round(float(np.min(summary.losses)), 1),
    })
    log(f"config2d: R=50 aggregate {agg:,.0f} it/s vs CPU {cpu_ips:.0f} "
        f"({agg / cpu_ips:.0f}x)")


# --------------------------------------------------------------------- #
# config 3: CorrNMF vs the scipy-loop reference stand-in
# --------------------------------------------------------------------- #

def _newton_cg_row(b0, others, scaling, scal_other, aux_vec, variance,
                   maxiter):
    """One embedding row's scipy Newton-CG solve (the reference's
    _utils_corrnmf.update_embedding semantics). `scaling` may be a scalar
    (per-signature solves) or fold into `scal_other` as a vector (the
    multimodal joint sample solve, where each concatenated signature row
    carries its own modality's sample scaling)."""
    from scipy import optimize

    m = others.shape[1]
    q = aux_vec @ others

    def fun(b):
        z = scaling + scal_other + others @ b
        return -(q @ b - np.sum(np.exp(z)) - b @ b / (2 * variance))

    def grad(b):
        e = np.exp(scaling + scal_other + others @ b)
        return -(q - others.T @ e - b / variance)

    def hess(b):
        e = np.exp(scaling + scal_other + others @ b)
        return (others * e[:, None]).T @ others + np.eye(m) / variance

    options = {"maxiter": maxiter} if maxiter else None
    return optimize.minimize(fun, b0, method="Newton-CG", jac=grad,
                             hess=hess, options=options).x


def _cpu_corrnmf_cycle_seconds(X, n_signatures=5, dim=2, n_cycles=3):
    """The reference's EM cycle in numpy/scipy: per-row Newton-CG loops
    (models/corrnmf_det.py:103-141 semantics)."""
    rng = np.random.default_rng(0)
    D, V = X.shape
    K, m = n_signatures, dim
    S = rng.dirichlet(np.ones(V), K)
    sig_scal = np.zeros(K)
    smp_scal = np.zeros(D)
    L = rng.normal(size=(K, m))
    U = rng.normal(size=(D, m))
    variance = 1.0

    def solve_row(b0, others, scaling, scal_other, aux_vec, maxiter):
        return _newton_cg_row(b0, others, scaling, scal_other, aux_vec,
                              variance, maxiter)

    start = time.perf_counter()
    for _ in range(n_cycles):
        smp_scal = np.log(X.sum(1)) - np.log(
            np.exp(sig_scal[:, None] + L @ U.T).sum(0)
        )
        E = np.exp(sig_scal[:, None] + smp_scal[None, :] + L @ U.T).T
        aux = E.T * (S @ (X / (E @ S)).T)
        sig_scal = np.log(aux.sum(1)) - np.log(
            np.exp(smp_scal[None, :] + L @ U.T).sum(1)
        )
        for k in range(K):
            L[k] = solve_row(L[k], U, sig_scal[k], smp_scal, aux[k], None)
        for d in range(D):
            U[d] = solve_row(U[d], L, smp_scal[d], sig_scal, aux[:, d], 3)
        variance = max(np.mean(np.concatenate([L, U]) ** 2), 1e-7)
        numer = (X / (E @ S)).T @ E
        S = (S.T * numer / numer.sum(0)).T
        S = np.maximum(S / S.sum(1, keepdims=True), 1e-7)
    return (time.perf_counter() - start) / n_cycles


def config3_corrnmf():
    from salamander_tpu.models import CorrNMFDet

    sbs = datasets.load_pcawg_sbs()
    cpu_cycle = _cpu_corrnmf_cycle_seconds(sbs.values.astype(float))
    log(f"config3: CPU scipy-loop EM cycle {cpu_cycle*1e3:.0f}ms")

    np.random.seed(0)
    model = CorrNMFDet(n_signatures=5, dim_embeddings=2,
                       min_iterations=100, max_iterations=2000, tol=1e-7)
    start = time.perf_counter()
    model.fit(AnnData(sbs.copy()))
    warm = time.perf_counter() - start
    iters = model.history["n_iterations"]
    log(f"config3: device fit {iters} EM cycles in {warm:.1f}s (incl compile)")
    # steady state: refit (program cached)
    np.random.seed(1)
    start = time.perf_counter()
    model.fit(AnnData(sbs.copy()))
    elapsed = time.perf_counter() - start
    iters = model.history["n_iterations"]
    device_cycle = elapsed / iters
    emit({
        "config": "3_corrnmf_dim2",
        "device_em_cycles_per_sec": round(1 / device_cycle, 1),
        "cpu_scipy_em_cycles_per_sec": round(1 / cpu_cycle, 2),
        "speedup": round(cpu_cycle / device_cycle, 1),
        "em_cycles": iters,
        "elbo": round(model.objective_function(), 1),
    })


def config3b_corrnmf_multistart():
    """Batched CorrNMF multi-start: whole EM fits as one device program."""
    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu.parallel import fit_best_of

    sbs = datasets.load_pcawg_sbs()
    n_restarts = 16

    def fresh():
        return CorrNMFDet(n_signatures=5, dim_embeddings=2,
                          min_iterations=100, max_iterations=500, tol=1e-7)

    fit_best_of(fresh(), AnnData(sbs.copy()), n_restarts, base_seed=100)
    model = fresh()
    start = time.perf_counter()
    summary = fit_best_of(model, AnnData(sbs.copy()), n_restarts, base_seed=0)
    elapsed = time.perf_counter() - start
    total_cycles = int(np.sum(summary.n_iterations))
    emit({
        "config": "3b_corrnmf_multistart_16",
        "steady_seconds": round(elapsed, 2),
        "total_em_cycles": total_cycles,
        "device_aggregate_em_cycles_per_sec": round(total_cycles / elapsed, 1),
        "best_elbo": round(float(summary.losses[summary.best_index]), 1),
        "elbo_spread": round(
            float(summary.losses.max() - summary.losses.min()), 1
        ),
    })


def config3c_corrnmf_svi():
    """Stochastic (minibatch) EM step throughput at D=200k vs full-batch
    cycles on the same synthetic cohort (the fit_minibatch scaling
    story)."""
    import jax

    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu.ops import svi

    X = datasets.synthetic_catalog(n_features=96, n_samples=200_000,
                                   n_signatures=5, seed=0).T  # (D, V)
    model = CorrNMFDet(n_signatures=5, dim_embeddings=2, dtype="float32")
    adata = AnnData(X.astype(np.float32))
    model._setup_adata(adata)
    model._initialize(init_kwargs={"seed": 1})
    model._setup_fitting_parameters(None)
    params, data = model._device_state()

    # full-batch EM cycles/s (fixed-iteration window)
    update_fn, _ = model._build_step()
    step = jax.jit(lambda p: update_fn(p, data))
    p = step(params)
    jax.block_until_ready(p["signatures"])
    n_cycles = 50
    start = time.perf_counter()
    for _ in range(n_cycles):
        p = step(p)
    jax.block_until_ready(p["signatures"])
    full_cycles_per_sec = n_cycles / (time.perf_counter() - start)

    # minibatch steps/s at B=4096 (eval off: pure stepping)
    batch = 4096
    n_steps = 2000
    step_fn = svi.make_svi_step(
        200_000, svi.SVIConfig(batch_size=batch, delay=50.0)
    )
    state0 = svi.svi_init(params)
    state, _ = svi.run_svi(step_fn, state0, data["X"],
                           jax.random.PRNGKey(0), n_steps, 0)
    jax.block_until_ready(state.params["signatures"])
    start = time.perf_counter()
    state, _ = svi.run_svi(step_fn, state0, data["X"],
                           jax.random.PRNGKey(1), n_steps, 0)
    jax.block_until_ready(state.params["signatures"])
    steps_per_sec = n_steps / (time.perf_counter() - start)
    emit({
        "config": "3c_corrnmf_svi_96x200k",
        "full_batch_em_cycles_per_sec": round(full_cycles_per_sec, 1),
        "full_batch_sample_updates_per_sec": round(
            full_cycles_per_sec * 200_000, -3
        ),
        "svi_steps_per_sec_B4096": round(steps_per_sec, 1),
        "svi_sample_updates_per_sec": round(steps_per_sec * batch, -3),
        # jitted: the eager op-by-op path dispatches per op
        "elbo_after_2k_svi_steps": round(
            float(jax.jit(svi.full_elbo)(state.params, data["X"])), 0
        ),
    })


# --------------------------------------------------------------------- #
# config 4: multimodal
# --------------------------------------------------------------------- #

def _cpu_multimodal_cycle_seconds(mods_X, ns_signatures, dim=3, n_cycles=2):
    """The reference's multimodal EM cycle in numpy/scipy
    (mmcorrnmf.py:443-453): per-modality scalings/aux/signature-embedding
    Newton loops, the JOINT per-sample Newton solve over the concatenated
    signature axis (:398-428 - per-modality sample scalings repeated per
    that modality's signature count), pooled variance, KL signature
    updates."""
    rng = np.random.default_rng(0)
    # the reference clips counts to EPSILON at fit start
    # (signature_nmf.py:269-281) - without it, all-zero SV samples hit
    # log(0) in the scaling updates
    mods_X = [np.clip(X, np.finfo(np.float32).eps, None) for X in mods_X]
    D = mods_X[0].shape[0]
    m = dim
    variance = 1.0
    Ss, sig_scals, smp_scals, Ls = [], [], [], []
    for X, K in zip(mods_X, ns_signatures):
        V = X.shape[1]
        Ss.append(rng.dirichlet(np.ones(V), K))
        sig_scals.append(np.zeros(K))
        smp_scals.append(np.zeros(D))
        Ls.append(rng.normal(size=(K, m)))
    U = rng.normal(size=(D, m))
    n_mods = len(mods_X)

    start = time.perf_counter()
    for _ in range(n_cycles):
        auxs, Es = [], []
        for i in range(n_mods):
            X, S, L = mods_X[i], Ss[i], Ls[i]
            smp_scals[i] = np.log(X.sum(1)) - np.log(
                np.exp(sig_scals[i][:, None] + L @ U.T).sum(0)
            )
            E = np.exp(
                sig_scals[i][:, None] + smp_scals[i][None, :] + L @ U.T
            ).T
            aux = E.T * (S @ (X / (E @ S)).T)
            sig_scals[i] = np.log(aux.sum(1)) - np.log(
                np.exp(smp_scals[i][None, :] + L @ U.T).sum(1)
            )
            auxs.append(aux)
            Es.append(E)
        for i in range(n_mods):
            for k in range(ns_signatures[i]):
                Ls[i][k] = _newton_cg_row(
                    Ls[i][k], U, sig_scals[i][k], smp_scals[i],
                    auxs[i][k], variance, None,
                )
        # joint sample solve: concatenate across modalities; each
        # signature row carries its own modality's sample scaling
        L_all = np.concatenate(Ls, axis=0)
        aux_all = np.concatenate(auxs, axis=0)          # (sumK, D)
        sig_all = np.concatenate(sig_scals)
        smp_per_k = np.concatenate(
            [np.tile(smp_scals[i][:, None], (1, ns_signatures[i]))
             for i in range(n_mods)],
            axis=1,
        )                                               # (D, sumK)
        for d in range(D):
            U[d] = _newton_cg_row(
                U[d], L_all, 0.0, sig_all + smp_per_k[d],
                aux_all[:, d], variance, 3,
            )
        variance = max(
            float(np.mean(np.concatenate([L_all, U]) ** 2)), 1e-7
        )
        for i in range(n_mods):
            X, S, E = mods_X[i], Ss[i], Es[i]
            numer = (X / (E @ S)).T @ E
            S = (S.T * numer / numer.sum(0)).T
            Ss[i] = np.maximum(S / S.sum(1, keepdims=True), 1e-7)
    return (time.perf_counter() - start) / n_cycles


def config4_multimodal():
    from salamander_tpu.models import MultimodalCorrNMF

    frames = {
        "sbs": datasets.load_pcawg_sbs(),
        "indel": datasets.load_pcawg_indel(),
        "sv": datasets.load_pcawg_sv(),
    }
    cpu_cycle = _cpu_multimodal_cycle_seconds(
        [frame.values.astype(float) for frame in frames.values()],
        [5, 4, 3],
    )
    log(f"config4: CPU scipy-loop multimodal cycle {cpu_cycle*1e3:.0f}ms")
    mods = {name: AnnData(frame) for name, frame in frames.items()}
    np.random.seed(0)
    model = MultimodalCorrNMF(ns_signatures=[5, 4, 3], dim_embeddings=3,
                              min_iterations=100, max_iterations=1000)
    start = time.perf_counter()
    model.fit(MuData({k: v.copy() for k, v in mods.items()}))
    cold = time.perf_counter() - start
    # steady state: refit (program cached)
    np.random.seed(1)
    start = time.perf_counter()
    model.fit(MuData(mods))
    elapsed = time.perf_counter() - start
    iters = model.history["n_iterations"]
    device_cycle = elapsed / iters
    emit({
        "config": "4_multimodal_sbs_indel_sv",
        "cold_seconds_incl_compile": round(cold, 1),
        "steady_seconds": round(elapsed, 1),
        "em_cycles": iters,
        "device_em_cycles_per_sec_steady": round(1 / device_cycle, 2),
        "cpu_scipy_em_cycles_per_sec": round(1 / cpu_cycle, 3),
        "speedup_vs_cpu": round(cpu_cycle / device_cycle, 1),
        "elbo": round(model.objective_function(), 1),
    })


# --------------------------------------------------------------------- #
# config 5: rank scan at COSMIC scale
# --------------------------------------------------------------------- #

def config5_rank_scan():
    import bench

    from salamander_tpu.parallel import fit_klnmf_restarts
    from salamander_tpu.parallel.restarts import build_klnmf_restart_runner

    X = datasets.synthetic_catalog(n_features=96, n_samples=10_000,
                                   n_signatures=8, seed=0)
    cpu_iters_per_sec = bench.measure_cpu_baseline(X, n_iterations=60)
    log(f"config5: CPU {cpu_iters_per_sec:.1f} it/s on 96x10k")

    config = FitConfig(min_iterations=200, max_iterations=2000,
                       conv_test_freq=10, tol=1e-7)
    total_iters = 0
    steady_seconds = 0.0
    best = {}
    start = time.perf_counter()
    for offset, k in enumerate(range(2, 21)):
        runner = build_klnmf_restart_runner(config)
        fit_klnmf_restarts(X, k, 100, seed=1000 + offset, config=config,
                           runner=runner)  # warm: compile this rank's program
        t0 = time.perf_counter()
        result = fit_klnmf_restarts(X, k, 100, seed=offset, config=config,
                                    runner=runner)
        steady_seconds += time.perf_counter() - t0
        total_iters += int(np.sum(result.n_iterations))
        best[k] = round(result.best_loss, 1)
        log(f"config5 k={k}: best {result.best_loss:,.1f} "
            f"({time.perf_counter() - t0:.2f}s steady)")
    elapsed = time.perf_counter() - start
    device_steady = total_iters / steady_seconds
    emit({
        "config": "5_rank_scan_k2_20_100restarts_96x10k",
        "wall_seconds_incl_compiles_and_warmups": round(elapsed, 1),
        "steady_state_seconds": round(steady_seconds, 1),
        "total_mu_iterations": total_iters,
        "device_steady_aggregate_mu_iterations_per_sec": round(device_steady, 1),
        "cpu_equivalent_iterations_per_sec": round(cpu_iters_per_sec, 1),
        "speedup_steady": round(device_steady / cpu_iters_per_sec, 1),
        "best_loss_per_rank": best,
    })


def config5b_rank_scan_padded():
    """K-padded rank scan: ranks share bucketed compiled programs (3 compiles
    for k=2..20 instead of 19), per-rank results identical to config 5."""
    from salamander_tpu.parallel import rank_scan_klnmf

    X = datasets.synthetic_catalog(n_features=96, n_samples=10_000,
                                   n_signatures=8, seed=0)
    config = FitConfig(min_iterations=200, max_iterations=2000,
                       conv_test_freq=10, tol=1e-7)
    start = time.perf_counter()
    results = rank_scan_klnmf(X, range(2, 21), 100, seed=0, config=config,
                              pad_ranks=True)
    cold = time.perf_counter() - start
    start = time.perf_counter()
    results = rank_scan_klnmf(X, range(2, 21), 100, seed=0, config=config,
                              pad_ranks=True)
    steady = time.perf_counter() - start
    total_iters = int(sum(np.sum(r.n_iterations) for r in results.values()))
    emit({
        "config": "5b_rank_scan_padded_k2_20_100restarts_96x10k",
        "cold_wall_seconds_incl_3_bucket_compiles": round(cold, 1),
        "steady_state_seconds": round(steady, 1),
        "cold_over_steady": round(cold / steady, 2),
        "total_mu_iterations": total_iters,
        "device_steady_aggregate_mu_iterations_per_sec": round(
            total_iters / steady, 1
        ),
        "best_loss_per_rank": {
            k: round(r.best_loss, 1) for k, r in results.items()
        },
    })




def config5d_rank_scan_auto():
    """The 19-rank scan under the all-auto defaults (the path users hit):
    on an accelerator this resolves to per-rank XLA programs through the
    lane-compacting driver."""
    from salamander_tpu.parallel import rank_scan_klnmf

    X = datasets.synthetic_catalog(n_features=96, n_samples=10_000,
                                   n_signatures=8, seed=0)
    config = FitConfig(min_iterations=200, max_iterations=2000,
                       conv_test_freq=10, tol=1e-7)
    start = time.perf_counter()
    results = rank_scan_klnmf(X, range(2, 21), 100, seed=0, config=config)
    cold = time.perf_counter() - start
    start = time.perf_counter()
    results = rank_scan_klnmf(X, range(2, 21), 100, seed=0, config=config)
    steady = time.perf_counter() - start
    total_iters = int(sum(np.sum(r.n_iterations) for r in results.values()))
    emit({
        "config": "5d_rank_scan_auto_k2_20_100restarts_96x10k",
        "cold_wall_seconds": round(cold, 1),
        "steady_state_seconds": round(steady, 1),
        "total_mu_iterations": total_iters,
        "device_steady_aggregate_mu_iterations_per_sec": round(
            total_iters / steady, 1
        ),
        "best_loss_per_rank": {
            k: round(r.best_loss, 1) for k, r in results.items()
        },
    })


def config2b_mvnmf_rank_scan_padded():
    """Masked-rank MvNMF scan: k=5..10 as K-padded bucketed programs vs one
    program per rank (round-3 feature; the cold win is the compile count -
    2 buckets instead of 6 programs - measured properly only across fresh
    processes, so this config reports the warm-process walls plus the
    loss agreement)."""
    from salamander_tpu.parallel import rank_scan_mvnmf

    sbs = datasets.load_pcawg_sbs().T  # kernel orientation (V, D)
    config = FitConfig(min_iterations=100, max_iterations=2000, tol=1e-7)
    n_restarts = 8

    # warmup/compile both paths
    rank_scan_mvnmf(sbs, range(5, 11), n_restarts, seed=99, config=config,
                    pad_ranks=True, rank_bucket=4)
    start = time.perf_counter()
    padded = rank_scan_mvnmf(sbs, range(5, 11), n_restarts, seed=0,
                             config=config, pad_ranks=True, rank_bucket=4)
    padded_wall = time.perf_counter() - start

    rank_scan_mvnmf(sbs, range(5, 11), n_restarts, seed=99, config=config,
                    pad_ranks=False)
    start = time.perf_counter()
    plain = rank_scan_mvnmf(sbs, range(5, 11), n_restarts, seed=0,
                            config=config, pad_ranks=False)
    plain_wall = time.perf_counter() - start

    # best-loss agreement only: cross-LAYOUT per-lane equality is a CPU
    # invariant (different contraction widths shift convergence blocks for
    # borderline lanes by f32 fusion ulps)
    best_rel = max(
        abs(float(np.min(padded[k].losses)) - float(np.min(plain[k].losses)))
        / abs(float(np.min(plain[k].losses)))
        for k in padded
    )
    emit({
        "config": "2b_mvnmf_rank_scan_padded_k5_10_x8",
        "padded_steady_seconds": round(padded_wall, 2),
        "per_rank_steady_seconds": round(plain_wall, 2),
        "best_loss_max_rel_diff": float(f"{best_rel:.2e}"),
        "best_losses": {
            int(k): round(float(r.best_loss), 1) for k, r in padded.items()
        },
    })


def config4b_multimodal_multistart():
    """Multimodal multi-start restart scaling (device-batched init): the
    config-3b twin for MultimodalCorrNMF."""
    from salamander_tpu.models import MultimodalCorrNMF
    from salamander_tpu.parallel import fit_best_of

    mods = {
        "sbs": datasets.load_pcawg_sbs(),
        "indel": datasets.load_pcawg_indel(),
        "sv": datasets.load_pcawg_sv(),
    }

    def fresh():
        return MultimodalCorrNMF(
            ns_signatures=[5, 4, 3], dim_embeddings=3, init_method="random",
            min_iterations=100, max_iterations=500, tol=1e-7,
        )

    def mdata():
        return MuData({k: AnnData(v.copy()) for k, v in mods.items()})

    results = {}
    for n_restarts in (4, 16):
        fit_best_of(fresh(), mdata(), n_restarts, base_seed=100,
                    batched_init=True)  # warm compile for this R
        start = time.perf_counter()
        summary = fit_best_of(fresh(), mdata(), n_restarts, base_seed=0,
                              batched_init=True)
        elapsed = time.perf_counter() - start
        total = int(np.sum(summary.n_iterations))
        results[n_restarts] = {
            "steady_seconds": round(elapsed, 2),
            "total_em_cycles": total,
            "aggregate_em_cycles_per_sec": round(total / elapsed, 1),
            "best_elbo": round(float(summary.losses[summary.best_index]), 1),
        }
        log(f"config4b R={n_restarts}: {results[n_restarts]}")
    emit({"config": "4b_multimodal_multistart", "per_restarts": results})


def config4c_multimodal_multistart_compaction():
    """Lane compaction on multimodal multi-start: the joint EM cycle is
    the package's most expensive block and lanes disperse hard."""
    from salamander_tpu.models import MultimodalCorrNMF
    from salamander_tpu.parallel import fit_best_of

    mods = {
        "sbs": datasets.load_pcawg_sbs(),
        "indel": datasets.load_pcawg_indel(),
        "sv": datasets.load_pcawg_sv(),
    }

    def fresh():
        return MultimodalCorrNMF(
            ns_signatures=[5, 4, 3], dim_embeddings=3, init_method="random",
            min_iterations=100, max_iterations=2000, tol=1e-7,
        )

    def mdata():
        return MuData({k: AnnData(v.copy()) for k, v in mods.items()})

    n_restarts = 16
    results = {}
    for label, compact in (("plain", False), ("compacting", True)):
        fit_best_of(fresh(), mdata(), n_restarts, base_seed=100,
                    compact=compact, compact_min_bucket=4,
                    batched_init=True)  # warm
        best = None
        for _ in range(2):
            start = time.perf_counter()
            summary = fit_best_of(fresh(), mdata(), n_restarts, base_seed=0,
                                  compact=compact, compact_min_bucket=4,
                                  batched_init=True)
            best = min(best or np.inf, time.perf_counter() - start)
        total = int(np.sum(summary.n_iterations))
        results[label] = {
            "steady_seconds": round(best, 2),
            "aggregate_em_cycles_per_sec": round(total / best, 1),
            "best_elbo": round(float(summary.losses[summary.best_index]), 1),
            "iteration_spread": [int(summary.n_iterations.min()),
                                 int(summary.n_iterations.max())],
        }
        log(f"config4c {label}: {results[label]}")
    results["speedup"] = round(
        results["plain"]["steady_seconds"]
        / results["compacting"]["steady_seconds"], 2
    )
    emit({"config": "4c_multimodal_multistart_compaction_16", **results})


def config3d_corrnmf_multistart_compaction():
    """Lane compaction on CorrNMF multi-start convergence fits: restarts
    disperse hard under the default convergence rule (the Newton embedding
    updates make every extra lockstep cycle expensive), which is exactly
    the regime compaction targets. Warm walls, compact off vs on."""
    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu.parallel import fit_best_of

    sbs = datasets.load_pcawg_sbs()
    n_restarts = 64

    def fresh():
        return CorrNMFDet(n_signatures=5, dim_embeddings=2,
                          min_iterations=100, max_iterations=2000, tol=1e-7)

    results = {}
    for label, compact in (("plain", False), ("compacting", True)):
        fit_best_of(fresh(), AnnData(sbs.copy()), n_restarts, base_seed=100,
                    compact=compact, compact_min_bucket=8)  # warm compile
        best = None
        for _ in range(2):
            model = fresh()
            start = time.perf_counter()
            summary = fit_best_of(model, AnnData(sbs.copy()), n_restarts,
                                  base_seed=0, compact=compact,
                                  compact_min_bucket=8)
            elapsed = time.perf_counter() - start
            if best is None or elapsed < best:
                best = elapsed
        total = int(np.sum(summary.n_iterations))
        results[label] = {
            "steady_seconds": round(best, 2),
            "total_em_cycles": total,
            "aggregate_em_cycles_per_sec": round(total / best, 1),
            "best_elbo": round(float(summary.losses[summary.best_index]), 1),
            "iteration_spread": [int(summary.n_iterations.min()),
                                 int(summary.n_iterations.max())],
        }
        log(f"config3d {label}: {results[label]}")
    results["speedup"] = round(
        results["plain"]["steady_seconds"]
        / results["compacting"]["steady_seconds"], 2
    )
    emit({"config": "3d_corrnmf_multistart_compaction_64", **results})


def config2c_scan_compaction_boundary():
    """Compaction on/off for the MvNMF and CorrNMF scan drivers at the
    auto-policy boundary (warm, interleaved): MvNMF lanes disperse, while
    the CorrNMF case here is CAP-BOUND (max_iterations=500; most lanes
    never free), the case where compaction has nothing to drop."""
    from salamander_tpu.parallel import rank_scan_corrnmf, rank_scan_mvnmf

    sbs = datasets.load_pcawg_sbs()  # (D, V) sample orientation
    mv_cfg = FitConfig(min_iterations=500, max_iterations=8000,
                       conv_test_freq=10, tol=1e-7)
    co_cfg = FitConfig(min_iterations=50, max_iterations=500,
                       conv_test_freq=10, tol=1e-7)

    def mv(n_restarts, compact):
        return rank_scan_mvnmf(sbs.T, range(5, 9), n_restarts, seed=0,
                               config=mv_cfg, compact=compact,
                               compact_min_bucket=4)

    def co(n_restarts, compact):
        return rank_scan_corrnmf(sbs.copy(), range(2, 6), dim_embeddings=2,
                                 n_restarts=n_restarts, base_seed=0,
                                 config=co_cfg, build_models=False,
                                 compact=compact, compact_min_bucket=4)

    results = {}
    for family, fn in (("mvnmf", mv), ("corrnmf_cap_bound", co)):
        for n_restarts in (8, 32):
            for label, compact in (("plain", False), ("compacting", True)):
                fn(n_restarts, compact)  # warm compile
                walls = []
                for _ in range(2):
                    start = time.perf_counter()
                    fn(n_restarts, compact)
                    walls.append(time.perf_counter() - start)
                key = f"{family}_R{n_restarts}_{label}"
                results[key] = round(min(walls), 2)
                log(f"config2c {key}: {results[key]}s")
    emit({"config": "2c_scan_compaction_boundary", **results})


def config6_ardnmf():
    """ARD rank inference vs the 19-rank scan (config 5): ONE over-complete
    ARDNMF fit (K_max=20) on the planted-k=8 96x10k cohort infers the rank
    the scan searches for. Reports steady single-fit wall + an R=8
    multi-start (lockstep engine, device-batched init), and whether the
    inferred rank hits the planted 8."""
    from salamander_tpu import fit_best_of
    from salamander_tpu.models import ARDNMF

    X = datasets.synthetic_catalog(n_features=96, n_samples=10_000,
                                   n_signatures=8, seed=0)
    adata = AnnData(X.T)

    def fresh():
        return ARDNMF(n_signatures=20, a=5.0, min_iterations=500,
                      max_iterations=20000)

    fresh().fit(adata.copy(), init_kwargs={"seed": 7})  # warm compile
    t0 = time.perf_counter()
    model = fresh().fit(adata.copy(), init_kwargs={"seed": 1})
    single_wall = time.perf_counter() - t0
    n_iter = model.history["n_iterations"]
    log(f"config6 single fit: {single_wall:.2f}s steady, {n_iter} iterations,"
        f" active {model.n_active_signatures}/20 (truth 8)")

    multi = ARDNMF(n_signatures=20, a=5.0, init_method="random",
                   min_iterations=500, max_iterations=20000)
    fit_best_of(multi, adata.copy(), n_restarts=8, base_seed=100,
                batched_init=True)  # warm the batched programs
    t0 = time.perf_counter()
    summary = fit_best_of(multi, adata.copy(), n_restarts=8,
                          batched_init=True)
    multi_wall = time.perf_counter() - t0
    log(f"config6 R=8 multi-start: {multi_wall:.2f}s steady, active "
        f"{multi.n_active_signatures}/20")
    emit({
        "config": "6_ardnmf_rank_inference_96x10k",
        "single_fit_steady_seconds": round(single_wall, 2),
        "single_fit_iterations": int(n_iter),
        "single_fit_iterations_per_sec": round(n_iter / single_wall, 1),
        "inferred_rank_single": int(model.n_active_signatures),
        "multistart8_steady_seconds": round(multi_wall, 2),
        "multistart8_total_iterations": int(np.sum(summary.n_iterations)),
        "inferred_rank_multistart": int(multi.n_active_signatures),
        "planted_rank": 8,
    })


def config7_extraction():
    """De novo consensus extraction end-to-end on PCAWG-breast SBS:
    ranks 2..10 x 20 bootstrap replicates = 180 (rank, replicate) lanes,
    every lane a full de novo KLNMF fit of its own resampled counts to
    convergence inside ONE K-padded lockstep program, plus host consensus
    clustering, the shared consensus-exposure refit, and the final fitted
    model. The reference-style equivalent is 180 serial numpy MU fits
    (its tutorial's restart loop has no resampling/consensus machinery at
    all); the stand-in extrapolates bench.py's measured per-iteration CPU
    cost over the same number of lane iterations."""
    import bench

    from salamander_tpu.extraction import extract_signatures

    sbs = datasets.load_pcawg_sbs()
    ranks = range(2, 11)

    t0 = time.perf_counter()
    result = extract_signatures(sbs, ranks, n_bootstraps=20, seed=0)
    cold_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = extract_signatures(sbs, ranks, n_bootstraps=20, seed=0)
    steady_wall = time.perf_counter() - t0

    total_iters = int(sum(
        int(np.sum(it)) for it in result.replicate_iterations.values()
    ))
    cpu_iters_per_sec = bench.measure_cpu_baseline(
        np.ascontiguousarray(sbs.to_numpy())
    )
    cpu_seconds_est = total_iters / cpu_iters_per_sec
    log(f"config7: cold {cold_wall:.1f}s, steady {steady_wall:.1f}s, "
        f"{total_iters} lane iterations, suggested rank "
        f"{result.suggested_rank}, CPU stand-in est {cpu_seconds_est:.0f}s")
    emit({
        "config": "7_extraction_pcawg_r2-10_b20",
        "cold_wall_seconds": round(cold_wall, 1),
        "steady_wall_seconds": round(steady_wall, 1),
        "n_lanes": 180,
        "total_lane_iterations": total_iters,
        "aggregate_mu_iterations_per_sec": round(total_iters / steady_wall, 1),
        "suggested_rank": result.suggested_rank,
        "cpu_standin_seconds_estimate": round(cpu_seconds_est, 1),
        "speedup_estimate": round(cpu_seconds_est / steady_wall, 1),
    })


def config7b_extraction_chunked():
    """Extraction at cohort scale: 96 x 200,000 planted-k=5 counts, ranks
    2..10 x 10 bootstraps = 90 lanes at ~285 MB of per-lane residency
    (bootstrap counts + MU temporaries); beyond the auto lane budget
    (device.memory_budget) the discovery fit runs as chunks (one resident
    at a time; identical results by the lane-keyed draw design). The
    reference loads all of X up front and runs restarts serially on the
    host."""
    from salamander_tpu.extraction import extract_signatures

    import pandas as pd

    X = datasets.synthetic_catalog(n_features=96, n_samples=200_000,
                                   n_signatures=5, seed=0)
    data = pd.DataFrame(X.T)  # samples x features
    t0 = time.perf_counter()
    result = extract_signatures(
        data, ranks=range(2, 11), n_bootstraps=10, seed=0, fit_final=False,
    )
    wall = time.perf_counter() - t0
    total_iters = int(sum(
        int(np.sum(it)) for it in result.replicate_iterations.values()
    ))
    log(f"config7b: {wall:.1f}s end-to-end ({total_iters} lane iterations),"
        f" suggested rank {result.suggested_rank} (planted 5)")
    emit({
        "config": "7b_extraction_chunked_96x200k",
        "wall_seconds": round(wall, 1),
        "n_lanes": 90,
        "n_chunks": 6,
        "lane_data_gb": round(90 * 96 * 200_000 * 4 / 2**30, 1),
        "total_lane_iterations": total_iters,
        "suggested_rank": result.suggested_rank,
        "planted_rank": 5,
    })


def config8_assignment():
    """Catalog workflows on PCAWG-breast vs COSMIC v3.3 (79 signatures):
    dense exposure refit (one masked-MU program over the cohort), sparse
    per-sample assignment (greedy backward elimination, all (sample,
    candidate) pairs one vmapped lane axis per round), and the de novo
    decomposition of a 5-signature extraction consensus. The sparse job is
    what the reference's ecosystem delegates to SigProfilerAssignment's
    host loops."""
    from salamander_tpu import assign_exposures, assign_signatures
    from salamander_tpu.tools import decompose_signatures

    sbs = datasets.load_pcawg_sbs()
    cosmic = datasets.load_cosmic_sbs_catalog()

    assign_exposures(sbs, cosmic)  # warm
    t0 = time.perf_counter()
    dense = assign_exposures(sbs, cosmic)
    dense_wall = time.perf_counter() - t0

    assign_signatures(sbs, cosmic, rel_tol=0.02)  # warm
    t0 = time.perf_counter()
    sparse = assign_signatures(sbs, cosmic, rel_tol=0.02)
    sparse_wall = time.perf_counter() - t0

    from salamander_tpu.extraction import extract_signatures

    consensus = extract_signatures(
        sbs, ranks=[5], n_bootstraps=20, seed=0, fit_final=False,
    ).consensus[5]
    decompose_signatures(consensus, cosmic)  # warm
    t0 = time.perf_counter()
    decomposition = decompose_signatures(consensus, cosmic)
    decomp_wall = time.perf_counter() - t0

    log(f"config8: dense {dense_wall:.2f}s, sparse {sparse_wall:.2f}s "
        f"(mean support {sparse.n_active.mean():.1f}/79), decompose "
        f"{decomp_wall:.2f}s (mean support "
        f"{decomposition.active.to_numpy().sum(1).mean():.1f})")
    emit({
        "config": "8_catalog_assignment_pcawg_cosmic79",
        "dense_refit_steady_seconds": round(dense_wall, 2),
        "sparse_assignment_steady_seconds": round(sparse_wall, 2),
        "sparse_mean_support": round(float(sparse.n_active.mean()), 1),
        "sparse_mean_kl_increase_pct": round(float(
            (sparse.kl_sparse / sparse.kl_dense - 1).mean() * 100
        ), 2),
        "decompose_consensus5_steady_seconds": round(decomp_wall, 2),
        "decompose_mean_support": round(float(
            decomposition.active.to_numpy().sum(1).mean()
        ), 1),
        "decompose_min_cosine": round(float(decomposition.cosine.min()), 4),
        "n_samples": int(sbs.shape[0]),
        "n_catalog": int(cosmic.shape[0]),
    })


def config8b_assignment_cohort():
    """Sparse catalog assignment at cohort scale: synthetic 100,000 samples
    (planted 5-signature mixtures) against the full COSMIC v3.3 catalog
    (79 signatures). The acceptance invariant
    (kl_sparse <= 1.02 * kl_dense per sample) is asserted, not just
    reported."""
    from salamander_tpu import assign_signatures

    import numpy as np

    rng = np.random.default_rng(0)
    cosmic = datasets.load_cosmic_sbs_catalog()          # (79, 96)
    W = cosmic.to_numpy().T                              # (96, 79)
    W = W / W.sum(axis=0, keepdims=True)
    D = 100_000
    planted = rng.choice(79, size=5, replace=False)
    H = np.zeros((79, D))
    H[planted] = rng.gamma(2.0, 400.0, size=(5, D))
    X = rng.poisson(W @ H).astype(np.float64)
    X[X == 0] = 1.0
    import pandas as pd

    data = pd.DataFrame(X.T, columns=cosmic.columns)

    t0 = time.perf_counter()
    sparse = assign_signatures(data, cosmic, rel_tol=0.02)
    wall = time.perf_counter() - t0
    kd = sparse.kl_dense.to_numpy()
    ks = sparse.kl_sparse.to_numpy()
    # EXACT acceptance contract since round 5: the same-program finalize
    # (ops/assign._finalize_contract) reports the selected evaluations,
    # so no sample may exceed the budget in the reported numbers (f32
    # runs may show one ulp re-deriving the budget on host from the
    # reported values; this config runs f64 inputs, so exact).
    excess = (ks - 1.02 * kd) / np.abs(kd)
    # threshold = one f32 ulp: re-deriving the budget on host in f64 from
    # the reported f32 values can differ from the in-program f32 budget
    # by a single rounding; anything beyond that is a real violation
    assert excess.max() <= 1.5e-7, (
        f"acceptance budget contract violated: max rel excess "
        f"{excess.max():.2e} on {int((excess > 0).sum())} samples"
    )
    log(f"config8b: sparse assignment of {D} samples vs 79 catalog sigs "
        f"in {wall:.1f}s (mean support {sparse.n_active.mean():.1f}, "
        f"max budget excess {max(excess.max(), 0):.1e})")
    emit({
        "config": "8b_assignment_cohort_100k_cosmic79",
        "wall_seconds": round(wall, 1),
        "n_samples": D,
        "n_catalog": 79,
        "mean_support": round(float(sparse.n_active.mean()), 1),
        "mean_kl_increase_pct": round(float(
            (sparse.kl_sparse / sparse.kl_dense - 1).mean() * 100
        ), 2),
        "max_budget_excess_rel": round(float(max(excess.max(), 0.0)), 8),
    })


def config3e_corrnmf_cohort_multistart():
    """CorrNMF multi-start at cohort scale (96 x 200k, R=8): the
    composition of fit_best_of x lane compaction x batched Newton, with an
    uncompacted R=4 control whose lanes 0-3 must agree within the f32
    program-boundary class."""
    from salamander_tpu.containers import AnnData
    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu import fit_best_of

    import numpy as np

    rng = np.random.default_rng(0)
    V, D, K = 96, 200_000, 5
    W = rng.dirichlet(np.ones(V) * 0.3, size=K)
    H = rng.gamma(2.0, 30.0, size=(D, K))
    X = rng.poisson(H @ W).astype(np.float32) + np.float32(1.0)

    def run(R, compact):
        model = CorrNMFDet(n_signatures=K, dim_embeddings=2,
                           init_method="random", min_iterations=200,
                           max_iterations=2000, conv_test_freq=10, tol=1e-6)
        t0 = time.perf_counter()
        summary = fit_best_of(model, AnnData(X.copy()), R, base_seed=0,
                              compact=compact)
        return summary, time.perf_counter() - t0

    run(8, None)                       # compile
    s8, w8 = run(8, None)              # warm compacted
    s4, w4 = run(4, False)             # warm uncompacted control
    rel = float(np.max(np.abs(s8.losses[:4] - s4.losses)
                       / np.abs(s4.losses)))
    assert rel < 1e-4, f"compacted lanes diverged from control: {rel:.2e}"
    agg = int(np.sum(s8.n_iterations)) / w8
    log(f"config3e: R=8 compacted {w8:.1f}s ({agg:.1f} agg cycles/s), "
        f"control rel diff {rel:.1e}")
    emit({
        "config": "3e_corrnmf_cohort_multistart_96x200k",
        "warm_wall_seconds_R8_compacted": round(w8, 1),
        "agg_cycles_per_sec": round(agg, 1),
        "warm_wall_seconds_R4_control": round(w4, 1),
        "lane_elbo_rel_diff_vs_control": rel,
    })


def config4d_multimodal_cohort_multistart():
    """Multimodal multi-start at cohort scale ({96, 83} x 100k, R=4)
    through the same runner stack."""
    from salamander_tpu.containers import AnnData, MuData
    from salamander_tpu.models import MultimodalCorrNMF
    from salamander_tpu import fit_best_of

    import numpy as np

    rng = np.random.default_rng(1)
    D = 100_000
    mods = {}
    for name, V, K in (("sbs", 96, 4), ("indel", 83, 3)):
        W = rng.dirichlet(np.ones(V) * 0.3, size=K)
        H = rng.gamma(2.0, 25.0, size=(D, K))
        mods[name] = (
            rng.poisson(H @ W).astype(np.float32) + np.float32(1.0)
        )

    def run():
        model = MultimodalCorrNMF(ns_signatures=[4, 3], dim_embeddings=3,
                                  init_method="random", min_iterations=100,
                                  max_iterations=500, conv_test_freq=10,
                                  tol=1e-6)
        t0 = time.perf_counter()
        summary = fit_best_of(
            model,
            MuData({k: AnnData(v.copy()) for k, v in mods.items()}),
            4, base_seed=0,
        )
        return summary, time.perf_counter() - t0

    run()                              # compile
    s, wall = run()                    # warm
    agg = int(np.sum(s.n_iterations)) / wall
    log(f"config4d: multimodal 2x100k R=4 warm {wall:.1f}s "
        f"({agg:.1f} agg joint cycles/s)")
    emit({
        "config": "4d_multimodal_cohort_multistart_2x100k",
        "warm_wall_seconds": round(wall, 1),
        "agg_joint_cycles_per_sec": round(agg, 1),
        "best_elbo": float(s.losses[s.best_index]),
    })


CONFIGS = {
    "1": config1_klnmf_restarts,
    "2": config2_mvnmf,
    "2b": config2b_mvnmf_rank_scan_padded,
    "2c": config2c_scan_compaction_boundary,
    "2d": config2d_mvnmf_multistart,
    "3": config3_corrnmf,
    "3b": config3b_corrnmf_multistart,
    "3c": config3c_corrnmf_svi,
    "3d": config3d_corrnmf_multistart_compaction,
    "3e": config3e_corrnmf_cohort_multistart,
    "4": config4_multimodal,
    "4b": config4b_multimodal_multistart,
    "4c": config4c_multimodal_multistart_compaction,
    "4d": config4d_multimodal_cohort_multistart,
    "5": config5_rank_scan,
    "5b": config5b_rank_scan_padded,
    "5d": config5d_rank_scan_auto,
    "6": config6_ardnmf,
    "7": config7_extraction,
    "7b": config7b_extraction_chunked,
    "8": config8_assignment,
    "8b": config8b_assignment_cohort,
}


if __name__ == "__main__":
    from salamander_tpu.device import enable_compile_cache

    enable_compile_cache()
    selected = sys.argv[1:] or list(CONFIGS)
    for name in selected:
        log(f"=== config {name} ===")
        CONFIGS[name]()

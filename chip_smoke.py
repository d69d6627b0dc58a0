"""Smoke test of the device fit path on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: phases 1-5
    python chip_smoke.py --four-gpus  # four GPUs: the mesh fits only

Drives the normal entry points (fit_klnmf_restarts, rank_scan_mvnmf,
rank_scan_corrnmf, KLNMF.fit) at the sizes users run and compares every
result with the same call on the CPU, or with the plain numpy float64 MU
loop. The CPU side runs first, in a child process of this script started
with JAX_PLATFORMS=cpu (``--cpu-reference``), so it cannot reach the card;
the child reports its platform and the parent checks it. Each phase prints
one JSON line with its cold wall (first call in the process, compile
included) and warm wall (second identical call); the card's name and power
limit come from nvidia-smi. The last line of stdout is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

A failed comparison is reported on stderr when it happens; after the last
phase the script then exits non-zero and prints no result line. An error
inside a phase stops the script at once. It refuses to run (non-zero exit)
when JAX's default device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

EPS32 = float(np.finfo(np.float32).eps)
# best-of-restarts agreement across devices and layouts (the repo's layout
# rule: per-lane results may differ by f32 ulps, best losses may not)
BEST_RTOL = 1e-4
# final-objective agreement for fits whose steps are decided by
# data-dependent inner loops (MvNMF line search, CorrNMF Newton solves)
LOOP_RTOL = 1e-3
# limit of gap_ratio: float32 MU steps on the card may stray from float64
# at most this much further than the CPU's float32 steps do. On an H100 at
# HIGHEST the per-seed ratio of 16 lanes read 0.94-1.53 over five seeds,
# HIGH 121-214 and DEFAULT 777-1080 (scripts/precision_check.py); the check
# runs GAP_LANES lanes, which narrows the spread of the median.
GAP_RATIO_LIMIT = 2.0
GAP_LANES = 64

# sizes shared by a phase and its CPU reference
N_SIGNATURES = 5
PCAWG_RESTARTS = 100
MVNMF_RESTARTS = 16
CORRNMF_RESTARTS = 8
FIXED_CYCLES = 300


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def timed(fn):
    """(result, cold seconds, warm seconds) of two identical calls, each
    ending when its outputs are ready."""
    import jax

    walls = []
    for _ in range(2):
        start = time.perf_counter()
        result = jax.block_until_ready(fn())
        walls.append(time.perf_counter() - start)
    return result, walls[0], walls[1]


def rel(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


FAILED: list[str] = []


def check(name: str, value: float, limit: float) -> None:
    """Record a comparison; main() fails the run if any exceeded its
    limit."""
    if not value <= limit:
        FAILED.append(f"{name} = {value!r} exceeds {limit!r}")
        print(f"chip_smoke: FAILED {FAILED[-1]}", file=sys.stderr,
              flush=True)


def pcawg_counts() -> np.ndarray:
    """PCAWG breast SBS counts, (96 channels, 192 samples), float64."""
    from salamander_tpu.datasets import read_counts_csv

    return read_counts_csv("pcawg_sbs")[0]


# -- numpy float64 twin of the KLNMF update (ops.klnmf.update_WH) ----------

def np_update_wh(X, W, H):
    aux = X / (W @ H)
    W_new = W * (aux @ H.T)
    W_new = np.maximum(W_new / W_new.sum(axis=0), EPS32)
    H_new = np.maximum(H * (W.T @ aux), EPS32)
    return W_new, H_new


def lane_gaps(X, seed: int = 1, n_lanes: int = 16,
              n_signatures: int = N_SIGNATURES,
              n_iterations: int = 200) -> list[float]:
    """From initial W, H drawn with `seed`, run `n_iterations` float32 MU
    steps of `n_lanes` lanes through the multi-start runner on the default
    device, and the same steps in numpy float64. Returns each lane's gap:
    the relative Frobenius error of its float32 (W, H)."""
    import jax.numpy as jnp

    from salamander_tpu.engine import FitConfig
    from salamander_tpu.parallel.restarts import build_klnmf_restart_runner

    rng = np.random.default_rng(seed)
    V, D = X.shape
    W0 = rng.dirichlet(np.ones(V), size=(n_lanes, n_signatures))
    W0 = W0.transpose(0, 2, 1)
    H0 = rng.uniform(0.5, 1.5, size=(n_lanes, n_signatures, D))
    H0 *= X.sum(axis=0) / n_signatures
    config = FitConfig(min_iterations=n_iterations,
                       max_iterations=n_iterations, conv_test_freq=10,
                       tol=0.0)
    params, _, _ = build_klnmf_restart_runner(config)(
        {"W": jnp.asarray(W0, jnp.float32),
         "H": jnp.asarray(H0, jnp.float32)},
        {"X": jnp.asarray(X, jnp.float32)},
    )
    gaps = []
    for lane in range(n_lanes):
        W, H = W0[lane], H0[lane]
        for _ in range(n_iterations):
            W, H = np_update_wh(X, W, H)
        ref = np.concatenate([W.ravel(), H.ravel()])
        got = np.concatenate([
            np.asarray(params["W"][lane], np.float64).ravel(),
            np.asarray(params["H"][lane], np.float64).ravel(),
        ])
        gaps.append(float(np.linalg.norm(got - ref) / np.linalg.norm(ref)))
    return gaps


def gap_ratio(device_lanes, cpu_lanes) -> float:
    """How much further the device's float32 lanes stray from float64 than
    the CPU's: the median over lanes of the per-lane gap ratio. Each
    lane's gap is its own rounding draw amplified by its own sensitivity;
    the per-lane ratio cancels the sensitivity and the median drops the
    draws that land far out."""
    return float(np.median(np.asarray(device_lanes)
                           / np.asarray(cpu_lanes)))


# -- the fits each phase times and its CPU reference repeats ---------------

def klnmf_pcawg_fit(X):
    """KLNMF multi-start on PCAWG with the reference's default rule."""
    from salamander_tpu.engine import FitConfig
    from salamander_tpu.parallel import fit_klnmf_restarts

    config = FitConfig(min_iterations=500, max_iterations=10_000,
                       conv_test_freq=10, tol=1e-7)
    return fit_klnmf_restarts(X, N_SIGNATURES, PCAWG_RESTARTS, seed=0,
                              config=config)


def fixed_config():
    """A fixed cycle budget: converged MvNMF/CorrNMF fits stop at cycles
    that f32 ulps move, so cross-device comparisons run the same cycles."""
    from salamander_tpu.engine import FitConfig

    return FitConfig(min_iterations=FIXED_CYCLES,
                     max_iterations=FIXED_CYCLES, conv_test_freq=10,
                     tol=0.0)


def mvnmf_point(X, config=None):
    """(best objective, iterations, every restart's objective) of one
    rank_scan_mvnmf point."""
    from salamander_tpu.parallel import rank_scan_mvnmf

    point = rank_scan_mvnmf(X, [N_SIGNATURES], MVNMF_RESTARTS, seed=0,
                            config=config)[N_SIGNATURES]
    return (point.best_loss, int(np.sum(point.n_iterations)),
            np.asarray(point.losses, np.float64).tolist())


def corrnmf_point(X, config=None):
    """(best objective, iterations, every restart's objective) of one
    rank_scan_corrnmf point, dim 2 (its objective is maximized)."""
    from salamander_tpu.parallel import rank_scan_corrnmf

    point = rank_scan_corrnmf(X.T, [N_SIGNATURES], dim_embeddings=2,
                              n_restarts=CORRNMF_RESTARTS, config=config,
                              build_models=False)[N_SIGNATURES]
    return (float(np.max(point.losses)), int(np.sum(point.n_iterations)),
            np.asarray(point.losses, np.float64).tolist())


def model_api_fit(X):
    """KLNMF(n_signatures).fit(AnnData) through the public class API."""
    from salamander_tpu import AnnData
    from salamander_tpu.models import KLNMF

    model = KLNMF(n_signatures=N_SIGNATURES)
    model.fit(AnnData(X.T.copy()), init_kwargs={"seed": 0})
    return model


def reference_values(X) -> dict:
    """Every value phases 2, 4 and 5 compare with, computed on the default
    device (the CPU in the ``--cpu-reference`` child)."""
    import jax

    model = model_api_fit(X)
    reference = {
        "platform": jax.devices()[0].platform,
        "klnmf_best": klnmf_pcawg_fit(X).best_loss,
        "lane_gaps": lane_gaps(X, n_lanes=GAP_LANES),
        "model_final": float(model.history["objective_function"][-1]),
        "model_n_iterations": int(model.history["n_iterations"]),
    }
    for family, point in (("mvnmf", mvnmf_point), ("corrnmf", corrnmf_point)):
        best, _, losses = point(X, fixed_config())
        reference[f"{family}_fixed_best"] = best
        reference[f"{family}_fixed_losses"] = losses
    return reference


def cpu_reference(timeout: float = 900.0) -> dict:
    """reference_values from a child process of this script that runs with
    JAX_PLATFORMS=cpu and so cannot reach the card."""
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--cpu-reference"],
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    if out.returncode != 0:
        raise RuntimeError(f"CPU reference run failed (exit "
                           f"{out.returncode}):\n{out.stderr[-4000:]}")
    reference = json.loads(out.stdout.strip().splitlines()[-1])
    if reference["platform"] != "cpu":
        raise RuntimeError(f"CPU reference ran on {reference['platform']}")
    return reference


# -- phases ----------------------------------------------------------------

def phase_klnmf_pcawg(X, reference: dict):
    """KLNMF multi-start on PCAWG against the CPU, and the float32-to-
    float64 gap of 200 fixed MU steps against the CPU's gap."""
    result, cold, warm = timed(lambda: klnmf_pcawg_fit(X))
    device_lanes = lane_gaps(X, n_lanes=GAP_LANES)
    ratios = np.asarray(device_lanes) / np.asarray(reference["lane_gaps"])
    record = {
        "phase": "klnmf_pcawg", "shape": list(X.shape), "k": N_SIGNATURES,
        "restarts": PCAWG_RESTARTS, "cold_s": cold, "warm_s": warm,
        "best_loss": result.best_loss, "cpu_best_loss": reference["klnmf_best"],
        "best_rel": rel(result.best_loss, reference["klnmf_best"]),
        "iterations_min": int(result.n_iterations.min()),
        "iterations_max": int(result.n_iterations.max()),
        "iterations_sum": int(result.n_iterations.sum()),
        "gap_ratio": gap_ratio(device_lanes, reference["lane_gaps"]),
        "gap_lanes": GAP_LANES,
        "device_gap_median": float(np.median(device_lanes)),
        "cpu_gap_median": float(np.median(reference["lane_gaps"])),
        "lane_ratio_min": float(ratios.min()),
        "lane_ratio_max": float(ratios.max()),
    }
    emit(record)
    check("klnmf_pcawg best_rel", record["best_rel"], BEST_RTOL)
    check("klnmf_pcawg gap_ratio", record["gap_ratio"], GAP_RATIO_LIMIT)
    return record


def phase_klnmf_cohort(n_samples: int = 10_000, n_restarts: int = 100,
                       n_signatures: int = 8):
    """KLNMF multi-start at cohort width, compaction auto vs off."""
    from salamander_tpu.datasets import synthetic_catalog
    from salamander_tpu.parallel import fit_klnmf_restarts

    X = synthetic_catalog(96, n_samples, n_signatures, seed=0)
    record = {"phase": "klnmf_cohort", "shape": list(X.shape),
              "k": n_signatures, "restarts": n_restarts}
    best = {}
    for label, compact in (("auto", None), ("off", False)):
        result, cold, warm = timed(lambda: fit_klnmf_restarts(
            X, n_signatures, n_restarts, seed=0, compact=compact,
        ))
        best[label] = result.best_loss
        record.update({
            f"{label}_cold_s": cold, f"{label}_warm_s": warm,
            f"{label}_best_loss": result.best_loss,
            f"{label}_iterations_sum": int(result.n_iterations.sum()),
        })
    record["best_rel"] = rel(best["auto"], best["off"])
    emit(record)
    check("klnmf_cohort best_rel", record["best_rel"], BEST_RTOL)
    return record


def phase_mvnmf_corrnmf(X, reference: dict):
    """One rank_scan_mvnmf and one rank_scan_corrnmf point on PCAWG, each
    run to convergence (timed) and at the fixed cycle budget, which is
    compared with the CPU."""
    for name, fit, restarts in (
        ("mvnmf_scan_point", mvnmf_point, MVNMF_RESTARTS),
        ("corrnmf_scan_point", corrnmf_point, CORRNMF_RESTARTS),
    ):
        (best, iterations, _), cold, warm = timed(lambda: fit(X))
        fixed_best, _, fixed_losses = fit(X, fixed_config())
        family = name.split("_")[0]
        cpu_fixed_best = reference[f"{family}_fixed_best"]
        record = {
            "phase": name, "k": N_SIGNATURES, "restarts": restarts,
            "cold_s": cold, "warm_s": warm, "best_objective": best,
            "iterations_sum": iterations, "fixed_cycles": FIXED_CYCLES,
            "fixed_best": fixed_best, "cpu_fixed_best": cpu_fixed_best,
            "fixed_rel": rel(fixed_best, cpu_fixed_best),
            "fixed_losses": fixed_losses,
            "cpu_fixed_losses": reference[f"{family}_fixed_losses"],
        }
        if name == "corrnmf_scan_point":
            record["dim"] = 2
        emit(record)
        check(f"{name} fixed_rel", record["fixed_rel"], LOOP_RTOL)


def phase_model_api(X, reference: dict):
    """KLNMF(n_signatures).fit(AnnData) through the public class API,
    against the CPU's final objective."""
    model, cold, warm = timed(lambda: model_api_fit(X))
    signatures = model.signatures.to_numpy()
    exposures = model.exposures.to_numpy()
    trace = np.asarray(model.history["objective_function"])
    record = {
        "phase": "model_api", "k": N_SIGNATURES, "cold_s": cold,
        "warm_s": warm, "n_iterations": model.history["n_iterations"],
        "cpu_n_iterations": reference["model_n_iterations"],
        "final_objective": float(trace[-1]),
        "cpu_final_objective": reference["model_final"],
        "final_rel": rel(trace[-1], reference["model_final"]),
        "signatures_shape": list(signatures.shape),
        "exposures_shape": list(exposures.shape),
    }
    emit(record)
    if signatures.shape != (X.shape[0], N_SIGNATURES) and \
            signatures.shape != (N_SIGNATURES, X.shape[0]):
        raise AssertionError(f"signatures shape {signatures.shape}")
    if exposures.shape != (X.shape[1], N_SIGNATURES):
        raise AssertionError(f"exposures shape {exposures.shape}")
    for name, value in (("signatures", signatures), ("exposures", exposures),
                        ("history", trace)):
        if not np.all(np.isfinite(value)):
            raise AssertionError(f"model_api {name} is not finite")
    if not trace[-1] <= trace[0]:
        raise AssertionError("model_api objective did not decrease")
    check("model_api final_rel", record["final_rel"], LOOP_RTOL)


def phase_four_gpus(n_samples: int = 10_000, n_restarts: int = 100,
                    n_signatures: int = 8):
    """Phase 3's fit and a sample-sharded CorrNMF fit on a 4-GPU mesh,
    each compared with the same fit on one card."""
    import jax

    from salamander_tpu import AnnData
    from salamander_tpu.datasets import synthetic_catalog
    from salamander_tpu.models import CorrNMFDet
    from salamander_tpu.parallel import fit_klnmf_restarts, make_mesh

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"chip_smoke --four-gpus: found {len(devices)} GPUs")
    X = synthetic_catalog(96, n_samples, n_signatures, seed=0)
    single = {}
    for compact in (False, True):
        result, cold, warm = timed(lambda: fit_klnmf_restarts(
            X, n_signatures, n_restarts, seed=0, compact=compact,
        ))
        single[compact] = result.best_loss
        emit({"phase": "klnmf_one_gpu", "compact": compact,
              "cold_s": cold, "warm_s": warm,
              "best_loss": result.best_loss})
    for sample_ways, compact in ((1, False), (4, False), (1, True),
                                 (4, True)):
        mesh = make_mesh(devices[:4], sample_ways=sample_ways)
        result, cold, warm = timed(lambda: fit_klnmf_restarts(
            X, n_signatures, n_restarts, seed=0, compact=compact, mesh=mesh,
        ))
        record = {"phase": "klnmf_four_gpus", "sample_ways": sample_ways,
                  "compact": compact, "cold_s": cold, "warm_s": warm,
                  "best_loss": result.best_loss,
                  "best_rel": rel(result.best_loss, single[compact])}
        emit(record)
        check("klnmf_four_gpus best_rel", record["best_rel"], BEST_RTOL)

    counts = pcawg_counts()

    def corr(mesh):
        # a fixed cycle budget: converged fits stop where f32 ulps put them
        model = CorrNMFDet(n_signatures=5, dim_embeddings=2,
                           min_iterations=300, max_iterations=300)
        model.fit(AnnData(counts.T.copy()), init_kwargs={"seed": 0},
                  mesh=mesh)
        return float(model.history["objective_function"][-1])

    one, one_cold, one_warm = timed(lambda: corr(None))
    mesh = make_mesh(devices[:4], sample_ways=4)
    four, cold, warm = timed(lambda: corr(mesh))
    record = {"phase": "corrnmf_sample_sharded", "sample_ways": 4,
              "cold_s": cold, "warm_s": warm, "one_gpu_cold_s": one_cold,
              "one_gpu_warm_s": one_warm, "objective": four,
              "one_gpu_objective": one, "rel": rel(four, one)}
    emit(record)
    check("corrnmf_sample_sharded rel", record["rel"], LOOP_RTOL)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-gpus", action="store_true",
                        help="run only the four-GPU mesh fits")
    parser.add_argument("--cpu-reference", action="store_true",
                        help="print the CPU comparison values as one JSON "
                             "line (the child run; needs JAX_PLATFORMS=cpu)")
    args = parser.parse_args(argv)

    import jax

    from salamander_tpu.device import (
        card_line,
        enable_compile_cache,
        require_gpu,
    )

    if args.cpu_reference:
        enable_compile_cache()
        emit(reference_values(pcawg_counts()))
        return 0
    device = require_gpu("chip_smoke")
    enable_compile_cache()
    print(card_line(), flush=True)
    emit({"phase": "device", "platform": device.platform,
          "kind": device.device_kind, "count": len(jax.devices())})
    if args.four_gpus:
        phase_four_gpus()
    else:
        X = pcawg_counts()
        start = time.perf_counter()
        reference = cpu_reference()
        emit({"phase": "cpu_reference", "platform": reference["platform"],
              "wall_s": time.perf_counter() - start})
        phase_klnmf_pcawg(X, reference)
        phase_klnmf_cohort()
        phase_mvnmf_corrnmf(X, reference)
        phase_model_api(X, reference)
    if FAILED:
        raise SystemExit("chip_smoke: failed: " + "; ".join(FAILED))
    devices = jax.devices()
    emit({"ok": True, "device": {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": len(devices)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Measure the bulk-update matmul precision on the GPU (ops/precision.py).

    python scripts/precision_check.py            # every setting, one table
    python scripts/precision_check.py --setting HIGH   # one setting

For each setting of ops.precision.MATMUL_PRECISION this runs, in a fresh
process (the policy is read at trace time, so a setting holds for a whole
process), the repo's three quality criteria on PCAWG breast SBS:

- the single fit (KLNMF(n_signatures=5).fit, seed 0): stop iteration and
  final KL, against the CPU float32 fit of the same seed;
- the best-of-100 loss of fit_klnmf_restarts (k=5, default rule);
- sparse assignment against COSMIC v3.3.1 SBS: samples whose sparse KL is
  over its budget (1 + rel_tol) * kl_dense, and the support sizes. The
  setting is applied to assignment's update matmuls too (production pins
  them at HIGHEST), so this criterion measures the setting itself;

the float32-vs-float64 gap of 200 fixed MU steps from identical starts,
per lane (chip_smoke.lane_gaps: 16 lanes for each of the seeds in
GAP_SEEDS), and chip_smoke.gap_ratio of each seed against the CPU's lanes;
and the throughput of a fixed window (100 restarts x 2,000 iterations,
aggregate MU iterations/s, warm). The CPU reference is a child run with
JAX_PLATFORMS=cpu (the CPU ignores matmul precision), so it cannot reach
the card. Children run one after another, so one process holds the card
at a time. Prints one JSON line per child and a markdown table at the end.
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

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SETTINGS = ("DEFAULT", "HIGH", "TF32_X3", "HIGHEST")
GAP_SEEDS = (1, 2, 3, 4, 5)


def _resolve(name: str):
    from jax import lax

    if name == "TF32_X3":
        return lax.DotAlgorithmPreset.TF32_TF32_F32_X3
    return getattr(lax.Precision, name)


def _single_fit(X):
    from salamander_tpu import AnnData
    from salamander_tpu.models import KLNMF

    model = KLNMF(n_signatures=5)
    model.fit(AnnData(X.T.copy()), init_kwargs={"seed": 0})
    return (int(model.history["n_iterations"]),
            float(model.history["objective_function"][-1]))


def _best_of_100(X):
    from salamander_tpu.parallel import fit_klnmf_restarts

    result = fit_klnmf_restarts(X, 5, 100, seed=0)
    return result.best_loss, int(result.n_iterations.sum())


def _assignment(X):
    from salamander_tpu import AnnData, assign_signatures
    from salamander_tpu.datasets import load_cosmic_sbs_catalog, load_pcawg_sbs

    counts = load_pcawg_sbs()
    assert np.array_equal(counts.to_numpy(), X.T)
    rel_tol = 0.02
    result = assign_signatures(AnnData(counts), load_cosmic_sbs_catalog(),
                               rel_tol=rel_tol)
    budget = (1 + rel_tol) * result.kl_dense.to_numpy()
    over = int(np.sum(result.kl_sparse.to_numpy() > budget))
    n_active = result.n_active.to_numpy()
    return over, int(n_active.min()), int(n_active.max())


def _window_rate(X, iterations: int = 2000):
    import jax
    import jax.numpy as jnp

    from salamander_tpu.engine import FitConfig
    from salamander_tpu.initialization.methods import random_init_batch
    from salamander_tpu.parallel.restarts import build_klnmf_restart_runner

    runner = build_klnmf_restart_runner(FitConfig(
        min_iterations=iterations, max_iterations=iterations,
        conv_test_freq=10, tol=1e-7,
    ))
    Xf = jnp.asarray(X, jnp.float32)
    W0, H0 = random_init_batch(jax.random.PRNGKey(0), Xf, 5, 100)
    jax.block_until_ready(runner({"W": W0, "H": H0}, {"X": Xf}))
    start = time.perf_counter()
    jax.block_until_ready(runner({"W": W0, "H": H0}, {"X": Xf}))
    return 100 * iterations / (time.perf_counter() - start)


def child(name: str) -> dict:
    """One setting's criteria on the card, or the CPU reference's
    (name "CPU", run with JAX_PLATFORMS=cpu)."""
    import jax

    import chip_smoke
    from salamander_tpu.datasets import read_counts_csv
    from salamander_tpu.device import enable_compile_cache, require_gpu
    from salamander_tpu.ops import assign as assign_ops
    from salamander_tpu.ops import precision

    if name == "CPU":
        device = jax.devices()[0]
        if device.platform != "cpu":
            raise SystemExit("precision_check: the CPU reference needs "
                             "JAX_PLATFORMS=cpu")
    else:
        device = require_gpu("precision_check")
        setting = _resolve(name)
        precision.MATMUL_PRECISION = setting
        assign_ops._HIGHEST = setting
    enable_compile_cache()
    X = read_counts_csv("pcawg_sbs")[0]
    record = {"setting": name, "device": device.device_kind}
    record["n_it"], record["single_kl"] = _single_fit(X)
    record["best_of_100"], record["best_of_100_iterations"] = _best_of_100(X)
    record["over_budget"], record["support_min"], record["support_max"] = (
        _assignment(X)
    )
    if name != "CPU":
        record["window_it_per_s"] = _window_rate(X)
    record["gap_lanes"] = {str(seed): chip_smoke.lane_gaps(X, seed=seed)
                           for seed in GAP_SEEDS}
    return record


def main() -> int:
    from salamander_tpu.device import card_line

    import chip_smoke

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--setting", choices=SETTINGS + ("CPU",))
    args = parser.parse_args()
    if args.setting:
        print(json.dumps(child(args.setting)), flush=True)
        return 0
    card = card_line()
    print(card, flush=True)
    rows = {}
    for name in ("CPU",) + SETTINGS:
        env = dict(os.environ)
        if name == "CPU":
            env["JAX_PLATFORMS"] = "cpu"
        out = subprocess.run(
            [sys.executable, __file__, "--setting", name],
            capture_output=True, text=True, env=env,
        )
        if out.returncode != 0:
            print(json.dumps({"setting": name, "error": out.stderr[-2000:]}))
            continue
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows[name] = row
    if "CPU" not in rows:
        return 1
    cpu_lanes = rows["CPU"]["gap_lanes"]
    for row in rows.values():
        row["gap_median"] = float(np.median(
            [gap for lanes in row["gap_lanes"].values() for gap in lanes]))
        row["ratios"] = [chip_smoke.gap_ratio(row["gap_lanes"][seed],
                                              cpu_lanes[seed])
                         for seed in row["gap_lanes"]]
    print(f"\n{card}\n")
    print("| setting | single-fit KL | n_it | best-of-100 | over budget "
          "| supports | median lane gap to f64 | gap_ratio by seed "
          "| window it/s |")
    print("|---|---|---|---|---|---|---|---|---|")
    for name, row in rows.items():
        ratios = ", ".join(f"{ratio:.3g}" for ratio in row["ratios"])
        rate = row.get("window_it_per_s")
        print(f"| {name} | {row['single_kl']:.2f} | {row['n_it']} "
              f"| {row['best_of_100']:.2f} | {row['over_budget']}/192 "
              f"| {row['support_min']}-{row['support_max']} "
              f"| {row['gap_median']:.3g} | {ratios} "
              f"| {'-' if rate is None else f'{rate:.0f}'} |")
    return 0 if len(rows) == len(SETTINGS) + 1 else 1


if __name__ == "__main__":
    sys.exit(main())

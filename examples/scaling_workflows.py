"""Round-3 scaling workflows: model-selection grids and beyond-memory streaming.

Three workflows the reference cannot express (it fits one model at a time,
fully in memory - /root/reference/src/salamander/models/signature_nmf.py
:269-281 loads all of X up front; its tutorial runs scans as Python loops):

1. a (n_signatures x dim_embeddings) CorrNMF model-selection GRID fitted as
   masked lanes of a few compiled programs, returning fitted models;
2. a K-padded minimum-volume (MvNMF) rank scan;
3. a streaming minibatch fit whose count matrix never touches the device
   whole - the single-device beyond-memory path.

Run from the repo root: python examples/scaling_workflows.py
(small shapes so it completes quickly on CPU or one GPU).
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from salamander_tpu import datasets
from salamander_tpu.containers import AnnData
from salamander_tpu.engine import FitConfig
from salamander_tpu.models import KLNMF
from salamander_tpu.parallel import rank_scan_corrnmf, rank_scan_mvnmf

X = datasets.load_pcawg_sbs().values.astype(float)  # (192 samples, 96)
config = FitConfig(min_iterations=100, max_iterations=500, tol=1e-6)

# -- 1. CorrNMF (k, m) grid: one compiled program per (Kp, mp) bucket ------
grid = rank_scan_corrnmf(
    X, n_signatures_range=range(2, 5), dim_embeddings_range=[2, 3],
    n_restarts=4, config=config,
)
print("CorrNMF model-selection grid (best ELBO per point):")
for (k, m), result in sorted(grid.items()):
    print(f"  k={k} m={m}: {result.best_loss:12.1f} "
          f"(restart spread {result.losses.max() - result.losses.min():.1f})")
best_point = max(grid, key=lambda key: grid[key].best_loss)
best_model = grid[best_point].model  # a FITTED CorrNMFDet
print(f"winner {best_point}: exposures {best_model.exposures.shape}, "
      f"{len(best_model.history['objective_function'])} recorded ELBOs")
# the winner exposes the full model surface:
best_model.compute_correlation()

# -- 2. MvNMF rank scan: K-padded bucketed programs ------------------------
mv = rank_scan_mvnmf(X.T, range(3, 7), n_restarts=8, config=config)
print("MvNMF rank scan (penalized KL, minimize):")
for k, result in sorted(mv.items()):
    print(f"  k={k}: best {result.best_loss:12.1f}")

# -- 2b. stability-based rank selection over the scan ----------------------
# best-loss always improves with rank; signature stability across the
# restarts (matched cosine vs the best restart) marks where extra
# components start fitting restart-specific noise.
from salamander_tpu import tl  # noqa: E402

table = tl.rank_selection_table(mv)
print(table.to_string())
print("suggested n_signatures:", tl.suggest_rank(mv, min_stability=0.8))

# -- 3. streaming minibatch fit: X host-resident ---------------------------
# (Bitwise-equal to the resident path at the same seed; at real scale the
# host matrix may exceed device memory - see benchmarks/streaming_demo.py
# for a cohort larger than the device.)
model = KLNMF(n_signatures=4)
model.fit_minibatch(
    AnnData(X.copy()), batch_size=64, n_steps=600, eval_freq=200,
    seed=0, init_kwargs={"seed": 1}, streaming=True,
)
print("streaming KLNMF objective trace:",
      [round(v, 1) for v in model.history["objective_function"]])

"""De novo consensus signature extraction on the PCAWG breast cohort.

The SigProfilerExtractor-style discovery workflow the reference cannot
express (its tutorial loops plain restarts on the host and has no
resampling, clustering or consensus machinery): count-bootstrap the cohort,
factorize every (rank, replicate) pair as a lane of ONE K-padded device
program, consensus-cluster the pooled signatures, pick the rank where the
clusters stay tight, and hand back a fitted consensus model — then annotate
the discovered signatures against the COSMIC catalog.

Run from the repo root: python examples/de_novo_extraction.py
(modest sizes so it completes in a few minutes on CPU or one GPU).
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import salamander_tpu as sal
from salamander_tpu import datasets

counts = datasets.load_pcawg_sbs()  # (192 samples, 96 SBS channels)

# -- discover: every (rank, replicate) pair is a lane of one program -------
# (long cohort-scale runs: pass checkpoint_dir="..." and a kill at any
# point resumes past completed chunks/refits on the next identical call)
result = sal.extract_signatures(
    counts, ranks=range(2, 7), n_bootstraps=10, seed=0,
    min_stability=0.8,
)
print("rank-selection table (best_loss = consensus KL on the real counts):")
print(result.table.round(4))
print(f"\nsuggested rank: {result.suggested_rank}")

# the table is pl.rank_selection-compatible:
#   sal.pl.rank_selection(result.table, min_stability=0.8)

# -- the winner is a fully fitted model -------------------------------------
model = result.model  # KLNMF, consensus signatures given, exposures refit
print(f"model: {type(model).__name__}, signatures {model.signatures.shape}, "
      f"exposures {model.exposures.shape}")

# -- close the loop: name the de novo signatures via COSMIC -----------------
cosmic = datasets.load_cosmic_sbs_catalog()
annotation = sal.tl.annotate_signatures(model, cosmic)
print("\nclosest COSMIC entries:")
print(annotation[["matched", "similarity"]])

# -- decompose: each de novo signature as a sparse COSMIC mixture -----------
# (the SigProfiler reporting convention: "Sig2 = 0.62*SBS3 + 0.38*SBS5")
decomposition = sal.tl.decompose_signatures(model, cosmic)
print("\nCOSMIC decomposition:")
print(decomposition.table.round(3).to_string(index=False))
print("reconstruction cosines:", decomposition.cosine.round(4).to_dict())

# per-cluster silhouettes of the chosen rank (the stability evidence):
silhouette = result.silhouettes[result.suggested_rank]
print("\ncluster silhouettes:", np.round(silhouette, 3))

# -- persist the whole discovery run (minutes of device time) ---------------
# sal.save_extraction(result, "extraction.npz")
# result = sal.load_extraction("extraction.npz")

# -- semi-supervised: discover NEW signatures on top of known ones ----------
# the best COSMIC match above can be pinned as given (frozen in every
# lane); ranks then count the signatures discovered on top of it
best_match = cosmic.loc[[annotation["matched"].iloc[0]]]
semi = sal.extract_signatures(
    counts, ranks=range(1, 5), n_bootstraps=10, seed=0,
    given_signatures=best_match, min_stability=0.8,
)
print(f"\nsemi-supervised: {semi.suggested_rank} new signatures on top of "
      f"{list(best_match.index)} (given rows ride every lane frozen)")

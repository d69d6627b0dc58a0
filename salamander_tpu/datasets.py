"""Dataset access: the PCAWG-breast catalogs and COSMIC references shipped
with the reference implementation, plus synthetic COSMIC-scale generators
for benchmarking (e.g. the 96 x 10k rank-scan catalog).

The CSV assets ship inside the wheel (``salamander_tpu/data``), so loaders
work from a plain ``pip install`` with no external mounts. Search order:
$SALAMANDER_DATA (override), the packaged data directory, then ./data next
to a source checkout. All loaders return (n_samples, n_features)-oriented
DataFrames ready for AnnData(...) (the files store features x samples).
``read_counts_csv`` reads the same files with numpy alone, for callers
that must not depend on pandas.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

_SEARCH_PATHS = [
    os.environ.get("SALAMANDER_DATA"),
    str(Path(__file__).resolve().parent / "data"),
    str(Path(__file__).resolve().parents[1] / "data"),
]

FILES = {
    "pcawg_sbs": "pcawg_breast_sbs.csv",
    "pcawg_indel": "pcawg_breast_indel.csv",
    "pcawg_sv": "pcawg_breast_sv.csv",
    "cosmic_sbs": "COSMIC_v3.3.1_SBS_GRCh38.csv",
    "cosmic_indel": "COSMIC_v3.4_ID_GRCh37.txt",
    "hrdetect_counts": "hrdetect_counts_training.csv",
    "hrdetect_labels": "hrdetect_labels_training.csv",
}


def _resolve(filename: str) -> Path:
    for base in _SEARCH_PATHS:
        if base is None:
            continue
        path = Path(base) / filename
        if path.exists():
            return path
    raise FileNotFoundError(
        f"Dataset file '{filename}' not found; searched {_SEARCH_PATHS}. "
        "Set SALAMANDER_DATA to a directory containing the catalog CSVs."
    )


def read_counts_csv(key_or_path) -> tuple[np.ndarray, list[str], list[str]]:
    """A shipped catalog (a FILES key) or any CSV of the same layout, read
    with numpy alone: (values as stored - features x samples - in float64,
    row labels, column labels)."""
    path = (_resolve(FILES[key_or_path]) if key_or_path in FILES
            else Path(key_or_path))
    with open(path, newline="") as handle:
        rows = list(csv.reader(handle))
    columns = rows[0][1:]
    index = [row[0] for row in rows[1:]]
    values = np.array([row[1:] for row in rows[1:]], dtype=np.float64)
    return values, index, columns


def _load_csv(key: str, samples_as_rows: bool = True) -> pd.DataFrame:
    import pandas as pd

    path = _resolve(FILES[key])
    # the shipped COSMIC .txt catalog is comma-separated despite its suffix
    df = pd.read_csv(path, index_col=0)
    return df.T if samples_as_rows else df


def load_pcawg_sbs() -> pd.DataFrame:
    """PCAWG breast-cancer SBS-96 counts (192 samples x 96 channels)."""
    return _load_csv("pcawg_sbs")


def load_pcawg_indel() -> pd.DataFrame:
    """PCAWG breast-cancer ID-83 counts (192 samples x 83 channels)."""
    return _load_csv("pcawg_indel")


def load_pcawg_sv() -> pd.DataFrame:
    """PCAWG breast-cancer SV-32 counts (192 samples x 32 channels)."""
    return _load_csv("pcawg_sv")


def load_cosmic_sbs_catalog() -> pd.DataFrame:
    """COSMIC v3.3.1 SBS signature catalog (signatures x 96 channels);
    the file stores channels x signatures."""
    return _load_csv("cosmic_sbs")


def load_cosmic_indel_catalog() -> pd.DataFrame:
    """COSMIC v3.4 indel signature catalog (signatures x 83 channels)."""
    return _load_csv("cosmic_indel")


def load_hrdetect() -> tuple[pd.DataFrame, pd.DataFrame]:
    """HRDetect training counts (311 samples x 96) and labels."""
    counts = _load_csv("hrdetect_counts")
    labels = _load_csv("hrdetect_labels", samples_as_rows=False)
    return counts, labels


def synthetic_catalog(
    n_features: int = 96,
    n_samples: int = 10_000,
    n_signatures: int = 8,
    mean_mutations: float = 5_000.0,
    seed: int = 0,
    return_truth: bool = False,
):
    """A COSMIC-scale synthetic Poisson count catalog for benchmarking.

    Signatures are Dirichlet(0.3) draws (sparse, signature-like); sample
    loads are gamma-distributed; counts ~ Poisson(W @ H). Shapes follow the
    kernel orientation X: (n_features, n_samples).
    """
    rng = np.random.default_rng(seed)
    signatures = rng.dirichlet(0.3 * np.ones(n_features), size=n_signatures).T
    weights = rng.dirichlet(np.ones(n_signatures), size=n_samples).T
    loads = rng.gamma(2.0, mean_mutations / 2.0, size=n_samples)
    expected = signatures @ (weights * loads)
    X = rng.poisson(expected).astype(np.float64)
    X = np.clip(X, np.finfo(np.float32).eps, None)
    if return_truth:
        return X, signatures, weights * loads
    return X

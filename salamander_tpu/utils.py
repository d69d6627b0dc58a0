"""Shared host-side helpers: argument validation, signature matching.

Covers the surface of /root/reference/src/salamander/utils.py
(type/shape/value/dict checkers :16-99, obsm/obsp resolution + light concat
:102-152, normalize_WH :155-158, catalog matching :161-192). Numeric matching
helpers operate on numpy/pandas (analysis layer stays host-side); the
device-side normalize lives in ops.klnmf. pandas is imported only where a
helper builds a frame, so the device core imports without it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Iterable

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist

if TYPE_CHECKING:
    import pandas as pd

EPSILON = float(np.finfo(np.float32).eps)


def type_checker(arg_name: str, arg: Any, allowed_types: type | Iterable[type]) -> None:
    """Raise TypeError unless type(arg) is one of 'allowed_types' (exact match)."""
    if isinstance(allowed_types, type):
        allowed_types = [allowed_types]
    allowed = list(allowed_types)
    if type(arg) not in allowed:
        raise TypeError(f"The type of '{arg_name}' has to be one of {allowed}.")


def shape_checker(
    arg_name: str, arg: np.ndarray | pd.DataFrame, allowed_shape: tuple[int, ...]
) -> None:
    """Raise ValueError unless the array/dataframe has exactly 'allowed_shape'."""
    allowed: list[type] = [np.ndarray]
    try:
        import pandas as pd

        allowed.append(pd.DataFrame)
    except ImportError:  # no pandas, so no DataFrame can reach here
        pass
    type_checker(arg_name, arg, allowed)
    if tuple(arg.shape) != tuple(allowed_shape):
        raise ValueError(f"The shape of '{arg_name}' has to be {allowed_shape}.")


def value_checker(arg_name: str, arg: Any, allowed_values: Iterable[Any]) -> None:
    """Raise ValueError unless 'arg' is one of 'allowed_values'."""
    if isinstance(allowed_values, type):
        allowed_values = [allowed_values]
    allowed = list(allowed_values)
    if arg not in allowed:
        raise ValueError(f"The value of '{arg_name}' has to be one of {allowed}.")


def dict_checker(
    dict_name: str, dictionary: dict[Any, Any], valid_keys: Iterable[Any]
) -> None:
    """Raise ValueError if 'dictionary' contains keys outside 'valid_keys'."""
    type_checker(dict_name, dictionary, dict)
    valid = list(valid_keys)
    for key in dictionary:
        if key not in valid:
            raise ValueError(f"'{dict_name}' includes keys outside of {valid}.")


def normalize_WH(W: np.ndarray, H: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rescale W's columns to sum to one, pushing the scale into H's rows.

    Host-side (numpy) twin of ops.klnmf.normalize_wh; mirrors
    reference utils.py:155-158.
    """
    scale = np.sum(W, axis=0)
    return W / scale, H * scale[:, None]


def compute_exposures_numpy(signature_scalings, sample_scalings,
                            signature_embeddings, sample_embeddings
                            ) -> np.ndarray:
    """Exposure matrix exp(sigma_k + tau_d + <l_k, u_d>), (samples, sigs).

    Host-side (numpy) twin of ops.corrnmf.compute_exposures (reference
    _utils_corrnmf.py:11-25), for the eager container-refresh paths: all
    inputs already live on the host there, and an eager device call would
    upload them and fetch a (D, K) result back for nothing.
    """
    logits = (
        np.asarray(signature_scalings, dtype=float)[:, None]
        + np.asarray(sample_scalings, dtype=float)[None, :]
        + np.asarray(signature_embeddings, dtype=float)
        @ np.asarray(sample_embeddings, dtype=float).T
    )
    return np.exp(logits).T


def _get_basis_obsm(adata, basis: str) -> np.ndarray:
    """Resolve adata.obsm[basis], falling back to the 'X_{basis}' convention."""
    if basis in adata.obsm:
        return adata.obsm[basis]
    if f"X_{basis}" in adata.obsm:
        return adata.obsm[f"X_{basis}"]
    raise KeyError(f"Could not find '{basis}' or 'X_{basis}' in .obsm")


def _get_basis_obsp(adata, basis: str) -> np.ndarray:
    """Resolve adata.obsp[basis], falling back to the 'X_{basis}' convention."""
    if basis in adata.obsp:
        return adata.obsp[basis]
    if f"X_{basis}" in adata.obsp:
        return adata.obsp[f"X_{basis}"]
    raise KeyError(f"Could not find '{basis}' or 'X_{basis}' in .obsp")


def _concat_light(adatas, obs_keys=None, obsm_keys=None):
    """Concatenate only the requested obs/obsm annotations of several
    AnnData/MuData objects into one small AnnData (no data copy).
    """
    from .containers import AnnData

    adatas = list(adatas)
    n_obs_total = sum(a.n_obs for a in adatas)
    combined = AnnData(np.zeros((n_obs_total, 1)))
    combined.obs_names = np.concatenate([np.asarray(a.obs_names) for a in adatas])

    for key in obs_keys or []:
        combined.obs[key] = np.concatenate([np.asarray(a.obs[key]) for a in adatas])
    for key in obsm_keys or []:
        combined.obsm[key] = np.concatenate(
            [_get_basis_obsm(a, key) for a in adatas]
        )
    return combined


def match_to_catalog(
    signatures: pd.DataFrame, catalog: pd.DataFrame, metric: str = "cosine"
) -> pd.DataFrame:
    """For every signature (row), pick the most similar catalog entry."""
    similarity = 1 - cdist(
        np.asarray(signatures, dtype=float), np.asarray(catalog, dtype=float),
        metric=metric,
    )
    best = [int(np.argmax(row)) for row in similarity]
    return catalog.iloc[best]


def match_signatures_pair(
    signatures1: pd.DataFrame, signatures2: pd.DataFrame, metric: str = "cosine"
) -> np.ndarray:
    """Optimal one-to-one assignment of signatures2's rows onto signatures1's.

    Returns the permutation of signatures2 minimizing the total pairwise
    distance (Hungarian algorithm), as in reference utils.py:173-192.
    """
    if signatures1.shape != signatures2.shape:
        raise ValueError("The signatures must be of the same shape.")
    pdist = cdist(
        np.asarray(signatures1, dtype=float),
        np.asarray(signatures2, dtype=float),
        metric=metric,
    )
    return linear_sum_assignment(pdist)[1]

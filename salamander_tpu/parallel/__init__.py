"""Scaling layer: device meshes, batched multi-start fits, rank scans.

The reference has no parallelism at all (SURVEY.md section 2.1); its
embarrassingly parallel axes - multi-start restarts, rank scans, and the
sample axis of every kernel - are serial Python loops. Here they are
first-class: restarts vmap into one device program and shard over the
'restarts' mesh axis (data-parallel analog), samples shard over the
'samples' axis (sequence-parallel analog) with XLA inserting the psum-family
collectives for the cross-sample reductions inside the W update and the
objectives.
"""

import importlib

from .compaction import (  # noqa: F401
    CompactingRunner,
    fit_klnmf_restarts_compacting,
)
from .corrnmf_scan import CorrScanResult, rank_scan_corrnmf  # noqa: F401
from .mesh import (  # noqa: F401
    hybrid_mesh_shape,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    restart_sharding,
    slice_groups,
)
from .multistart import MultiStartSummary, fit_best_of  # noqa: F401
from .restarts import (  # noqa: F401
    RestartResult,
    fit_klnmf_restarts,
    rank_scan,
    rank_scan_klnmf,
    rank_scan_mvnmf,
)

# bootstrap_stability needs pandas; it loads on first access so the device
# drivers above import with numpy, scipy and jax alone
_LAZY_ATTRS = {"BootstrapResult": "bootstrap", "bootstrap_stability": "bootstrap"}


def __getattr__(name):
    if name in _LAZY_ATTRS:
        module = importlib.import_module(f".{_LAZY_ATTRS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

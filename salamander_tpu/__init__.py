"""salamander_tpu: a JAX NMF framework for mutational-signature analysis.

A ground-up JAX rebuild of the capabilities of parklab/Salamander v0.4.2:
KLNMF, minimum-volume NMF, correlated NMF and multimodal correlated NMF over
annotated data containers, with initialization, signature matching,
dimensionality reduction and plotting - compute expressed as jitted XLA
programs that vmap over restarts and shard over device meshes.

The device core (ops, engine, initialization, the multi-start, compaction
and scan drivers in parallel) imports with numpy, scipy and jax alone; the
container, I/O and analysis layers need pandas and load on first use.
"""

import importlib

from . import (
    consts,
    device,
    engine,
    initialization,
    ops,
    parallel,
    profiling,
    utils,
)
from .parallel import fit_best_of

# public names of the pandas-dependent layers, loaded on first access
_LAZY_MODULES = ("assign", "containers", "datasets", "extraction", "io")
_LAZY_ATTRS = {
    "AssignmentResult": "assign",
    "BootstrapExposuresResult": "assign",
    "assign_exposures": "assign",
    "assign_signatures": "assign",
    "bootstrap_exposures": "assign",
    "AnnData": "containers",
    "MuData": "containers",
    "ExtractionResult": "extraction",
    "extract_signatures": "extraction",
    "load_extraction": "io",
    "load_model": "io",
    "save_extraction": "io",
    "save_model": "io",
    "bootstrap_stability": "parallel",
}


def __getattr__(name):
    if name in _LAZY_MODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY_ATTRS:
        module = importlib.import_module(f".{_LAZY_ATTRS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.5.0"

__all__ = [
    "__version__",
    "AnnData",
    "AssignmentResult",
    "MuData",
    "BootstrapExposuresResult",
    "assign_exposures",
    "assign_signatures",
    "bootstrap_exposures",
    "bootstrap_stability",
    "consts",
    "containers",
    "datasets",
    "device",
    "engine",
    "ExtractionResult",
    "extract_signatures",
    "fit_best_of",
    "initialization",
    "io",
    "load_extraction",
    "load_model",
    "ops",
    "parallel",
    "profiling",
    "save_extraction",
    "save_model",
    "utils",
]


try:  # plotting style applied on import, as in the reference facade
    from . import plot as pl  # noqa: F401

    pl.set_salamander_style()
    __all__.append("pl")
except ImportError:  # pragma: no cover - plotting lands later in the build
    pass

try:
    from . import tools as tl  # noqa: F401

    __all__.append("tl")
except ImportError:  # pragma: no cover
    pass

try:
    from . import models  # noqa: F401

    __all__.append("models")
except ImportError:  # pragma: no cover
    pass

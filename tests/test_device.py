"""Device-wide settings: memory budgets scaled to the card, the compile-cache
helper, the accelerator gates of the compacting drivers, the profiling
timer, and the import boundary of the device core (numpy, scipy and jax
only)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from salamander_tpu import device, profiling
from salamander_tpu.engine import FitConfig

REPO_ROOT = Path(__file__).resolve().parents[1]

# --- import boundary -------------------------------------------------------

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {"pandas", "sklearn", "matplotlib", "seaborn", "h5py"}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Blocker())
""")


@pytest.mark.parametrize("statement", [
    "import salamander_tpu",
    "import salamander_tpu.ops",
    "import salamander_tpu.engine",
    "import salamander_tpu.initialization",
    "import salamander_tpu.parallel.restarts",
    "import salamander_tpu.parallel.compaction",
    "import salamander_tpu.parallel.mesh",
    "from salamander_tpu.parallel import (fit_klnmf_restarts, "
    "rank_scan_corrnmf, rank_scan_klnmf, rank_scan_mvnmf)",
    "from salamander_tpu.datasets import read_counts_csv, synthetic_catalog",
    "from salamander_tpu.device import enable_compile_cache, memory_budget",
])
def test_core_imports_without_optional_packages(statement):
    """The device core imports with pandas, scikit-learn, matplotlib,
    seaborn and h5py all unavailable."""
    code = _BLOCKER + statement + "\nprint('imported')\n"
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(REPO_ROOT)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "imported"


def test_lazy_layers_still_resolve():
    """The pandas-backed layers stay reachable from the package namespace."""
    import salamander_tpu as sal

    assert sal.AnnData is sal.containers.AnnData
    assert callable(sal.assign_signatures)
    assert callable(sal.parallel.bootstrap_stability)
    with pytest.raises(AttributeError):
        sal.no_such_attribute  # noqa: B018


# --- compile cache ----------------------------------------------------------

@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_environment(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    used = device.enable_compile_cache()
    assert used == str(REPO_ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == used
    assert device.enable_compile_cache() == used  # same path every call


def test_compile_cache_has_no_default_when_installed(monkeypatch,
                                                     restore_cache_dir):
    """An installed package (no checkout around it) writes no cache into
    site-packages."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(device, "CACHE_DIR", None)
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


# --- default device and the GPU-only scripts' checks ------------------------

def test_default_device_follows_the_context():
    devices = jax.devices()
    assert device.default_device() == devices[0]
    with jax.default_device(devices[3]):
        assert device.default_device() == devices[3]
    with jax.default_device("cpu"):
        assert device.default_device() == jax.devices("cpu")[0]


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="^bench: needs an NVIDIA GPU"):
        device.require_gpu("bench")


# --- memory budget ----------------------------------------------------------

def _fake_devices(monkeypatch, stats):
    fake = SimpleNamespace(platform="gpu", device_kind="Fake GPU",
                           memory_stats=lambda: stats)
    monkeypatch.setattr(jax, "devices", lambda *a: [fake])


def test_memory_budget_scales_with_bytes_limit(monkeypatch):
    _fake_devices(monkeypatch, {"bytes_limit": 64 * 2**30})
    # 4x the reference device's memory -> 4x the budget
    assert device.memory_budget(4 * 2**30) == 16 * 2**30
    assert device.memory_budget(0) == 0


def test_memory_budget_keeps_cpu_constants():
    assert jax.devices()[0].platform == "cpu"
    assert device.memory_budget(4 * 2**30) == 4 * 2**30
    assert device.memory_budget(1) == 1


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 0}])
def test_memory_budget_raises_without_stats(monkeypatch, stats):
    _fake_devices(monkeypatch, stats)
    with pytest.raises(RuntimeError, match="bytes_limit"):
        device.memory_budget(4 * 2**30)


# --- accelerator gates ------------------------------------------------------

def test_compaction_gate_enables_runner_on_gpu(monkeypatch):
    from salamander_tpu.parallel import compaction

    conv = FitConfig(min_iterations=10, max_iterations=100,
                     conv_test_freq=10, tol=1e-6)
    assert compaction.resolve_compact(None, conv, None, 64, 8) is False
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert compaction.resolve_compact(None, conv, None, 64, 8) is True


def test_extraction_gate_uses_runner_on_gpu(monkeypatch):
    """extract_signatures(compact=None) routes its discovery fit through
    the compacting runner on a GPU backend (and keeps the monolithic
    engine on CPU)."""
    from salamander_tpu import AnnData, extract_signatures
    from salamander_tpu.datasets import synthetic_catalog
    from salamander_tpu.parallel import compaction

    built = []
    real = compaction._cached_extraction_compacting_runner

    def spy(*args, **kwargs):
        built.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(compaction, "_cached_extraction_compacting_runner",
                        spy)
    X = synthetic_catalog(12, 16, 2, mean_mutations=400.0, seed=0)
    kwargs = dict(ranks=[2], n_bootstraps=2, min_iterations=10,
                  max_iterations=40, conv_test_freq=10, tol=1e-5, seed=0)
    extract_signatures(AnnData(X.T.copy()), **kwargs)
    assert built == []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    extract_signatures(AnnData(X.T.copy()), **kwargs)
    assert len(built) == 1


# --- profiling --------------------------------------------------------------

def test_phase_blocks_on_what_it_produced(monkeypatch):
    waited = []
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda tree: waited.append(tree) or tree)
    timings = profiling.Timings()
    with profiling.phase(timings, "work") as produced:
        produced.append(np.ones(3))
    assert len(waited) == 1 and len(waited[0]) == 1
    assert timings.counts["work"] == 1 and timings.phases["work"] >= 0


def test_phase_lets_errors_surface():
    timings = profiling.Timings()
    with pytest.raises(ValueError, match="boom"):
        with profiling.phase(timings, "failing"):
            raise ValueError("boom")
    assert "failing" not in timings.phases

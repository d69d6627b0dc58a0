"""Device-wide settings shared by the drivers and the entry points.

- ``default_device`` is the device JAX puts uncommitted arrays on,
  honouring a ``jax.default_device(...)`` context, so drivers that stage
  data on the host place it where the caller asked.
- ``memory_budget`` scales the package's device-memory budgets (lane
  chunking, bootstrap residency, deferred fetches) to the memory of the
  device the fit runs on. Each budget is written as its size on a 16 GiB
  device; a card with four times the memory gets four times the budget.
- ``enable_compile_cache`` gives command-line entry points run from a
  checkout a persistent XLA compilation cache at a fixed path, so a second
  process with the same shapes skips compilation.
- ``require_gpu`` and ``card_line`` are the GPU-only scripts' refusal of
  any other device and their record of the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

__all__ = ["CACHE_DIR", "REFERENCE_DEVICE_BYTES", "card_line",
           "default_device", "enable_compile_cache", "memory_budget",
           "require_gpu"]

# Budgets in this package are written for a device of this size.
REFERENCE_DEVICE_BYTES = 16 * 2**30

# Fixed in-checkout cache path: the directory is part of the cache key, so
# it must not depend on a temporary name, a process id or the time. An
# installed package (no pyproject.toml beside it) gets no default: a cache
# does not belong in site-packages.
_ROOT = Path(__file__).resolve().parents[1]
CACHE_DIR = (_ROOT / ".jax_cache"
             if (_ROOT / "pyproject.toml").is_file() else None)


def default_device():
    """The device JAX places uncommitted arrays on: the one a
    ``jax.default_device(...)`` context names, else ``jax.devices()[0]``."""
    chosen = jax.config.jax_default_device
    if chosen is None:
        return jax.devices()[0]
    if isinstance(chosen, str):
        return jax.devices(chosen)[0]
    return chosen


def memory_budget(nbytes: int) -> int:
    """`nbytes` (a budget sized for a 16 GiB device) scaled to the memory
    JAX may use on the default device.

    CPU returns `nbytes` unchanged. An accelerator that reports no
    ``bytes_limit`` raises: a wrong guess would either waste the card or
    run it out of memory mid-fit.
    """
    device = default_device()
    if device.platform == "cpu":
        return int(nbytes)
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {device.device_kind!r} reports no "
            "memory_stats()['bytes_limit']; cannot size device-memory "
            "budgets"
        )
    return int(nbytes * limit / REFERENCE_DEVICE_BYTES)


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at ``<checkout>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` already names one (JAX reads that
    variable itself, and it is left alone). Returns the directory in use,
    or None for an installed package without the variable. Call before the
    first compilation."""
    from_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if from_env:
        return from_env
    if CACHE_DIR is None:
        return None
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def require_gpu(program: str):
    """JAX's default device, or SystemExit naming `program` when it is not
    a GPU. JAX falls back to the CPU by itself when its CUDA plugin fails,
    and a CPU run must never pass for a GPU one."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"{program}: needs an NVIDIA GPU, but JAX's default device is "
            f"{device.platform} ({device.device_kind})"
        )
    return device


def card_line() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them (a
    subprocess that does not go through JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()

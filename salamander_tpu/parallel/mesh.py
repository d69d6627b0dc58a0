"""Device-mesh construction and sharding helpers.

Axes:
  'restarts' - independent fits (multi-start / rank-scan fan-out); pure data
               parallelism, the only cross-device communication is the final
               argmin over losses.
  'samples'  - the D axis of X and H; the W-update numerator (aux @ H^T), the
               column sums and every objective reduce over D, so XLA inserts
               all-reduces over this axis (rides NVLink within a host).

Multi-host: init_distributed() brings up the jax.distributed runtime, and
make_hybrid_mesh() factors the global device set so the communication-free
restart axis is the ONLY axis crossing host boundaries (the network
between hosts), while the all-reducing sample axis stays inside one host
(NVLink).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RESTART_AXIS = "restarts"
SAMPLE_AXIS = "samples"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> None:
    """Initialize the multi-process JAX runtime (several hosts, or one
    process per GPU).

    Thin, idempotent wrapper around jax.distributed.initialize: under a
    cluster manager JAX detects (e.g. SLURM) the arguments auto-detect;
    otherwise pass coordinator_address='host:port', num_processes and
    process_id. After this, jax.devices() is the GLOBAL device set and
    make_mesh()/make_hybrid_mesh() build meshes spanning all hosts.

    The reference is strictly single-process (SURVEY.md section 5.8); this
    is the distributed runtime it lacks.
    """
    if jax.distributed.is_initialized():
        return  # already initialized - keep it
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def slice_groups(devices) -> list[list]:
    """Group devices by host (process_index): devices of one group share
    NVLink, groups talk over the network. One group in a single process."""
    groups: dict[int, list] = {}
    for device in devices:
        groups.setdefault(getattr(device, "process_index", 0), []).append(
            device
        )
    return [groups[index] for index in sorted(groups)]


def hybrid_mesh_shape(
    n_devices_per_slice: int,
    n_slices: int,
    sample_ways: int | None = None,
) -> tuple[tuple[int, int], tuple[int, int]]:
    """Factor a multi-host deployment into (per-host shape, across-host
    shape) for a (restarts, samples) mesh.

    The sample axis all-reduces every iteration, so it must never cross the
    network: its full extent lives inside one host. Restarts communicate
    only at the final argmin, so they take the whole across-host axis plus
    the leftover inside each host.
    Returns ((restarts_per_host, sample_ways), (n_hosts, 1)).
    """
    if sample_ways is None:
        _, sample_ways = _factor(n_devices_per_slice)
    if n_devices_per_slice % sample_ways:
        raise ValueError(
            f"{n_devices_per_slice} devices per host not divisible by "
            f"sample_ways={sample_ways}"
        )
    return (n_devices_per_slice // sample_ways, sample_ways), (n_slices, 1)


def make_hybrid_mesh(devices=None, sample_ways: int | None = None) -> Mesh:
    """Build a (restarts, samples) mesh over a (possibly multi-host) device
    set with host-aware axis placement.

    Single-host sets reduce to make_mesh. Multi-host sets are laid out so
    that consecutive sample-axis neighbors are always on one host (NVLink)
    and only the restart axis spans hosts - the layout
    jax.experimental.mesh_utils.create_hybrid_device_mesh produces for
    (per-host shape, across-host shape) as computed by hybrid_mesh_shape.
    """
    if devices is None:
        devices = jax.devices()
    groups = slice_groups(devices)
    if len(groups) == 1:
        return make_mesh(devices, sample_ways)
    per_host = len(groups[0])
    if any(len(group) != per_host for group in groups):
        raise ValueError("Hosts expose different device counts.")
    host_shape, across_shape = hybrid_mesh_shape(
        per_host, len(groups), sample_ways
    )
    from jax.experimental import mesh_utils

    grid = mesh_utils.create_hybrid_device_mesh(
        host_shape, across_shape, devices=devices,
        process_is_granule=True,
    )
    # hybrid grid is (hosts * restarts_per_host, samples)
    return Mesh(grid, (RESTART_AXIS, SAMPLE_AXIS))


def _factor(n_devices: int, max_sample_ways: int = 4) -> tuple[int, int]:
    """Split n_devices into (restart_ways, sample_ways): prefer a modest
    sample-sharding degree and put the rest on restarts."""
    for sample_ways in range(min(max_sample_ways, n_devices), 0, -1):
        if n_devices % sample_ways == 0:
            return n_devices // sample_ways, sample_ways
    return n_devices, 1


def make_mesh(devices=None, sample_ways: int | None = None) -> Mesh:
    """Build a (restarts, samples) mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if sample_ways is None:
        restart_ways, sample_ways = _factor(n)
    else:
        if n % sample_ways:
            raise ValueError(f"{n} devices not divisible by sample_ways={sample_ways}")
        restart_ways = n // sample_ways
    grid = np.asarray(devices).reshape(restart_ways, sample_ways)
    return Mesh(grid, (RESTART_AXIS, SAMPLE_AXIS))


def restart_sharding(mesh: Mesh):
    """Shardings for the batched KLNMF state under a (restarts, samples) mesh.

    W: (R, V, K) restart-sharded, replicated over samples.
    H: (R, K, D) restart- and sample-sharded.
    X: (V, D)    replicated over restarts, sample-sharded.
    """
    return {
        "W": NamedSharding(mesh, P(RESTART_AXIS, None, None)),
        "H": NamedSharding(mesh, P(RESTART_AXIS, None, SAMPLE_AXIS)),
        "X": NamedSharding(mesh, P(None, SAMPLE_AXIS)),
        "mask": NamedSharding(mesh, P(RESTART_AXIS, None)),
        "per_restart": NamedSharding(mesh, P(RESTART_AXIS)),
        "replicated": NamedSharding(mesh, P()),
    }

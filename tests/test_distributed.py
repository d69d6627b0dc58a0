"""Host-aware mesh factoring for multi-host deployments.

Several hosts are unavailable in CI; these tests pin the layout LOGIC: the
all-reducing sample axis must never cross a host boundary, and the restart
axis absorbs the across-host dimension. (The single-host path runs for
real on the virtual CPU mesh via test_sharding.py / the driver dryrun.)
"""

from types import SimpleNamespace

import jax
import pytest

from salamander_tpu.parallel import (
    hybrid_mesh_shape,
    make_hybrid_mesh,
    make_mesh,
    slice_groups,
)
from salamander_tpu.parallel.mesh import RESTART_AXIS, SAMPLE_AXIS


def test_hybrid_mesh_shape_places_samples_inside_slice():
    ici, dcn = hybrid_mesh_shape(n_devices_per_slice=8, n_slices=4)
    restarts_per_slice, sample_ways = ici
    assert restarts_per_slice * sample_ways == 8
    assert dcn == (4, 1)  # samples never span hosts
    # explicit sample_ways
    ici, dcn = hybrid_mesh_shape(8, 2, sample_ways=8)
    assert ici == (1, 8) and dcn == (2, 1)


def test_hybrid_mesh_shape_rejects_indivisible():
    with pytest.raises(ValueError, match="divisible"):
        hybrid_mesh_shape(8, 2, sample_ways=3)


def test_slice_groups_orders_by_slice_index():
    devices = [
        SimpleNamespace(id=i, process_index=i % 3) for i in range(12)
    ]
    groups = slice_groups(devices)
    assert len(groups) == 3
    assert all(len(group) == 4 for group in groups)
    assert all(d.process_index == 0 for d in groups[0])
    assert all(d.process_index == 2 for d in groups[2])


def test_slice_groups_single_group_without_slice_index():
    groups = slice_groups(jax.devices("cpu")[:4])
    assert len(groups) == 1 and len(groups[0]) == 4


def test_make_hybrid_mesh_single_slice_equals_make_mesh():
    devices = jax.devices("cpu")[:8]
    hybrid = make_hybrid_mesh(devices, sample_ways=2)
    plain = make_mesh(devices, sample_ways=2)
    assert hybrid.axis_names == plain.axis_names == (RESTART_AXIS, SAMPLE_AXIS)
    assert hybrid.devices.shape == plain.devices.shape == (4, 2)


def test_make_hybrid_mesh_rejects_ragged_slices():
    devices = [
        SimpleNamespace(id=i, process_index=0) for i in range(3)
    ] + [SimpleNamespace(id=9, process_index=1)]
    with pytest.raises(ValueError, match="different device counts"):
        make_hybrid_mesh(devices)


def test_init_distributed_is_importable_and_idempotent_guard():
    """Single-process environments: the wrapper must consult
    jax.distributed.is_initialized() before touching the runtime (calling it
    with no coordinator in CI would raise), so just pin the guard exists."""
    from salamander_tpu.parallel import init_distributed

    assert callable(init_distributed)
    assert not jax.distributed.is_initialized()


class _SliceDevice:
    """A real CPU device wearing a fake process_index (host) - the
    duck-typing slice_groups supports. Lets the multi-host branch of
    make_hybrid_mesh (mesh.py create_hybrid_device_mesh call) EXECUTE
    without several hosts."""

    def __init__(self, device, process_index):
        object.__setattr__(self, "_device", device)
        object.__setattr__(self, "process_index", process_index)

    def __getattr__(self, name):
        return getattr(self._device, name)

    def __repr__(self):
        return f"_SliceDevice({self._device!r}, host={self.process_index})"

    def __hash__(self):
        return hash((self._device, self.process_index))

    def __eq__(self, other):
        return (
            getattr(other, "_device", None) == self._device
            and getattr(other, "process_index", None) == self.process_index
        )


def test_make_hybrid_mesh_multislice_branch_executes():
    """Two fake hosts of 4 CPU devices drive the create_hybrid_device_mesh
    path for real: the produced (restarts, samples) grid must keep every
    sample-axis row INSIDE one host with only the restart axis crossing
    hosts."""
    devices = [
        _SliceDevice(d, i // 4) for i, d in enumerate(jax.devices("cpu")[:8])
    ]
    mesh = make_hybrid_mesh(devices)
    assert mesh.axis_names == (RESTART_AXIS, SAMPLE_AXIS)
    grid = mesh.devices
    assert grid.shape == (2, 4)
    for row in range(grid.shape[0]):
        hosts = {d.process_index for d in grid[row]}
        assert len(hosts) == 1, (
            f"sample axis of restart row {row} crosses hosts: {hosts}"
        )
    # all 8 devices used exactly once
    assert len({d.id for d in grid.ravel()}) == 8


def test_make_hybrid_mesh_multislice_restarts_span_ici_and_dcn():
    """With sample_ways=2, each host contributes 2 restart rows (leftover
    inside the host) and the across-host axis stacks the hosts: 4 restart
    rows total, each inside one host on the sample axis."""
    devices = [
        _SliceDevice(d, i // 4) for i, d in enumerate(jax.devices("cpu")[:8])
    ]
    mesh = make_hybrid_mesh(devices, sample_ways=2)
    grid = mesh.devices
    assert grid.shape == (4, 2)
    row_slices = []
    for row in range(4):
        hosts = {d.process_index for d in grid[row]}
        assert len(hosts) == 1
        row_slices.append(hosts.pop())
    assert sorted(row_slices) == [0, 0, 1, 1]

"""Batched device->host transfer: fetch a whole pytree in ONE round-trip.

Every device->host copy pays a fixed per-transfer latency on top of its
bytes. A fit result pytree has ~10 leaves (params, history buffer,
counters), so fetching it leaf by leaf pays that latency ~10 times.

fetch_pytree() pays it once: on non-CPU backends it bitcasts every leaf to
bytes on device, concatenates them into one uint8 buffer, fetches that
buffer once, and reinterprets the bytes on the host - bit-exact by
construction (no dtype conversion is involved; bools ride as uint8). On
the CPU backend (tests, host-pinned init loops) it falls back to plain
per-leaf conversion, which is free there.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _leaf_meta(leaf):
    dtype = np.dtype(leaf.dtype)
    return tuple(leaf.shape), dtype


@functools.lru_cache(maxsize=128)
def _packer(metas):
    """One compiled packer per leaf-structure signature."""

    def pack(leaves):
        parts = []
        for leaf in leaves:
            if leaf.dtype == jnp.bool_:
                leaf = leaf.astype(jnp.uint8)
            if leaf.dtype != jnp.uint8:
                leaf = jax.lax.bitcast_convert_type(leaf, jnp.uint8)
            parts.append(leaf.reshape(-1))
        return jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.uint8)

    del metas  # only used as the cache key
    return jax.jit(pack)


def _fetch_packed(leaves):
    """Pack + single-fetch + host unpack for a list of device arrays."""
    metas = tuple(_leaf_meta(leaf) for leaf in leaves)
    flat = np.asarray(_packer(metas)(leaves))  # ONE device->host transfer
    out = []
    offset = 0
    for shape, dtype in metas:
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        itemsize = 1 if dtype == np.bool_ else dtype.itemsize
        nbytes = count * itemsize
        chunk = flat[offset:offset + nbytes]
        offset += nbytes
        if dtype == np.bool_:
            arr = chunk.astype(np.bool_)
        else:
            arr = np.frombuffer(chunk.tobytes(), dtype=dtype)
        out.append(arr.reshape(shape))
    return out


# dtypes packed into the byte buffer; float64 and friends are fetched
# per leaf (a backend that emulates f64 need not hold it as IEEE bytes)
_PACKABLE = frozenset(
    np.dtype(name)
    for name in ("bool", "uint8", "int8", "uint16", "int16", "float16",
                 "uint32", "int32", "float32")
) | frozenset([np.dtype(jnp.bfloat16)])


def _on_accelerator(leaf) -> bool:
    """Whether a leaf is a jax.Array actually resident on a non-CPU device.

    Host numpy arrays and CPU-backed jax Arrays in MIXED pytrees must NOT
    enter the packer: jnp.asarray would upload them just to fetch them
    back - the exact transfer this module exists to avoid."""
    if not isinstance(leaf, jax.Array):
        return False
    return any(device.platform != "cpu" for device in leaf.devices())


def fetch_pytree(tree):
    """Fetch a pytree of device arrays to host numpy arrays, using one
    device->host transfer for the accelerator-resident leaves (bit-exact;
    see module docstring). Leaves already on the host (numpy arrays,
    CPU-backed jax Arrays) convert directly with np.asarray; accelerator
    leaves whose dtype cannot be safely bitcast on device (e.g. emulated
    float64) fall back to per-leaf fetches. Returns a pytree of np.ndarray
    with the same structure."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if not leaves:
        return tree
    host = [None] * len(leaves)
    accelerator = []
    for i, leaf in enumerate(leaves):
        if _on_accelerator(leaf):
            accelerator.append(i)
        else:
            host[i] = np.asarray(leaf)
    packable = [
        i for i in accelerator if np.dtype(leaves[i].dtype) in _PACKABLE
    ]
    if packable:
        packed = _fetch_packed([leaves[i] for i in packable])
        for i, arr in zip(packable, packed):
            host[i] = arr
    for i in accelerator:
        if host[i] is None:
            host[i] = np.asarray(leaves[i])
    return jax.tree_util.tree_unflatten(treedef, host)

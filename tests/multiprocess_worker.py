"""Worker for the real multi-process jax.distributed test.

Launched (twice) by tests/test_multiprocess.py. Each process brings up the
distributed runtime via salamander_tpu.parallel.init_distributed, exposes two
virtual CPU devices (4 global), builds a (restarts, samples) mesh spanning
both processes, and runs a batched multi-start KLNMF fit whose restart axis
crosses the process boundary. Process 0 writes the gathered losses and the
best-restart signatures to an .npz for the host test to compare against a
single-process fit.

This is the multi-process rendezvous the reference never has (it is strictly
single-process, SURVEY.md section 5.8); across GPU hosts the same code path
runs with one process per host (or per card). This worker stays on the CPU.
"""

import os
import sys

process_id = int(sys.argv[1])
num_processes = int(sys.argv[2])
port = int(sys.argv[3])
out_path = sys.argv[4]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

# the rendezvous test runs on virtual CPU devices, never on an accelerator
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from salamander_tpu.parallel import init_distributed, make_mesh  # noqa: E402

init_distributed(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=num_processes,
    process_id=process_id,
)

assert jax.process_count() == num_processes, jax.process_count()
assert len(jax.devices()) == 2 * num_processes, jax.devices()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from salamander_tpu.engine import FitConfig  # noqa: E402
from salamander_tpu.initialization.methods import random_init_batch  # noqa: E402
from salamander_tpu.parallel.mesh import restart_sharding  # noqa: E402
from salamander_tpu.parallel.restarts import build_klnmf_restart_runner  # noqa: E402

N_FEATURES, N_SAMPLES, RANK, N_RESTARTS, SEED = 12, 16, 3, 4, 7

# identical deterministic inputs on every process
rng = np.random.default_rng(123)
X_host = rng.poisson(5.0, size=(N_FEATURES, N_SAMPLES)).astype(np.float32)
X_host[X_host == 0] = 1.0

key = jax.random.PRNGKey(SEED)
W0, H0 = random_init_batch(
    key, jnp.asarray(X_host), RANK, N_RESTARTS, jnp.float32
)
W0_host, H0_host = np.asarray(W0), np.asarray(H0)

# restart axis (2-way) spans the two processes; sample axis stays local
mesh = make_mesh(sample_ways=2)
assert mesh.devices.shape == (2, 2)
shardings = restart_sharding(mesh)


def put(host_array, sharding):
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx]
    )


params0 = {
    "W": put(W0_host, shardings["W"]),
    "H": put(H0_host, shardings["H"]),
}
data = {"X": put(X_host, shardings["X"])}

config = FitConfig(min_iterations=40, max_iterations=40, conv_test_freq=10)
runner = build_klnmf_restart_runner(config, mesh=mesh)
params, losses, n_iterations = runner(params0, data)

# gather the cross-process shards so every process sees the full result
losses_full = multihost_utils.process_allgather(losses, tiled=True)
W_full = multihost_utils.process_allgather(params["W"], tiled=True)

if process_id == 0:
    best = int(np.argmin(losses_full))
    np.savez(
        out_path,
        losses=np.asarray(losses_full),
        best_W=np.asarray(W_full[best]),
        n_processes=jax.process_count(),
        n_devices=len(jax.devices()),
    )

multihost_utils.sync_global_devices("salamander-mp-test-done")
jax.distributed.shutdown()
print(f"worker {process_id}: OK", flush=True)

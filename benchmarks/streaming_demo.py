"""Beyond-memory streaming demo: fit a cohort whose count matrix cannot fit
in the device's memory via the host-streaming minibatch path.

Cohort: D samples x V = 96 SBS features, synthetic Poisson counts from a
k=5 planted factorization, stored host-side as uint16. By default D is
chosen so that the matrix as float32 is 1.1x the device's memory limit
(`memory_stats()["bytes_limit"]`) - the resident paths (full-batch fit AND
resident fit_minibatch) are then impossible on this device; the reference
loads all of X up front
(/root/reference/src/salamander/models/signature_nmf.py:269-281) and is
equally impossible. The streaming path keeps only the O(D) per-sample
parameters on device (CorrNMF at m=2) and uploads each minibatch on the
fly, double-buffered against the device compute.

Usage: python benchmarks/streaming_demo.py [n_samples] [n_steps]
Defaults: 1.1x the device's memory as f32, 30 timed steps (batch 16384).
The host needs about 0.55x the device's memory for the uint16 counts.
Prints a small JSON report to stdout; progress to stderr.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

N_SAMPLES = int(sys.argv[1]) if len(sys.argv) > 1 else None
N_STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 30
V, K, M = 96, 5, 2
BATCH = 16384


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def synthesize(n_samples: int) -> np.ndarray:
    """Planted k=5 factorization, Poisson counts, uint16 host storage,
    drawn in row blocks to bound peak memory."""
    rng = np.random.default_rng(0)
    W = rng.dirichlet(np.ones(V), size=K)          # (K, V)
    X = np.empty((n_samples, V), np.uint16)
    block = 4_000_000
    for start in range(0, n_samples, block):
        stop = min(start + block, n_samples)
        exposures = rng.gamma(2.0, 120.0, size=(stop - start, K))
        lam = exposures @ W
        X[start:stop] = np.minimum(
            rng.poisson(lam), np.iinfo(np.uint16).max
        ).astype(np.uint16)
        log(f"synthesize: {stop}/{n_samples}")
    return X


def main():
    global N_SAMPLES
    import jax

    from salamander_tpu.device import enable_compile_cache

    enable_compile_cache()
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    if N_SAMPLES is None:
        if not limit:
            raise SystemExit("streaming_demo: the device reports no memory "
                             "limit; pass n_samples")
        N_SAMPLES = int(1.1 * limit / (4 * V))
    t0 = time.perf_counter()
    X = synthesize(N_SAMPLES)
    t_synth = time.perf_counter() - t0
    x_f32_gb = X.size * 4 / 1024**3
    log(f"X: {X.shape} uint16, host {X.nbytes / 1024**3:.1f} GB; as f32 on "
        f"device it would be {x_f32_gb:.1f} GB (device limit: "
        f"{limit / 1024**3 if limit else 'not reported'} GB)")

    from salamander_tpu.ops import svi
    from salamander_tpu.ops.corrnmf import compute_exposures  # noqa: F401

    # Device-side per-sample state, initialized directly with jax.random on
    # device (a host init loop over every sample's Dirichlet draws would
    # take minutes and GBs for arrays the fit immediately re-estimates).
    dtype = np.float32
    key = jax.random.PRNGKey(0)
    k_sig, k_se, k_ue = jax.random.split(key, 3)
    import jax.numpy as jnp

    draws = jax.random.exponential(k_sig, (K, V), dtype)
    params = {
        "signatures": draws / jnp.sum(draws, axis=1, keepdims=True),
        "signature_scalings": jnp.zeros((K,), dtype),
        "sample_scalings": jnp.zeros((N_SAMPLES,), dtype),
        "signature_embeddings": jax.random.normal(k_se, (K, M), dtype),
        "sample_embeddings": jax.random.normal(k_ue, (N_SAMPLES, M), dtype),
        "variance": jnp.ones((), dtype),
    }
    jax.block_until_ready(params["sample_embeddings"])
    t_init = time.perf_counter() - t0 - t_synth
    log(f"device init done ({t_init:.1f}s)")

    config = svi.SVIConfig(batch_size=BATCH, forgetting=0.7, delay=20.0)
    batch_step = svi.make_svi_batch_step(n_samples=N_SAMPLES, config=config)
    state0 = svi.svi_init(params, streaming=True)
    eps32 = np.finfo(np.float32).eps

    def get_batch(indices):
        return np.asarray(X[indices], dtype).clip(eps32)

    # warmup (compile) on a couple of steps
    t0w = time.perf_counter()
    state, _ = svi.run_svi_streaming(
        batch_step, state0, get_batch, N_SAMPLES, BATCH,
        jax.random.PRNGKey(1), 2,
    )
    t_compile = time.perf_counter() - t0w
    log(f"warmup 2 steps (incl. compile) {t_compile:.1f}s")

    t0t = time.perf_counter()
    state, _ = svi.run_svi_streaming(
        batch_step, state, get_batch, N_SAMPLES, BATCH,
        jax.random.PRNGKey(2), N_STEPS,
    )
    elapsed = time.perf_counter() - t0t
    steps_per_sec = N_STEPS / elapsed
    samples_per_sec = steps_per_sec * BATCH
    log(f"{N_STEPS} steps in {elapsed:.1f}s -> {steps_per_sec:.2f} steps/s, "
        f"{samples_per_sec:,.0f} samples/s (batch {BATCH})")

    # sanity: the model is actually learning. A FULL streamed ELBO pass
    # uploads the whole cohort, so the diagnostic is the exact streamed
    # Poisson log-likelihood of a fixed sample prefix
    # (an unbiased per-sample quality probe) before vs after the steps.
    probe_n = min(262_144, N_SAMPLES)
    probe = svi.make_streamed_objective(
        svi.corrnmf_elbo_stream_chunk,
        lambda params: jnp.zeros((), jnp.float32),  # llh only, no penalties
        get_batch, probe_n, chunk_size=probe_n,
    )
    t0e = time.perf_counter()
    llh_before = float(probe(dict(state0.params)))
    llh_after = float(probe(dict(state.params)))
    t_eval = time.perf_counter() - t0e
    log(f"probe llh/sample before {llh_before / probe_n:.4f} -> after "
        f"{llh_after / probe_n:.4f} ({t_eval:.1f}s for both passes)")
    assert np.isfinite(llh_after)

    print(json.dumps({
        "metric": "corrnmf_streaming_beyond_hbm",
        "n_samples": N_SAMPLES,
        "x_f32_gb": round(x_f32_gb, 1),
        "batch": BATCH,
        "steps_per_sec": round(steps_per_sec, 3),
        "samples_per_sec": round(samples_per_sec, 1),
        "compile_s": round(t_compile, 1),
        "probe_llh_per_sample_before": round(llh_before / probe_n, 4),
        "probe_llh_per_sample_after": round(llh_after / probe_n, 4),
    }))


if __name__ == "__main__":
    main()

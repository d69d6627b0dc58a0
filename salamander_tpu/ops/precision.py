"""Matmul precision policy for the device compute path.

Multiplicative updates iterate ``aux = X / (W @ H)`` thousands of times, and
convergence decisions compare objectives at ~1e-6 relative, so the f32
matmul precision is not a benign speed knob: a reduced-precision pass
shifts MU fixed points and the stop a decision makes. The policy is
measured, not left to the backend default.

Measured on one NVIDIA H100 80GB HBM3, power limit 400 W, JAX 0.9.0
(scripts/precision_check.py; PCAWG breast SBS, k=5; the CPU row from a
child process with JAX_PLATFORMS=cpu on the same machine). "gap" is each
lane's relative Frobenius error of (W, H) after 200 fixed MU steps from
identical starts against numpy float64, 16 lanes for each of 5 seeds:
the median lane, and the per-seed median over lanes of the lane's gap
over the CPU lane's gap (chip_smoke.gap_ratio); "over" counts assignment
samples (PCAWG x COSMIC v3.3.1, rel_tol 0.02, of 192) whose sparse KL
exceeds its budget with the setting applied to assignment's updates too;
the window is 100 restarts x 2,000 fixed iterations, aggregate MU it/s.

| setting          | fit KL   | n_it | best-of-100 | over | gap     | gap ratio  | it/s      |
|------------------|----------|------|-------------|------|---------|------------|-----------|
| DEFAULT          | 20428.94 | 4680 | 20416.10    | 0    | 2.44e-4 | 777-1080   | 4,008,551 |
| HIGH             | 20428.94 | 4680 | 20415.49    | 0    | 4.35e-5 | 121-214    | 2,584,143 |
| TF32_TF32_F32_X3 | 20428.82 | 4710 | 20415.92    | 0    | 3.38e-7 | 0.916-1.34 | 3,689,873 |
| HIGHEST          | 20428.79 | 4720 | 20415.49    | 0    | 3.30e-7 | 0.942-1.53 | 2,598,164 |
| CPU f32          | 20428.89 | 4680 | 20415.89    | 0    | 2.91e-7 | 1          | -         |

("fit KL"/"n_it": the single fit.)

Every setting passes the coarse fit criteria (stop within 40 iterations of
the CPU's, best-of-100 within 3e-5, no sample over budget); the
fixed-step gap separates them. DEFAULT (TF32) and HIGH sit about three and
two orders of magnitude off float32, and HIGH is no faster than HIGHEST
here. HIGHEST is full f32 (its lanes stray from float64 as far as the
CPU's do), so it is the update tier. TF32_TF32_F32_X3 is as accurate and
1.42x faster on the H100, but the CPU backend rejects algorithm presets,
so using it needs a per-backend policy; that stays an open question
(PERF.md).

Hence the policy, in two named tiers:

- ``MATMUL_PRECISION`` (= HIGHEST, via :func:`mm`): the bulk
  multiplicative update path.
- ``OBJECTIVE_PRECISION`` (= HIGHEST, via :func:`omm`): objectives,
  convergence tests, line-search/acceptance comparisons, Newton solves
  and Gram matrices feeding Cholesky. These make DECISIONS (stop/accept/
  direction) and stay at full f32 whatever the update tier becomes.

CPU ignores precision entirely, which is why golden-fixture tests could
not catch a reduced-precision regression; tests/test_precision.py walks the
traced jaxprs instead and fails on any dot off the policy.

The policy is a CONSTANT, not a runtime knob: JAX's trace caches key on
function identity + shapes, so a precision flipped after any tracing
silently would not take effect (a re-trace of ``mm`` under a mutated
module global returns the first trace's precision). A measurement sets it
before anything traces, in a fresh process (scripts/precision_check.py).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["MATMUL_PRECISION", "OBJECTIVE_PRECISION", "mm", "omm"]

MATMUL_PRECISION = lax.Precision.HIGHEST
OBJECTIVE_PRECISION = lax.Precision.HIGHEST


def mm(a, b):
    """Matmul at the bulk-update precision (see module doc)."""
    return jnp.matmul(a, b, precision=MATMUL_PRECISION)


def omm(a, b):
    """Matmul at decision precision (full f32): objectives, convergence
    tests, acceptance rules, solver systems."""
    return jnp.matmul(a, b, precision=OBJECTIVE_PRECISION)

"""Device-side numeric kernels: pure, jittable, vmappable JAX functions.

Layer L0 of the framework. Each module mirrors the numerics of one reference
kernel family (see docstrings for file:line citations) but is written
for the accelerator: masked vectorized reductions instead of scalar loops, broadcasts
instead of in-place mutation, and shapes/static arguments chosen so that
`jax.jit` / `jax.vmap` / sharded `pjit` all compose.
"""

from . import ardnmf, corrnmf, klnmf, mvnmf, svi  # noqa: F401
from .klnmf import EPSILON  # noqa: F401

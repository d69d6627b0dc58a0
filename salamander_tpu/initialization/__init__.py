"""Model-parameter initialization (layer L1).

Host-side numpy implementations reproduce the reference's exact random draws
(global np.random seeding) so golden fixtures match; a jax.random-based batch
initializer serves the multi-start device path (parallel layer).
"""

from .initialize import (  # noqa: F401
    EPSILON,
    GIVEN_PARAMETERS_CORRNMF,
    GIVEN_PARAMETERS_STANDARD_NMF,
    initialize_corrnmf,
    initialize_mat,
    initialize_mmcorrnmf,
    initialize_standard_nmf,
)
from .methods import INIT_METHODS, random_init_batch  # noqa: F401

"""Hot linear-algebra ops of the GP layer (plain jax.numpy / lax).

The reference leans on cuBLAS/MAGMA through torch for its GP linear algebra
(SURVEY.md §2.2); here every hot op is one function in `ops.linalg`, so the
GP math in `gppvae_tpu.gp` names its hot spots in one place.
"""

from gppvae_tpu.ops.linalg import (
    factor_prep,
    gram,
    matmul_tn,
    sqnorm,
    woodbury_nll_core,
)

__all__ = [
    "factor_prep",
    "gram",
    "matmul_tn",
    "sqnorm",
    "woodbury_nll_core",
]

"""Low-rank Gaussian Process prior over the VAE latent matrix.

The math layer of the framework (reference counterpart: pysrc/faceplace/gp.py,
SURVEY.md §2.1 / §3.3). Everything here is pure, jit-able jax.numpy on
device-resident matrices; the hot GEMM/reduction inner ops are routed through
`gppvae_tpu.ops`, which names them in one place.

Model: the N×L latent matrix Z has iid columns z_l ~ N(0, K) with

    K = sum_r v_r · V_r V_rᵀ + v_n · I_N            (never materialized)

where each V_r is an N×R_r feature-row matrix (rows v_n = x_{d(n)} ⊗ w_{q(n)}
for the object×view product kernel) and (v_r, v_n) are positive variance
components. All solves/log-dets go through the Woodbury identity and the
matrix determinant lemma on the small R×R core B = I + Uᵀ U / v_n,
U = [√v_1·V_1 | … | √v_k·V_k].
"""

from gppvae_tpu.gp.woodbury import (
    GPFactors,
    MIN_V_NOISE,
    factorize,
    gp_nll,
    gp_nll_from_features,
    kinv_z_core,
    extend_posterior_core,
    posterior_core,
    PosteriorCore,
    predict_cov_from_core,
    predict_from_core,
    predict_latents,
    scaled_features,
    variances_from_log,
)
from gppvae_tpu.gp.features import (
    build_effect_rows,
    build_V,
    fourier_view_features,
    kron_rows,
    make_rff_map,
    make_x_map,
    normalize_rows,
    polynomial_view_features,
)
from gppvae_tpu.gp.nystrom import (
    compress_rank,
    nystrom_features,
    pivoted_cholesky_landmarks,
)
from gppvae_tpu.gp.taylor import (
    surrogate_batch_term,
    taylor_expand,
    TaylorCoefficients,
)
from gppvae_tpu.gp import dense

__all__ = [
    "GPFactors",
    "MIN_V_NOISE",
    "scaled_features",
    "variances_from_log",
    "factorize",
    "gp_nll",
    "gp_nll_from_features",
    "kinv_z_core",
    "extend_posterior_core",
    "posterior_core",
    "PosteriorCore",
    "predict_cov_from_core",
    "predict_from_core",
    "predict_latents",
    "build_effect_rows",
    "build_V",
    "fourier_view_features",
    "kron_rows",
    "make_rff_map",
    "make_x_map",
    "normalize_rows",
    "polynomial_view_features",
    "surrogate_batch_term",
    "taylor_expand",
    "TaylorCoefficients",
    "compress_rank",
    "nystrom_features",
    "pivoted_cholesky_landmarks",
    "dense",
]

"""Woodbury / matrix-determinant-lemma path for the low-rank GP prior.

This is the rebuild of the reference's GP module
(pysrc/faceplace/gp.py — factor prep ("U_UBi_Shb"-style), `nll`, predictive
posterior; SURVEY.md §3.3). The covariance

    K = Σ_r v_r · V_r V_rᵀ + v_n · I_N

is never materialized. With U = [√v_1·V_1 | … | √v_k·V_k] (N×R):

    K        = U Uᵀ + v_n I
    K⁻¹      = v_n⁻¹ I − v_n⁻² U B⁻¹ Uᵀ,     B = I_R + Uᵀ U / v_n
    log|K|   = N·log v_n + log|B|             (matrix determinant lemma)
    tr(Zᵀ K⁻¹ Z) = (‖Z‖_F² − ‖L_B⁻¹ Uᵀ Z‖_F² / v_n) / v_n
    K⁻¹ Z    = (Z − U·(B⁻¹ Uᵀ Z)/v_n) / v_n
    K(*,·) K⁻¹ Z = U* · (B⁻¹ Uᵀ Z) / v_n      (GP-predictive latent means)

Cost: one N×R→R×R Gram, one N×L→R×L GEMM, one R×R Cholesky, fused
reductions. O(N·R²+N·R·L) — the big GEMMs are routed through
`gppvae_tpu.ops`; the tiny R×R Cholesky stays on `jax.lax.linalg`.

Everything is shape-static and jit-safe. dtype follows the inputs (tests run
float64 on CPU; training runs float32).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from gppvae_tpu import ops

_LOG2PI = math.log(2.0 * math.pi)

# floor added to exp(log_vn) by variances_from_log: keeps B = I + G/v_n
# factorizable even if the noise variance collapses during joint training
MIN_V_NOISE = 1e-6


def variances_from_log(log_vs, log_vn, min_v_noise: float = MIN_V_NOISE):
    """(v_sig, v_noise) from the trainers' log-parametrization, floored."""
    return jnp.exp(log_vs), jnp.exp(log_vn) + min_v_noise


class GPFactors(NamedTuple):
    """Woodbury factors of K = U Uᵀ + v_n I.

    Attributes:
      U:       (N, R) scaled feature rows [√v_r · V_r]_r concatenated.
      G:       (R, R) Gram Uᵀ U.
      Lb:      (R, R) lower Cholesky factor of B = I + Uᵀ U / v_n.
      v_noise: () positive noise variance v_n.
      logdet:  () log|K| = N log v_n + 2·Σ log diag(Lb).
    """

    U: jax.Array
    G: jax.Array
    Lb: jax.Array
    v_noise: jax.Array
    logdet: jax.Array


def scaled_features(
    Vs: Sequence[jax.Array], v_sigs: Sequence[jax.Array]
) -> jax.Array:
    """U = [√v_1·V_1 | … | √v_k·V_k] — the scaled feature concatenation
    every K-touching computation shares (NLL, predictive, prior sampling)."""
    parts = [jnp.sqrt(v) * V for V, v in zip(Vs, v_sigs, strict=True)]
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)


_scaled_features = scaled_features


def factorize(
    Vs: Sequence[jax.Array] | jax.Array,
    v_sigs: Sequence[jax.Array] | jax.Array,
    v_noise: jax.Array,
) -> GPFactors:
    """Prepare Woodbury factors for K = Σ_r v_r V_r V_rᵀ + v_n I."""
    if isinstance(Vs, jax.Array) or not isinstance(Vs, (list, tuple)):
        Vs = [Vs]
    if isinstance(v_sigs, jax.Array) or not isinstance(v_sigs, (list, tuple)):
        v_sigs = [v_sigs]
    U = _scaled_features(Vs, [jnp.asarray(v) for v in v_sigs])
    N, R = U.shape
    G = ops.gram(U)  # (R, R) = Uᵀ U
    B = jnp.eye(R, dtype=U.dtype) + G / v_noise
    Lb = jax.lax.linalg.cholesky(B)
    logdet = N * jnp.log(v_noise) + 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lb)))
    return GPFactors(U=U, G=G, Lb=Lb, v_noise=jnp.asarray(v_noise), logdet=logdet)


def kinv_z_core(factors: GPFactors, Z: jax.Array) -> jax.Array:
    """M = B⁻¹ Uᵀ Z / v_n, the (R, L) core of every K⁻¹-apply.

    K⁻¹ Z = (Z − U M) / v_n and the predictive mean for rows with scaled
    features U* is U* M.
    """
    UtZ = ops.matmul_tn(factors.U, Z)  # (R, L)
    W = jax.scipy.linalg.solve_triangular(factors.Lb, UtZ, lower=True)
    M = jax.scipy.linalg.solve_triangular(factors.Lb.T, W, lower=False)
    return M / factors.v_noise


def gp_nll(
    Z: jax.Array,
    factors: GPFactors,
    *,
    include_const: bool = True,
) -> jax.Array:
    """Exact negative log-likelihood of Z (iid columns) under N(0, K).

    nll = ½ [ L·log|K| + tr(Zᵀ K⁻¹ Z) + N·L·log 2π ].
    """
    N, L = Z.shape
    UtZ = ops.matmul_tn(factors.U, Z)  # (R, L)
    W = jax.scipy.linalg.solve_triangular(factors.Lb, UtZ, lower=True)
    znorm2, wnorm2 = ops.sqnorm(Z), ops.sqnorm(W)
    quad = (znorm2 - wnorm2 / factors.v_noise) / factors.v_noise
    nll = 0.5 * (L * factors.logdet + quad)
    if include_const:
        nll = nll + 0.5 * N * L * _LOG2PI
    return nll


def gp_nll_from_features(
    Z: jax.Array,
    Vs: Sequence[jax.Array] | jax.Array,
    v_sigs: Sequence[jax.Array] | jax.Array,
    v_noise: jax.Array,
    *,
    include_const: bool = True,
    num_rows: int | None = None,
) -> jax.Array:
    """One-shot NLL as a differentiable function of (Z, Vs, variances).

    This is the function the first-order Taylor surrogate differentiates
    (SURVEY.md §3.2 Phase B); grads w.r.t. every argument flow by autodiff —
    no hand-derived coefficient formulas to get subtly wrong.

    Uses `ops.factor_prep` (Gram + projection + ‖Z‖²) and
    `ops.woodbury_nll_core` rather than factorize()+gp_nll().

    num_rows: the TRUE dataset size when Z/Vs carry trailing all-zero
    padding rows (the mesh trainers pad N to a multiple of the data-axis
    size; zero rows contribute nothing to Gram/projection/‖Z‖², so only the
    scalar N·log v_n and N·L·log 2π counts need the real N). Defaults to
    Z.shape[0] (no padding).
    """
    if isinstance(Vs, jax.Array) or not isinstance(Vs, (list, tuple)):
        Vs = [Vs]
    if isinstance(v_sigs, jax.Array) or not isinstance(v_sigs, (list, tuple)):
        v_sigs = [v_sigs]
    U = _scaled_features(Vs, [jnp.asarray(v) for v in v_sigs])
    _, L = Z.shape
    N = num_rows if num_rows is not None else Z.shape[0]
    G, UtZ, znorm2 = ops.factor_prep(U, Z)
    nll = ops.woodbury_nll_core(G, UtZ, znorm2, jnp.asarray(v_noise), N, L)
    if not include_const:
        nll = nll - 0.5 * N * L * _LOG2PI
    return nll


class PosteriorCore(NamedTuple):
    """N-independent core of the trained GP posterior (the serving state).

    Everything needed to predict mean/variance for NEW (object, view) rows
    after the N training rows are folded in — all R-sized, so a server can
    hold it per model and answer requests without touching Z (N×L) or U
    (N×R) again:

      M:       (R, L) = B⁻¹ Uᵀ Z / v_n — predictive mean is U* M.
      G:       (R, R) Gram Uᵀ U (variance term).
      Lb:      (R, R) lower Cholesky of B = I + G/v_n.
      v_noise: () noise variance.
    """

    M: jax.Array
    G: jax.Array
    Lb: jax.Array
    v_noise: jax.Array


def posterior_core(factors: GPFactors, Z: jax.Array) -> PosteriorCore:
    """Fold the training latents into the R-sized predictive core."""
    return PosteriorCore(
        M=kinv_z_core(factors, Z), G=factors.G, Lb=factors.Lb,
        v_noise=factors.v_noise,
    )


def extend_posterior_core(
    core: PosteriorCore,
    Vs_new: Sequence[jax.Array] | jax.Array,
    v_sigs: Sequence[jax.Array] | jax.Array,
    Z_new: jax.Array,
) -> PosteriorCore:
    """Fold n NEW observed rows into an existing posterior core — streaming
    conditioning in O(n·R² + R³), without the original training set.

    The core is algebraically sufficient: M = B⁻¹UᵀZ/v_n ⇒ B·M = UᵀZ/v_n,
    so with the new rows' scaled features U₊ (n, R) and latents Z₊ (n, L):

        G'  = G + U₊ᵀU₊
        B'  = I + G'/v_n
        M'  = B'⁻¹ (B·M + U₊ᵀZ₊/v_n)   = B'⁻¹ [U;U₊]ᵀ[Z;Z₊] / v_n

    — identical (up to fp reassociation) to refactorizing over the union
    of all rows (tested exactly in f64). The reference has no analog: its
    OOS path re-encodes and re-factorizes the whole dataset per evaluation
    (SURVEY.md §3.4); here a deployed server can absorb fresh observations
    of grid cells in an R-sized update and immediately serve the sharpened
    posterior (predictive variance is monotonically non-increasing — also
    tested). v_noise and the variance scales are model parameters and stay
    fixed; this is a conditioning update, not a training step.
    """
    if isinstance(Vs_new, jax.Array) or not isinstance(Vs_new, (list, tuple)):
        Vs_new = [Vs_new]
    if isinstance(v_sigs, jax.Array) or not isinstance(v_sigs, (list, tuple)):
        v_sigs = [v_sigs]
    U_new = _scaled_features(Vs_new, [jnp.asarray(v) for v in v_sigs])
    R = core.G.shape[0]
    if U_new.shape[1] != R:
        raise ValueError(
            f"new rows build rank {U_new.shape[1]} features but the core "
            f"is rank {R}; pass the feature config the core was built with"
        )
    G2 = core.G + ops.gram(U_new)
    B2 = jnp.eye(R, dtype=G2.dtype) + G2 / core.v_noise
    Lb2 = jax.lax.linalg.cholesky(B2)
    # B·M recovers UᵀZ/v_n from the old core; add the new rows' projection
    rhs = core.M + core.G @ core.M / core.v_noise \
        + ops.matmul_tn(U_new, Z_new.astype(U_new.dtype)) / core.v_noise
    M2 = jax.scipy.linalg.cho_solve((Lb2, True), rhs)
    return PosteriorCore(M=M2, G=G2, Lb=Lb2, v_noise=core.v_noise)


def predict_from_core(
    V_star: Sequence[jax.Array] | jax.Array,
    core: PosteriorCore,
    v_sigs: Sequence[jax.Array] | jax.Array,
    *,
    return_var: bool = False,
):
    """Predictive mean (and variance) for new rows from the R-sized core.

    Mean: z* = U* M; variance (per row, shared across the L iid dims):
    var* = u*ᵀu* + v_n − u*ᵀ G B⁻¹ u* / v_n (see predict_latents)."""
    if isinstance(V_star, jax.Array) or not isinstance(V_star, (list, tuple)):
        V_star = [V_star]
    if isinstance(v_sigs, jax.Array) or not isinstance(v_sigs, (list, tuple)):
        v_sigs = [v_sigs]
    U_star = _scaled_features(V_star, [jnp.asarray(v) for v in v_sigs])
    mean = U_star @ core.M
    if not return_var:
        return mean
    Y = jax.scipy.linalg.cho_solve((core.Lb, True), U_star.T)  # B⁻¹ U*ᵀ
    quad = jnp.sum(U_star.T * (core.G @ Y), axis=0) / core.v_noise
    var = jnp.sum(jnp.square(U_star), axis=1) + core.v_noise - quad
    return mean, var


def predict_cov_from_core(
    V_star: Sequence[jax.Array] | jax.Array,
    core: PosteriorCore,
    v_sigs: Sequence[jax.Array] | jax.Array,
):
    """Joint predictive posterior over a whole request batch: mean (n, L)
    and the FULL n×n covariance across the requested rows (shared by the L
    iid latent dims) — where predict_from_core's return_var exposes only
    the diagonal.

    The cross-row covariance from the Woodbury pieces collapses to one
    R-sized solve:

        Cov = U* U*ᵀ + v_n I − U* G B⁻¹ U*ᵀ / v_n
            = U* B⁻¹ U*ᵀ + v_n I

    because I − G B⁻¹ / v_n = B⁻¹ (B = I + G/v_n, and B⁻¹ commutes with G).
    diag(Cov) equals predict_from_core's per-row variance exactly (tested),
    and the whole thing is computable from the serving core alone —
    O(n·R² + n²·R), still N-independent. This is what coherent JOINT
    posterior sampling needs (eval/serving.sample_images joint=True):
    requests of the same object from nearby views are strongly correlated
    under the posterior, which independent per-row draws throw away. The
    reference's predictive path (SURVEY.md §3.4) returns means only —
    no variance, let alone covariance.
    """
    if isinstance(V_star, jax.Array) or not isinstance(V_star, (list, tuple)):
        V_star = [V_star]
    if isinstance(v_sigs, jax.Array) or not isinstance(v_sigs, (list, tuple)):
        v_sigs = [v_sigs]
    U_star = _scaled_features(V_star, [jnp.asarray(v) for v in v_sigs])
    mean = U_star @ core.M
    Y = jax.scipy.linalg.cho_solve((core.Lb, True), U_star.T)  # B⁻¹ U*ᵀ
    cov = U_star @ Y + core.v_noise * jnp.eye(
        U_star.shape[0], dtype=U_star.dtype
    )
    return mean, cov


def predict_latents(
    V_star: Sequence[jax.Array] | jax.Array,
    factors: GPFactors,
    Z: jax.Array,
    v_sigs: Sequence[jax.Array] | jax.Array,
    *,
    return_var: bool = False,
):
    """GP-predictive latents for out-of-sample rows (SURVEY.md §3.4).

    Mean: z* = K(*, train) K⁻¹ Z = U* · (B⁻¹ Uᵀ Z) / v_n, with U* the scaled
    features of the held-out (object, view) pairs. Decoder(z*) is the
    conditional generation from (object, view) alone — no encoder involved.

    With return_var=True also returns the (n*,) per-row posterior variance,
    shared across the L iid latent dims:

        var* = k(*,*) − k(*,·) K⁻¹ k(·,*)
             = u*ᵀu* + v_n − u*ᵀ G B⁻¹ u* / v_n

    using K⁻¹U = U B⁻¹ / v_n ⇒ UᵀK⁻¹U = G B⁻¹ / v_n — everything R-sized.

    One-shot path over posterior_core()+predict_from_core(); a serving loop
    should build the core once and reuse it per request (eval/serving.py).
    """
    return predict_from_core(
        V_star, posterior_core(factors, Z), v_sigs, return_var=return_var
    )

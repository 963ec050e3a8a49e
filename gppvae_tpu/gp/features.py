"""Covariance feature maps: object/view feature rows → low-rank V.

Rebuild of the reference's covariance feature modules (SURVEY.md §2.1
"Covariance feature modules"): learnable object features X ∈ R^{P×M} and view
features W ∈ R^{Q×M_w}; the GP feature row of sample n with object d(n) and
view q(n) is

    v_n = x_{d(n)} ⊗ w_{q(n)}   ⇒   V Vᵀ = (X Xᵀ)_{d} ∘ (W Wᵀ)_{q}

i.e. the object×view *product kernel* on the sample grid, realized at rank
M·M_w without ever materializing the N×N kernel.

View-kernel choices (SURVEY.md §2.3 item 5):
  * learned linear W (GPPVAE-joint; face-view poses),
  * fixed Fourier features of the rotation angle (GPPVAE-dis on rotated
    digits) — [cos kθ, sin kθ]_k gives a periodic, translation-invariant
    view kernel of rank 2·num_freqs (+1 with the constant term).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# above this table size the one-hot backward's (n, P) matrix is no longer
# a cheap trade against XLA's scatter — fall back to the plain gather. Only
# the small view-feature table (Q rows) takes the one-hot path; where the
# crossover lies on the GPU is not measured yet.
_ONEHOT_BWD_MAX_ROWS = 64


@jax.custom_vjp
def _take_rows_onehot(A: jax.Array, idx: jax.Array) -> jax.Array:
    return jnp.take(A, idx, axis=0)


def _take_rows_fwd(A, idx):
    return jnp.take(A, idx, axis=0), (idx, A.shape[0])


def _take_rows_bwd(res, ct):
    idx, P = res
    # dA via a one-hot matmul instead of the gather's default scatter-add
    # transpose: a (P, n)·(n, M) dot rather than a scatter. Same values up
    # to summation order over duplicate ids.
    dA = jax.nn.one_hot(idx, P, dtype=ct.dtype).T @ ct
    return dA, np.zeros(idx.shape, dtype=jax.dtypes.float0)


_take_rows_onehot.defvjp(_take_rows_fwd, _take_rows_bwd)


def take_rows(A: jax.Array, idx: jax.Array) -> jax.Array:
    """A[idx] with a matmul-transpose backward (see _take_rows_bwd); the
    forward gather is unchanged (bit-identical). Falls back to the plain
    gather — scatter-add backward — above _ONEHOT_BWD_MAX_ROWS rows."""
    if A.shape[0] > _ONEHOT_BWD_MAX_ROWS:
        return jnp.take(A, idx, axis=0)
    return _take_rows_onehot(A, idx)


def normalize_rows(X: jax.Array, eps: float = 1e-8) -> jax.Array:
    """Project feature rows to the unit sphere.

    Keeps the object kernel a correlation-like kernel and prevents the
    unidentifiable scale of X from fighting the explicit variance components
    v_r during joint training. Applied to *learned* feature matrices only.
    """
    norm = jnp.sqrt(jnp.sum(jnp.square(X), axis=1, keepdims=True) + eps)
    return X / norm


def fourier_view_features(
    angles: jax.Array,
    num_freqs: int = 3,
    include_const: bool = True,
    dtype: jnp.dtype | None = None,
) -> jax.Array:
    """Fixed periodic view features for rotation angles (radians).

    Returns (Q, M_w) with rows f(θ) ∝ [1, cos θ, sin θ, …, cos Kθ, sin Kθ],
    scaled so ‖f(θ)‖ = 1 ⇒ the induced view kernel k(θ, θ') =
    f(θ)·f(θ') is a normalized truncated-Fourier periodic kernel with
    k(θ, θ) = 1. Used by GPPVAE-dis, where the view kernel is fixed
    (BASELINE.json:8; SURVEY.md §2.3 item 5).
    """
    angles = jnp.asarray(angles, dtype=dtype)
    if angles.ndim != 1:
        raise ValueError(f"angles must be 1-D, got shape {angles.shape}")
    if num_freqs < 1:
        # num_freqs=0 would silently return a rank-1 CONSTANT kernel (no
        # view discrimination at all) — a library-user foot-gun the trainer
        # already rejects via view_feature_dim (round-3 VERDICT weak #7)
        raise ValueError(f"num_freqs must be >= 1, got {num_freqs}")
    feats = []
    if include_const:
        feats.append(jnp.ones_like(angles))
    for k in range(1, num_freqs + 1):
        feats.append(jnp.cos(k * angles))
        feats.append(jnp.sin(k * angles))
    W = jnp.stack(feats, axis=1)
    return W / jnp.linalg.norm(W, axis=1, keepdims=True)


def polynomial_view_features(
    positions: jax.Array,
    degree: int = 3,
    dtype: jnp.dtype | None = None,
) -> jax.Array:
    """Fixed polynomial view features for a *linear* view axis (e.g. pose).

    Rows f(t) ∝ [1, t, t², …, t^degree] (t rescaled to [-1, 1]), unit-
    normalized — the fixed/linear view kernel for non-periodic view
    auxiliaries (BASELINE.json:8 wording; face poses, SURVEY.md §2.3 item 5).
    """
    t = jnp.asarray(positions, dtype=dtype)
    if t.ndim != 1:
        raise ValueError(f"positions must be 1-D, got shape {t.shape}")
    if degree < 1:
        # degree=0 is the same constant-kernel degeneracy as num_freqs=0
        raise ValueError(f"degree must be >= 1, got {degree}")
    lo, hi = jnp.min(t), jnp.max(t)
    t = jnp.where(hi > lo, 2.0 * (t - lo) / (hi - lo) - 1.0, t * 0.0)
    W = jnp.stack([t**k for k in range(degree + 1)], axis=1)
    return W / jnp.linalg.norm(W, axis=1, keepdims=True)


def make_rff_map(
    in_dim: int,
    num_features: int,
    lengthscale: float = 1.0,
    seed: int = 0,
):
    """Random Fourier feature map φ: R^in_dim → R^num_features.

    φ(f) = √(2/m)·cos(f Ω/ℓ + b) with fixed Ω ~ N(0, I), b ~ U[0, 2π), so
    E[φ(f)·φ(f')] = exp(−‖f−f'‖²/(2ℓ²)) — an RBF kernel at rank m. Applied
    to the *learned* object features it upgrades the object kernel from
    linear to stationary-nonlinear while keeping the whole GP inside the
    same low-rank Woodbury machinery (rank m·M_w instead of an N×N dense
    kernel). This is the realization of the fork's sparse-GP
    scaling direction (SURVEY.md §2.1 "thesis extensions"; cf. PAPERS.md
    inverse-free SVGP / scalable log-det lines): approximation rank is a
    config knob, solves stay O(N·R²).

    The map is differentiable in f, so minibatch gradients flow through it
    to the learned features exactly as in the linear case. Returns
    (map_fn, out_dim).
    """
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    omega = jax.random.normal(k1, (in_dim, num_features), jnp.float32)
    phase = jax.random.uniform(
        k2, (num_features,), jnp.float32, 0.0, 2.0 * jnp.pi
    )
    scale = jnp.sqrt(2.0 / num_features)

    def map_fn(F: jax.Array) -> jax.Array:
        return scale * jnp.cos(F @ (omega / lengthscale) + phase)

    return map_fn, num_features


def make_x_map(
    kind: str,
    in_dim: int,
    rff_features: int = 32,
    lengthscale: float = 1.0,
    seed: int = 0,
    nystrom_idx=None,
):
    """Object-kernel feature-map factory shared by the trainer and the eval
    CLI (one definition ⇒ train and eval can never disagree).

      'linear'      → None (identity; the reference's kernel)
      'rbf'         → random Fourier map at rank rff_features
      'rbf-nystrom' → the RFF map compressed onto the given landmark object
                      rows (gp/nystrom.py) — rank = len(nystrom_idx)
    """
    if kind == "linear":
        return None
    if kind == "rbf":
        fn, _ = make_rff_map(in_dim, rff_features, lengthscale, seed)
        return fn
    if kind == "rbf-nystrom":
        if nystrom_idx is None:
            raise ValueError(
                "object_kernel 'rbf-nystrom' needs landmark indices "
                "(trainer selects them; checkpoints carry state['nystrom_idx'])"
            )
        fn, _ = make_rff_map(in_dim, rff_features, lengthscale, seed)
        from gppvae_tpu.gp.nystrom import nystrom_features

        idx = jnp.asarray(nystrom_idx)
        return lambda F: nystrom_features(fn(F), idx)
    raise ValueError(f"unknown object_kernel {kind!r}")


def kron_rows(Xrows: jax.Array, Wrows: jax.Array) -> jax.Array:
    """Row-wise Kronecker (Khatri–Rao) product.

    Xrows: (n, M) object features gathered per sample; Wrows: (n, M_w) view
    features per sample → (n, M·M_w) with row_i = Xrows_i ⊗ Wrows_i, so that
    (kron_rows · kron_rowsᵀ) = (Xrows Xrowsᵀ) ∘ (Wrows Wrowsᵀ).
    """
    n, M = Xrows.shape
    n2, Mw = Wrows.shape
    if n != n2:
        raise ValueError(f"row count mismatch: {n} vs {n2}")
    return (Xrows[:, :, None] * Wrows[:, None, :]).reshape(n, M * Mw)


def build_effect_rows(
    X: jax.Array,
    W: jax.Array,
    object_ids: jax.Array,
    view_ids: jax.Array,
    *,
    extra_effects: tuple = (),
    x_map=None,
) -> list[jax.Array]:
    """Per-sample feature rows for every random effect, in variance order:
    [object⊗view product, *extra_effects]. The one shared builder used by
    the trainer, the OOS pipeline and the eval CLI — validates effect names
    so a corrupted config fails loudly instead of building a wrong kernel.
    """
    effects = [
        build_V(X, W, object_ids, view_ids,
                normalize_X=True, normalize_W=True, x_map=x_map)
    ]
    for e in extra_effects:
        if e == "object":
            effects.append(take_rows(normalize_rows(X), object_ids))
        elif e == "view":
            effects.append(take_rows(normalize_rows(W), view_ids))
        else:
            raise ValueError(
                f"unknown extra effect {e!r}; want 'object' or 'view'"
            )
    return effects


def build_V(
    X: jax.Array,
    W: jax.Array,
    object_ids: jax.Array,
    view_ids: jax.Array,
    *,
    normalize_X: bool = True,
    normalize_W: bool = False,
    x_map=None,
) -> jax.Array:
    """Gather per-sample object/view features and form V rows.

    X: (P, M) object features; W: (Q, M_w) view features; object_ids /
    view_ids: (n,) int32. Returns V: (n, M'·M_w). Differentiable w.r.t. X
    and W (gather + outer product), so minibatch GP-surrogate gradients flow
    to the feature matrices exactly as in the reference's joint mode.

    x_map: optional feature map applied to the (normalized) object features
    (e.g. make_rff_map for an RBF object kernel); None = linear kernel.
    """
    if normalize_X:
        X = normalize_rows(X)
    if normalize_W:
        W = normalize_rows(W)
    if x_map is not None:
        X = x_map(X)
    return kron_rows(take_rows(X, object_ids), take_rows(W, view_ids))

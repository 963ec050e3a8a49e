"""The GP hot ops as plain jax.numpy / lax.

On the GPU, XLA hands the two tall-skinny products to cuBLAS and the R×R
Cholesky and triangular solve to cuSOLVER/cuBLAS, which is what the
reference's torch code called too. A hand-written kernel belongs here only
where it is measured faster end to end on the card (PERF.md).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def gram(U: jax.Array) -> jax.Array:
    """Uᵀ U for tall-skinny U (N×R, N ≫ R). The Phase-B Gram (SURVEY §3.3)."""
    return jnp.dot(U.T, U, preferred_element_type=U.dtype)


def matmul_tn(A: jax.Array, B: jax.Array) -> jax.Array:
    """Aᵀ B with A: (N, R), B: (N, L) — the Uᵀ Z projection."""
    return jnp.dot(A.T, B, preferred_element_type=A.dtype)


def sqnorm(X: jax.Array) -> jax.Array:
    """‖X‖_F²."""
    return jnp.sum(jnp.square(X))


def factor_prep(U: jax.Array, Z: jax.Array):
    """(Uᵀ U, Uᵀ Z, ‖Z‖²) — the Phase-B factor prep (SURVEY.md §3.3's Gram
    + projection + reduction). Under a mesh GSPMD partitions the dots over
    the row-sharded N and psums the R-sized results."""
    return gram(U), matmul_tn(U, Z), sqnorm(Z)


def woodbury_nll_core(G, UtZ, zn, vn, n_rows, l_dims):
    """The NLL tail from the R-sized core: Cholesky of B = I + G/vn,
    triangular solve, log-det and quadratic form → scalar NLL (with const).
    n_rows/l_dims are the true (unpadded) N and L."""
    R = G.shape[0]
    B = jnp.eye(R, dtype=G.dtype) + G / vn
    Lb = jax.lax.linalg.cholesky(B)
    logdet = n_rows * jnp.log(vn) + 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lb)))
    W = jax.scipy.linalg.solve_triangular(Lb, UtZ, lower=True)
    quad = (zn - jnp.sum(jnp.square(W)) / vn) / vn
    return 0.5 * (
        l_dims * logdet + quad + n_rows * l_dims * math.log(2.0 * math.pi)
    )

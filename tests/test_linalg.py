"""The plain GP hot ops (ops.factor_prep, ops.woodbury_nll_core) at the
training widths, against float64 numpy and the dense oracle.

The shapes are the benchmark's: N=5700 train rows of the 400x16 digits grid
at R=56 (linear object kernel), the full N=6400 grid at R=256 (RFF object
map x view features + an object effect), and a ragged N. Inputs are float32
as in training; the references run in float64. The tolerances are float32
accumulation over N terms.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

from gppvae_tpu import gp, ops
from gppvae_tpu.gp.dense import dense_nll, materialize_K

VN = 0.5
CASES = [(5700, 56), (6400, 256), (1237, 56)]


def _inputs(n, r, zdim=16, seed=0):
    """U built like the trainer builds it (unit-norm object features x
    unit-norm Fourier view features; at R=256 an RFF object map with an
    extra object effect), Z standard normal."""
    rng = np.random.default_rng(seed)
    P, Q = 400, 16
    d = jnp.asarray(rng.integers(0, P, n), jnp.int32)
    q = jnp.asarray(rng.integers(0, Q, n), jnp.int32)
    W = gp.fourier_view_features(
        jnp.linspace(0.0, 2 * jnp.pi, Q, endpoint=False), 3)
    X = gp.normalize_rows(jnp.asarray(rng.normal(size=(P, 8)), jnp.float32))
    if r == 56:
        U = gp.build_V(X, W, d, q)
    else:
        rff, _ = gp.make_rff_map(8, 32, 1.0, seed=seed)
        F = rff(X)
        U = jnp.concatenate([gp.kron_rows(F[d], W[q]), F[d]], axis=1)
    Z = rng.normal(size=(n, zdim))
    return np.asarray(U, np.float32), np.asarray(Z, np.float32)


def _ref64(U, Z):
    U = U.astype(np.float64)
    Z = Z.astype(np.float64)
    N, R = U.shape
    L = Z.shape[1]
    G, UtZ, zn = U.T @ U, U.T @ Z, float(np.sum(Z * Z))
    B = np.eye(R) + G / VN
    quad = (zn - float(np.sum(UtZ * np.linalg.solve(B, UtZ))) / VN) / VN
    nll = 0.5 * (L * (N * math.log(VN) + np.linalg.slogdet(B)[1]) + quad
                 + N * L * math.log(2 * math.pi))
    return G, UtZ, zn, nll


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n,r", CASES)
def test_factor_prep_f32_matches_float64(n, r):
    U, Z = _inputs(n, r)
    assert U.shape == (n, r)
    G, UtZ, zn = jax.jit(ops.factor_prep)(jnp.asarray(U), jnp.asarray(Z))
    assert G.dtype == UtZ.dtype == zn.dtype == jnp.float32
    G64, UtZ64, zn64, _ = _ref64(U, Z)
    assert _rel(G, G64) < 1e-5
    assert _rel(UtZ, UtZ64) < 1e-5
    assert abs(float(zn) - zn64) / zn64 < 1e-6


@pytest.mark.parametrize("n,r", CASES)
def test_woodbury_nll_core_f32_matches_float64(n, r):
    U, Z = _inputs(n, r)

    def nll(u, z):
        G, UtZ, zn = ops.factor_prep(u, z)
        return ops.woodbury_nll_core(G, UtZ, zn, jnp.float32(VN), n, z.shape[1])

    got = float(jax.jit(nll)(jnp.asarray(U), jnp.asarray(Z)))
    want = _ref64(U, Z)[3]
    assert abs(got - want) / abs(want) < 1e-6


@pytest.mark.parametrize("n,r", [(1237, 56), (901, 256)])
def test_woodbury_nll_core_matches_dense_oracle(n, r):
    """float64 end to end: the Woodbury core equals the N x N dense
    Cholesky NLL of gp/dense.py."""
    U, Z = _inputs(n, r)
    U, Z = jnp.asarray(U, jnp.float64), jnp.asarray(Z, jnp.float64)
    G, UtZ, zn = ops.factor_prep(U, Z)
    got = ops.woodbury_nll_core(G, UtZ, zn, jnp.float64(VN), n, Z.shape[1])
    want = dense_nll(Z, materialize_K(U, 1.0, VN))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


@pytest.mark.parametrize("n,r", [(5700, 56), (1237, 256)])
def test_nll_gradient_matches_closed_form(n, r):
    """dNLL/dU through factor_prep + the core equals the closed form
    L·K⁻¹U − A(AᵀU), A = K⁻¹Z (float64)."""
    U, Z = _inputs(n, r)
    U64, Z64 = U.astype(np.float64), Z.astype(np.float64)
    L = Z.shape[1]

    def nll(u):
        G, UtZ, zn = ops.factor_prep(u, jnp.asarray(Z64))
        return ops.woodbury_nll_core(G, UtZ, zn, jnp.float64(VN), n, L)

    got = jax.jit(jax.grad(nll))(jnp.asarray(U64))
    B = np.eye(r) + U64.T @ U64 / VN
    A = (Z64 - U64 @ np.linalg.solve(B, U64.T @ Z64) / VN) / VN
    want = L * np.linalg.solve(B, U64.T).T / VN - A @ (A.T @ U64)
    assert _rel(got, want) < 1e-10


def test_factor_prep_check_grads():
    rng = np.random.default_rng(1)
    U = jnp.asarray(rng.normal(size=(37, 6)))
    Z = jnp.asarray(rng.normal(size=(37, 3)))
    check_grads(ops.factor_prep, (U, Z), order=2, modes=("fwd", "rev"))
    check_grads(ops.gram, (U,), order=1)
    check_grads(ops.matmul_tn, (U, Z), order=1)
    check_grads(ops.sqnorm, (Z,), order=1)


def test_woodbury_nll_core_check_grads():
    rng = np.random.default_rng(2)
    U = rng.normal(size=(41, 5))
    G = jnp.asarray(U.T @ U)
    UtZ = jnp.asarray(U.T @ rng.normal(size=(41, 4)))

    def core(G, UtZ, zn, vn):
        return ops.woodbury_nll_core(G, UtZ, zn, vn, 41, 4)

    check_grads(core, (G, UtZ, jnp.float64(150.0), jnp.float64(0.7)),
                order=2, modes=("fwd", "rev"))

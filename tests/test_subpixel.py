"""Parity tests for the subpixel decoder path (models._subpixel_upconv).

ConvDecoder(upsample='subpixel') must compute the SAME function as the
literal nearest-resize×2 + 3×3 conv path, with an IDENTICAL parameter
tree (so vae_weights/checkpoints interchange freely between the modes).
The rewrite computes a 2×2 low-res conv with 4× output channels instead
of a 3×3 conv on the upsampled grid — 2.25× fewer MACs and wider C_out.
"""

import jax
import jax.numpy as jnp
import pytest

from gppvae_tpu.models.vae import VAE, ConvDecoder

CASES = [
    ((32, 32, 1), (128, 64, 32), 16),
    ((64, 64, 3), (64, 32, 16, 8), 8),
    ((16, 16, 2), (32, 16), 4),
]


@pytest.mark.parametrize("image_shape,features,zdim", CASES)
def test_subpixel_matches_resize_fwd_and_grad(image_shape, features, zdim):
    key = jax.random.PRNGKey(0)
    dec_r = ConvDecoder(image_shape, features, upsample="resize")
    dec_s = ConvDecoder(image_shape, features, upsample="subpixel")
    z = jax.random.normal(key, (3, zdim))
    params = dec_r.init(key, z)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(
        dec_s.init(key, z)
    )
    yr = dec_r.apply(params, z)
    ys = dec_s.apply(params, z)
    assert yr.shape == ys.shape == (3, *image_shape)
    scale = float(jnp.max(jnp.abs(yr)))
    assert float(jnp.max(jnp.abs(yr - ys))) <= 1e-5 * scale

    gr = jax.grad(lambda p: jnp.sum(dec_r.apply(p, z) ** 2))(params)
    gs = jax.grad(lambda p: jnp.sum(dec_s.apply(p, z) ** 2))(params)
    for a, b in zip(jax.tree_util.tree_leaves(gr), jax.tree_util.tree_leaves(gs)):
        s = float(jnp.max(jnp.abs(a))) + 1e-12
        assert float(jnp.max(jnp.abs(a - b))) <= 1e-5 * s


def test_subpixel_vae_checkpoint_interchange():
    """Params trained under one mode evaluate identically under the other."""
    key = jax.random.PRNGKey(1)
    kw = dict(zdim=8, image_shape=(32, 32, 1))
    vr = VAE(**kw, upsample="resize")
    vs = VAE(**kw, upsample="subpixel")
    y = jax.random.uniform(key, (2, 32, 32, 1))
    params = vr.init(key, y, key)
    out_r = vr.apply(params, y, key)[0]
    out_s = vs.apply(params, y, key)[0]
    assert float(jnp.max(jnp.abs(out_r - out_s))) <= 1e-5 * (
        float(jnp.max(jnp.abs(out_r))) + 1e-12
    )


def test_subpixel_bfloat16_smoke():
    key = jax.random.PRNGKey(2)
    dec = ConvDecoder((32, 32, 1), (64, 32, 16), jnp.bfloat16, "subpixel")
    z = jax.random.normal(key, (2, 8))
    params = dec.init(key, z)
    out = dec.apply(params, z)
    assert out.dtype == jnp.float32 and bool(jnp.all(jnp.isfinite(out)))


def test_unknown_upsample_rejected():
    dec = ConvDecoder((32, 32, 1), (64, 32, 16), upsample="bogus")
    with pytest.raises(ValueError, match="unknown upsample"):
        dec.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))


@pytest.mark.parametrize("impl", ["dilated", "stack", "padsum"])
def test_subpixel_impl_env_selects_all_lowerings(impl, monkeypatch):
    """Every GPPVAE_SUBPIXEL_IMPL lowering computes the same function on
    the same param tree (the round-3 A/B contract)."""
    monkeypatch.delenv("GPPVAE_SUBPIXEL_IMPL", raising=False)
    key = jax.random.PRNGKey(3)
    dec_r = ConvDecoder((32, 32, 1), (32, 16), upsample="resize")
    dec_s = ConvDecoder((32, 32, 1), (32, 16), upsample="subpixel")
    z = jax.random.normal(key, (2, 8))
    params = dec_r.init(key, z)
    ref = dec_r.apply(params, z)
    monkeypatch.setenv("GPPVAE_SUBPIXEL_IMPL", impl)
    out = dec_s.apply(params, z)
    scale = float(jnp.max(jnp.abs(ref))) + 1e-12
    assert float(jnp.max(jnp.abs(ref - out))) <= 1e-5 * scale


def test_subpixel_impl_env_typo_rejected(monkeypatch):
    """A typo'd GPPVAE_SUBPIXEL_IMPL must error, not silently run the slow
    'stack' path (round-3 VERDICT weak #5: the env used to be read twice
    with different defaults)."""
    monkeypatch.setenv("GPPVAE_SUBPIXEL_IMPL", "dialted")
    dec = ConvDecoder((32, 32, 1), (32, 16), upsample="subpixel")
    params = dec.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    with pytest.raises(ValueError, match="GPPVAE_SUBPIXEL_IMPL"):
        dec.apply(params, jnp.zeros((1, 8)))

"""The plain-JAX conv VAE/CVAE: the parameter tree that checkpoints and
serving artifacts depend on, the initializers, output shapes at both image
widths, and the compute dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gppvae_tpu.models import CVAE, VAE


def _paths(tree):
    return {
        "/".join(str(k.key) for k in kp): tuple(v.shape)
        for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


_DIGITS_TREE = {
    "params/encoder/Conv_0/kernel": (3, 3, 1, 32),
    "params/encoder/Conv_1/kernel": (3, 3, 32, 64),
    "params/encoder/Conv_2/kernel": (3, 3, 64, 128),
    "params/encoder/Dense_0/kernel": (2048, 128),
    "params/encoder/head_mu/kernel": (128, 16),
    "params/encoder/head_logvar/kernel": (128, 16),
    "params/decoder/Dense_0/kernel": (16, 2048),
    "params/decoder/Conv_0/kernel": (3, 3, 128, 128),
    "params/decoder/Conv_1/kernel": (3, 3, 128, 64),
    "params/decoder/Conv_2/kernel": (3, 3, 64, 32),
    "params/decoder/Conv_3/kernel": (3, 3, 32, 1),
}


def test_vae_parameter_tree_names():
    model = VAE(zdim=16, image_shape=(32, 32, 1))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    got = _paths(params)
    kernels = {k: v for k, v in got.items() if k.endswith("/kernel")}
    assert kernels == _DIGITS_TREE
    for k, shape in kernels.items():
        assert got[k.replace("/kernel", "/bias")] == shape[-1:]


def test_cvae_parameter_tree_names():
    """Same tree as the VAE; the first layers widen by the view one-hot."""
    model = CVAE(zdim=16, image_shape=(32, 32, 1), num_views=16)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
                        jnp.zeros((1,), jnp.int32))
    got = _paths(params)
    want = dict(_DIGITS_TREE)
    want["params/encoder/Conv_0/kernel"] = (3, 3, 17, 32)
    want["params/decoder/Dense_0/kernel"] = (32, 2048)
    assert {k: v for k, v in got.items() if k.endswith("/kernel")} == want


def test_initializers_lecun_normal_and_zero_bias():
    model = VAE(zdim=16, image_shape=(32, 32, 1))
    p = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 1)))["params"]
    k = np.asarray(p["encoder"]["Dense_0"]["kernel"])  # fan_in 2048
    assert abs(k.std() * np.sqrt(2048) - 1.0) < 0.02
    assert abs(k.mean()) < 1e-3
    for sub in ("encoder", "decoder"):
        for layer in p[sub].values():
            assert not np.asarray(layer["bias"]).any()
            assert layer["kernel"].dtype == jnp.float32


@pytest.mark.parametrize("size,ch,zdim", [(32, 1, 16), (128, 3, 32)])
@pytest.mark.parametrize("upsample", ["resize", "subpixel"])
def test_vae_output_shapes(size, ch, zdim, upsample):
    model = VAE(zdim=zdim, image_shape=(size, size, ch), upsample=upsample)
    y = jax.random.uniform(jax.random.PRNGKey(0), (2, size, size, ch))
    params = model.init(jax.random.PRNGKey(1), y)
    mu, logvar = model.apply(params, y, method=VAE.encode)
    assert mu.shape == logvar.shape == (2, zdim)
    logits = model.apply(params, mu, method=VAE.decode)
    assert logits.shape == (2, size, size, ch)
    full, mu2, _, z = model.apply(params, y, jax.random.PRNGKey(2))
    assert full.shape == logits.shape and z.shape == mu.shape
    np.testing.assert_array_equal(mu2, mu)


@pytest.mark.parametrize("upsample", ["resize", "subpixel"])
def test_bf16_compute_gives_f32_outputs(upsample):
    """bfloat16 compute keeps float32 params and returns float32 outputs
    close to the float32 model's."""
    y = jax.random.uniform(jax.random.PRNGKey(0), (4, 32, 32, 1))
    f32 = VAE(zdim=16, image_shape=(32, 32, 1), upsample=upsample)
    bf16 = VAE(zdim=16, image_shape=(32, 32, 1), upsample=upsample,
               dtype=jnp.bfloat16)
    params = f32.init(jax.random.PRNGKey(1), y)
    mu, logvar = bf16.apply(params, y, method=VAE.encode)
    logits = bf16.apply(params, mu, method=VAE.decode)
    assert mu.dtype == logvar.dtype == logits.dtype == jnp.float32
    mu32 = f32.apply(params, y, method=VAE.encode)[0]
    assert float(jnp.max(jnp.abs(mu - mu32))) < 0.05 * float(jnp.max(jnp.abs(mu32)))

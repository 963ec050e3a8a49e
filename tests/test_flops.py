"""Analytic FLOP formulas (utils/flops.py) vs XLA's own cost analysis on
UNSCANNED programs (where cost_analysis is trustworthy — it counts scan
bodies once, which is exactly why the analytic path exists)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gppvae_tpu.models import VAE
from gppvae_tpu.utils.flops import (
    decoder_fwd_flops,
    encoder_fwd_flops,
    gp_solve_flops,
)


def _xla_flops(fn, *args):
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    if not ca or "flops" not in ca:
        pytest.skip("backend exposes no cost analysis")
    return ca["flops"]


IMAGE = (32, 32, 1)
ENC = (8, 16)
DEC = (16, 8)
ZDIM = 8


@pytest.fixture(scope="module")
def model_and_params():
    model = VAE(zdim=ZDIM, image_shape=IMAGE, enc_features=ENC, dec_features=DEC)
    y = jnp.zeros((64, *IMAGE), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), y, jax.random.PRNGKey(1))
    return model, params, y


def test_encoder_flops_match_xla(model_and_params):
    model, params, y = model_and_params
    xla = _xla_flops(lambda p, y: model.apply(p, y, method=VAE.encode), params, y)
    analytic = y.shape[0] * encoder_fwd_flops(IMAGE, ENC, ZDIM)
    # XLA also counts ELUs/padding bookkeeping; the matmul/conv terms dominate
    assert abs(xla - analytic) / xla < 0.25, (xla, analytic)


def test_decoder_flops_match_xla(model_and_params):
    model, params, _ = model_and_params
    z = jnp.zeros((64, ZDIM), jnp.float32)
    xla = _xla_flops(lambda p, z: model.apply(p, z, method=VAE.decode), params, z)
    analytic = z.shape[0] * decoder_fwd_flops(IMAGE, DEC, ZDIM)
    assert abs(xla - analytic) / xla < 0.25, (xla, analytic)


def test_subpixel_decoder_flops_match_xla():
    """The subpixel branch of decoder_fwd_flops backs the HEADLINE MFU
    (bench.py prices the fast-mode program with it) — pin it to XLA's count
    of the actual subpixel program, like the resize branch above."""
    model = VAE(zdim=ZDIM, image_shape=IMAGE, enc_features=ENC,
                dec_features=DEC, upsample="subpixel")
    y = jnp.zeros((64, *IMAGE), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), y, jax.random.PRNGKey(1))
    z = jnp.zeros((64, ZDIM), jnp.float32)
    xla = _xla_flops(lambda p, z: model.apply(p, z, method=VAE.decode), params, z)
    analytic = z.shape[0] * decoder_fwd_flops(IMAGE, DEC, ZDIM, "subpixel")
    assert abs(xla - analytic) / xla < 0.25, (xla, analytic)
    # and the formula must actually price FEWER MACs than the resize path
    assert analytic < z.shape[0] * decoder_fwd_flops(IMAGE, DEC, ZDIM)


def test_gp_solve_flops_match_xla():
    from gppvae_tpu import gp

    N, R, L = 2048, 56, 16
    U = jnp.zeros((N, R), jnp.float32)
    Z = jnp.zeros((N, L), jnp.float32)

    def solve(U, Z):
        return gp.gp_nll_from_features(Z, U, jnp.float32(1.0), jnp.float32(0.5))

    xla = _xla_flops(solve, U, Z)
    analytic = gp_solve_flops(N, R, L)
    assert abs(xla - analytic) / max(xla, 1) < 0.35, (xla, analytic)


def test_fused_epoch_cost_smoke():
    """fused_epoch_cost compiles the real fused program and returns XLA's
    cost dict (scan-body-once caveat documented in its docstring)."""
    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.train import GPPVAETrainConfig
    from gppvae_tpu.train.train_gppvae import fused_epoch_cost

    ds = build_rotated_digits("synthetic", num_objects=8, num_views=8, seed=0)
    config = GPPVAETrainConfig(
        mode="joint", zdim=8, epochs=1, batch_size=16,
        obj_feature_dim=4, view_num_freqs=1,
        enc_features=(8, 16), dec_features=(16, 8),
    )
    ca = fused_epoch_cost(ds, config, n_epochs=1)
    assert ca.get("flops", 0) > 0


def test_fused_epoch_program_hash_stable_and_program_sensitive():
    """The bench artifact's program identity (round-3 VERDICT weak #6):
    same config ⇒ same sha (wall-clock drift can't read as a program change);
    a decoder-lowering change ⇒ different sha."""
    import dataclasses

    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.train import GPPVAETrainConfig
    from gppvae_tpu.train.train_gppvae import fused_epoch_program_hash

    ds = build_rotated_digits("synthetic", num_objects=8, num_views=8, seed=0)
    config = GPPVAETrainConfig(
        mode="joint", zdim=8, epochs=1, batch_size=16,
        obj_feature_dim=4, view_num_freqs=1,
        enc_features=(8, 16), dec_features=(16, 8),
    )
    h = fused_epoch_program_hash(ds, config)
    assert h == fused_epoch_program_hash(ds, config)
    assert h != fused_epoch_program_hash(
        ds, dataclasses.replace(config, dec_upsample="subpixel")
    )


def test_fwd_bwd_is_about_3x_fwd(model_and_params):
    """The backward=2×forward convention used by gppvae_epoch_flops, checked
    against XLA's count of an actual value_and_grad program."""
    model, params, y = model_and_params

    def loss(p, y, z_key):
        logits, mu, logvar, _ = model.apply(p, y, z_key)
        return jnp.sum((jax.nn.sigmoid(logits) - y) ** 2) + jnp.sum(mu + logvar)

    key = jax.random.PRNGKey(2)
    def fwdbwd_fn(p, y, k):
        v, g = jax.value_and_grad(loss)(p, y, k)
        # consume the grads so the backward isn't dead-code-eliminated
        return v + sum(jnp.sum(x) for x in jax.tree.leaves(g))

    fwd = _xla_flops(loss, params, y, key)
    fwdbwd = _xla_flops(fwdbwd_fn, params, y, key)
    ratio = fwdbwd / fwd
    assert 2.0 < ratio < 4.5, ratio


def test_fused_epoch_program_hash_is_device_free_and_matches_concrete():
    """bench hashes the program at the END of a heavy run — the lowering
    must run with ZERO device ops (abstract eval_shape path) AND produce the same sha as
    a concrete-argument lowering (the pre-change path), so recorded
    program_sha1 values stay comparable."""
    import hashlib

    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.train import GPPVAETrainConfig
    from gppvae_tpu.train.train_gppvae import (
        _Loop,
        _setup,
        epoch_keys,
        fused_epoch_program_hash,
        make_optimizer,
        resolve_grad_accum,
    )

    ds = build_rotated_digits("synthetic", num_objects=8, num_views=8, seed=0)
    config = GPPVAETrainConfig(
        mode="joint", zdim=8, epochs=1, batch_size=16,
        obj_feature_dim=4, view_num_freqs=1,
        enc_features=(8, 16), dec_features=(16, 8),
    )

    model, params, fixed_W, a, rng, num_train = _setup(
        ds, config, None, None
    )
    accum = resolve_grad_accum(
        config.grad_accum_steps, num_train, config.batch_size
    )
    ov = make_optimizer(config.lr_vae, config.clip_grad_norm, accum)
    og = make_optimizer(config.lr_gp, config.clip_grad_norm, accum)
    loop = _Loop(model, ov, og, config, num_train, None, nystrom_idx=None)
    n = config.epochs_per_dispatch
    text = loop.make_fused_fn(n).lower(
        params, ov.init(params["vae"]), og.init(params["gp"]),
        fixed_W, a["images_tr"], a["d_tr"], a["q_tr"],
        a["y_ho"], a["d_ho"], a["q_ho"], epoch_keys(rng, 0, n),
        a["row_mask"],
    ).as_text()
    concrete = hashlib.sha1(text.encode()).hexdigest()[:16]

    assert fused_epoch_program_hash(ds, config) == concrete

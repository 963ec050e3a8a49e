"""On-card end-to-end tier (`-m chip`, skipped without a GPU): the fused
GPPVAE pipeline compiles and trains on the card, and the serving path
answers from the live model and from exported blobs."""

import numpy as np
import pytest

pytestmark = pytest.mark.chip


def test_fused_gppvae_on_chip(chip):
    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.train import GPPVAETrainConfig, train_gppvae

    ds = build_rotated_digits("synthetic", num_objects=24, num_views=8, seed=0)
    config = GPPVAETrainConfig(
        mode="joint", zdim=8, epochs=6, batch_size=32, lr_gp=5e-3,
        obj_feature_dim=4, view_num_freqs=2,
        enc_features=(8, 16), dec_features=(16, 8),
        epochs_per_dispatch=3,
    )
    result = train_gppvae(ds, config)
    losses = [h["loss"] for h in result.history]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert result.history[-1]["oos_mse"] < result.history[0]["oos_mse"]


def test_serving_fold_and_throughput_on_chip(chip):
    """The deployment path on the real chip: fold the posterior once,
    answer request batches through ONE compiled program, posterior
    sampling included — the machinery behind bench's oos_serving number
    and the serve CLI's --repeat/--stdin modes."""
    import time

    import jax
    import jax.numpy as jnp

    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.eval import build_server_state, predict_images, sample_images
    from gppvae_tpu.train import GPPVAETrainConfig, train_gppvae
    from gppvae_tpu.utils.metrics import NullLogger

    ds = build_rotated_digits("synthetic", num_objects=24, num_views=8, seed=0)
    cfg = GPPVAETrainConfig(
        mode="joint", zdim=8, epochs=2, batch_size=32,
        obj_feature_dim=4, view_num_freqs=2,
        enc_features=(8, 16), dec_features=(16, 8),
        compute_dtype="bfloat16", dec_upsample="subpixel",
    )
    res = train_gppvae(ds, cfg, log=NullLogger())
    tr = ds.train_idx
    state = build_server_state(
        res.model, res.params, res.fixed_W,
        jnp.asarray(ds.images[tr]), jnp.asarray(ds.object_ids[tr]),
        jnp.asarray(ds.view_ids[tr]),
    )
    served = jax.jit(lambda s, d, q: predict_images(res.model, s, d, q))
    d = jnp.asarray(ds.object_ids[ds.heldout_idx])
    q = jnp.asarray(ds.view_ids[ds.heldout_idx])
    y = jax.device_get(served(state, d, q))  # compile + answer
    assert y.shape == (len(ds.heldout_idx), *ds.image_shape)
    assert np.isfinite(y).all()
    t0 = time.perf_counter()
    for i in range(3):
        jax.device_get(served(state, (d + i + 1) % 24, (q + i + 1) % 8))
    sec = (time.perf_counter() - t0) / 3
    assert sec < 5.0, f"warm serve batch took {sec:.2f}s on-chip"
    y_s = sample_images(res.model, state, d[:2], q[:2],
                        jax.random.PRNGKey(0), 3)
    assert y_s.shape == (2, 3, *ds.image_shape)
    assert np.isfinite(np.asarray(y_s)).all()

    # streaming conditioning on-chip: fold the heldout rows, variance at
    # the observed cells shrinks, and the SAME compiled `served` program
    # answers from the updated state (the state is an argument)
    from gppvae_tpu.eval.serving import observe

    served_v = jax.jit(lambda s, dd, qq: predict_images(
        res.model, s, dd, qq, return_var=True))
    _, var0 = jax.device_get(served_v(state, d, q))
    state2 = observe(res.model, state,
                     jnp.asarray(ds.images[ds.heldout_idx]), d, q)
    y2, var1 = jax.device_get(served_v(state2, d, q))
    assert np.isfinite(y2).all()
    assert (var1 <= var0 + 1e-6).all() and (var1 < var0 - 1e-6).any()

    # the exported-blob surface on the real chip (round-5): mean + joint
    # sample entries answer like the live-model path — the cuda
    # lowering inside the v2 artifact is executed, not just serialized
    import tempfile

    from gppvae_tpu.eval.serving import (
        export_compiled_program,
        load_compiled_program,
    )

    with tempfile.TemporaryDirectory() as td:
        exe = f"{td}/m.exe"
        export_compiled_program(
            res.model, state, exe,
            entry_points=("mean", "sample_joint", "observe", "sample_core"),
        )
        exp, _ = load_compiled_program(exe)
        # a separate compilation of a bf16 model: on the card its roundings
        # need not match the live program's bit for bit (bit-exactness of
        # the blob is pinned on the f32 CPU tier)
        np.testing.assert_allclose(
            np.asarray(exp.call(d, q)), np.asarray(served(state, d, q)),
            atol=8e-3,
        )
        exp_j, _ = load_compiled_program(exe, entry="sample_joint")
        y_exe = np.asarray(exp_j.call(d[:2], q[:2], jnp.int32(5),
                                      jnp.zeros((3,), jnp.int32)))
        y_ref = np.asarray(sample_images(res.model, state, d[:2], q[:2],
                                         jax.random.PRNGKey(5), 3, joint=True))
        # bf16 model: the baked-constant program fuses/folds differently
        # than the live one, flipping bf16 roundings in the draw math —
        # bit-exactness of the blob is pinned on the f32 CPU tier
        # (test_export_full_serving_surface); this asserts bf16-scale parity
        np.testing.assert_allclose(y_exe, y_ref, atol=8e-3)
        assert np.isfinite(y_exe).all()

        # stateful sampling from an observe-updated core, blobs alone
        # (round-5 second session): fold two fresh rows with the observe
        # entry, then draw from the sharpened posterior via sample_core —
        # must match the live observe()+sample_images() path at bf16 scale
        exp_obs, _ = load_compiled_program(exe, entry="observe")
        core0, _ = load_compiled_program(exe, entry="core")
        imgs_new = jnp.asarray(ds.images[ds.heldout_idx[:2]])
        d_new = jnp.asarray(ds.object_ids[ds.heldout_idx[:2]])
        q_new = jnp.asarray(ds.view_ids[ds.heldout_idx[:2]])
        core2 = exp_obs.call(core0, imgs_new, d_new, q_new,
                             jnp.ones((2,), jnp.float32))
        exp_sc, _ = load_compiled_program(exe, entry="sample_core")
        y_sc = np.asarray(exp_sc.call(core2, d[:2], q[:2], jnp.int32(5),
                                      jnp.zeros((3,), jnp.int32)))
        st2 = observe(res.model, state, imgs_new, d_new, q_new)
        y_live = np.asarray(sample_images(res.model, st2, d[:2], q[:2],
                                          jax.random.PRNGKey(5), 3))
        np.testing.assert_allclose(y_sc, y_live, atol=8e-3)
        assert np.isfinite(y_sc).all()

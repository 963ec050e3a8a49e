"""Vanilla conv-VAE pretrain driver (reference: pysrc/faceplace/train_vae.py,
SURVEY.md §3.1; config BASELINE.json:7).

Loop design: the whole dataset lives in device memory; one `jax.jit`'ed
`lax.scan` runs the entire epoch of minibatch steps on-device (the host
uploads an epoch RNG key and reads back scalar metrics once per epoch —
no per-minibatch host↔device traffic, unlike the reference's dataloader).
Produces the `vae_weights` artifact consumed by train_gppvae.
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gppvae_tpu.checkpoint import save_train_state, save_vae_weights
from gppvae_tpu.data.dataset import GridDataset
from gppvae_tpu.eval.panels import save_panel
from gppvae_tpu.models import VAE
from gppvae_tpu.parallel import replicated, row_sharding, shard_rows
from gppvae_tpu.train.batching import (
    epoch_batches,
    epoch_keys,
    masked_means,
    num_batches,
)
from gppvae_tpu.train.losses import (
    gaussian_recon_nll,
    kl_standard_normal,
    logit_saturation_penalty,
)
from gppvae_tpu.utils import MetricsLogger


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    """Flags mirror the reference CLI (SURVEY.md §2.1: --zdim --bs --lr
    --epochs --seed …) plus accelerator knobs (compute dtype)."""

    zdim: int = 16
    epochs: int = 50
    batch_size: int = 128
    lr: float = 2e-4
    seed: int = 0
    sigma_y: float = 0.1  # decoder Gaussian likelihood std
    beta_kl: float = 1.0
    enc_features: Sequence[int] = (32, 64, 128)
    dec_features: Sequence[int] = (128, 64, 32)
    compute_dtype: str = "float32"  # 'bfloat16' for tensor-core speed
    # saturation-death barrier weight (losses.logit_saturation_penalty):
    # exactly zero for healthy logits, prevents permanent sigmoid death
    # on extreme-horizon runs (<=0 off)
    sat_penalty: float = 1.0
    dec_upsample: str = "resize"  # 'subpixel' = exact fused low-res rewrite
    # images stored FLAT (N, H·W·C) above this size, reshaped per gather
    # (default 0 = always; value-exact) — see
    # GPPVAETrainConfig.flat_images_threshold for the layout story
    flat_images_threshold: int = 0
    epochs_per_dispatch: int = 1  # fused pipeline: epochs per jit dispatch
    outdir: str | None = None
    panel_every: int = 0  # epochs between image panels (0 = off)
    checkpoint_every: int = 0  # epochs between state checkpoints (0 = end only)


@dataclasses.dataclass
class VAETrainResult:
    vae_params: Any
    config: VAETrainConfig
    history: list[dict]
    model: VAE


def _build_model(config: VAETrainConfig, image_shape) -> VAE:
    return VAE(
        zdim=config.zdim,
        image_shape=tuple(image_shape),
        enc_features=tuple(config.enc_features),
        dec_features=tuple(config.dec_features),
        dtype=jnp.bfloat16 if config.compute_dtype == "bfloat16" else jnp.float32,
        upsample=config.dec_upsample,
    )


def make_epochs_fn(
    model: VAE, optimizer, config: VAETrainConfig, num_train: int,
    n_epochs: int, mesh=None,
):
    """One jit dispatch = `n_epochs` epochs: outer scan over epochs, inner
    scan over permuted minibatches; per-epoch val metrics computed inside
    (zero host↔device sync within the super-step — same fused-pipeline
    design as train_gppvae)."""
    bs = config.batch_size
    if bs > num_train:
        raise ValueError(f"batch_size {bs} exceeds train set {num_train}")
    nb = num_batches(num_train, bs)  # ceil: every row trains every epoch
    batch_sharding = row_sharding(mesh) if mesh is not None else None

    @partial(jax.jit, donate_argnums=(0, 1))
    def epochs_fn(params, opt_state, images, train_idx, val_idx, keys):
        def minibatch_step(carry, xs):
            params, opt_state = carry
            batch_idx, w, step_key = xs
            # noise drawn OUTSIDE the differentiated loss so the backward
            # pass reuses the saved ε instead of rematerializing threefry
            # (same key/shape/dtype as reparameterize → bit-identical z;
            # see train_gppvae.minibatch_epoch for the trace evidence)
            eps = jax.random.normal(step_key, (bs, config.zdim), jnp.float32)

            def loss_fn(p):
                y = images[batch_idx]
                if y.ndim == 2:  # flat large-N storage → NHWC batch
                    y = y.reshape(bs, *model.image_shape)
                if batch_sharding is not None:
                    # DP: shard the gathered batch rows across the mesh
                    y = jax.lax.with_sharding_constraint(y, batch_sharding)
                mu, logvar = model.apply(p, y, method=VAE.encode)
                z = mu + jnp.exp(0.5 * logvar) * eps  # == reparameterize
                logits = model.apply(p, z, method=VAE.decode)
                recon, mse = gaussian_recon_nll(
                    y, jax.nn.sigmoid(logits), config.sigma_y
                )
                if config.sat_penalty > 0:
                    # saturation-death barrier — zero for healthy logits
                    recon = recon + config.sat_penalty * logit_saturation_penalty(logits)
                kl = kl_standard_normal(mu, logvar)
                # sum over valid rows / constant bs (batching.py convention)
                loss = jnp.sum(w * (recon + config.beta_kl * kl)) / bs
                return loss, masked_means(w, recon, kl, mse)

            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), jnp.stack([loss, *aux])

        def epoch_body(carry, epoch_key):
            params, opt_state = carry
            batches, weights = epoch_batches(epoch_key, train_idx, bs)
            step_keys = jax.random.split(jax.random.fold_in(epoch_key, 1), nb)
            (params, opt_state), metrics = jax.lax.scan(
                minibatch_step, (params, opt_state),
                (batches, weights, step_keys)
            )
            row = jnp.mean(metrics, axis=0)
            if val_idx is not None:
                yv = images[val_idx]
                if yv.ndim == 2:
                    yv = yv.reshape(yv.shape[0], *model.image_shape)
                logits, mu, logvar, _ = model.apply(
                    params, yv, jax.random.fold_in(epoch_key, 2)
                )
                recon, mse = gaussian_recon_nll(
                    yv, jax.nn.sigmoid(logits), config.sigma_y
                )
                kl = kl_standard_normal(mu, logvar)
                row = jnp.concatenate([
                    row,
                    jnp.stack([
                        jnp.mean(recon + config.beta_kl * kl), jnp.mean(mse)
                    ]),
                ])
            return (params, opt_state), row

        (params, opt_state), rows = jax.lax.scan(
            epoch_body, (params, opt_state), keys
        )
        return params, opt_state, rows

    return epochs_fn


def train_vae(
    dataset: GridDataset,
    config: VAETrainConfig,
    *,
    mesh=None,
    log: MetricsLogger | None = None,
) -> VAETrainResult:
    own_log = log is None
    log = log or MetricsLogger(config.outdir)
    model = _build_model(config, dataset.image_shape)
    rng = jax.random.PRNGKey(config.seed)
    rng, init_key, sample_key = jax.random.split(rng, 3)

    images = jnp.asarray(dataset.images)  # HBM-resident for the whole run
    if images.shape[0] > config.flat_images_threshold:
        images = images.reshape(images.shape[0], -1)  # contiguous gathers
    train_idx = jnp.asarray(dataset.train_idx)
    val_idx = jnp.asarray(dataset.val_idx) if len(dataset.val_idx) else None
    if mesh is not None:
        # pad rows to an even shard split (padding rows are never indexed)
        n_dev = mesh.devices.size
        pad = (-images.shape[0]) % n_dev
        if pad:
            images = jnp.pad(
                images, ((0, pad),) + ((0, 0),) * (images.ndim - 1)
            )
        images = shard_rows(mesh, images)

    params = model.init(
        init_key, images[:1].reshape(1, *dataset.image_shape), sample_key
    )
    if mesh is not None:
        params = jax.device_put(params, replicated(mesh))
    optimizer = optax.adam(config.lr)
    opt_state = optimizer.init(params)

    fns: dict[int, Any] = {}
    history: list[dict] = []
    done = 0
    while done < config.epochs:
        e = min(config.epochs_per_dispatch, config.epochs - done)
        if e not in fns:
            fns[e] = make_epochs_fn(
                model, optimizer, config, len(dataset.train_idx), e, mesh
            )
        t0 = time.perf_counter()
        # keys keyed by absolute epoch (batching.epoch_keys): the trajectory
        # is invariant to epochs_per_dispatch and resume boundaries
        keys = epoch_keys(rng, done, e)
        params, opt_state, rows = fns[e](
            params, opt_state, images, train_idx, val_idx, keys
        )
        rows = np.asarray(jax.device_get(rows))
        sec = (time.perf_counter() - t0) / e
        for i in range(e):
            rec = {
                "driver": "train_vae",
                "epoch": done + i,
                "loss": float(rows[i, 0]),
                "recon_term": float(rows[i, 1]),
                "kl_term": float(rows[i, 2]),
                "mse": float(rows[i, 3]),
                "sec_epoch": sec,
            }
            if val_idx is not None:
                rec["val_loss"] = float(rows[i, 4])
                rec["val_mse"] = float(rows[i, 5])
            log.log(rec)
            history.append(rec)
        done += e

        if config.outdir:
            _epoch_artifacts(
                model, params, images, dataset, config, done - 1,
                jax.random.fold_in(keys[-1], 3),
            )

    if config.outdir:
        save_vae_weights(os.path.join(config.outdir, "vae_weights"), params)
        save_train_state(
            os.path.join(config.outdir, "final_state"),
            {"params": params, "opt_state": opt_state, "epoch": config.epochs},
        )
    if own_log:
        log.close()
    return VAETrainResult(vae_params=params, config=config, history=history, model=model)


def _epoch_artifacts(model, params, images, dataset, config, epoch, key):
    last = epoch == config.epochs - 1
    if config.panel_every and (epoch % config.panel_every == 0 or last):
        idx = np.asarray(dataset.val_idx[:8] if len(dataset.val_idx) else dataset.train_idx[:8])
        y = images[idx]
        if y.ndim == 2:
            y = y.reshape(-1, *model.image_shape)
        logits, *_ = model.apply(params, y, key)
        save_panel(
            os.path.join(config.outdir, f"panel_{epoch:04d}.png"),
            [np.asarray(y), np.asarray(jax.nn.sigmoid(logits))],
        )
    if config.checkpoint_every and epoch % config.checkpoint_every == 0 and not last:
        save_vae_weights(os.path.join(config.outdir, f"vae_weights_{epoch:04d}"), params)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Vanilla conv-VAE pretrain (GPPVAE stage 1)")
    p.add_argument("--data", default="synthetic",
                   help="rotated-digits source: synthetic | sklearn | mnist:<dir> | faces[:h5path]")
    p.add_argument("--outdir", default="./out/vae")
    p.add_argument("--zdim", type=int, default=16)
    p.add_argument("--bs", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma_y", type=float, default=0.1)
    p.add_argument("--num_objects", type=int, default=400)
    p.add_argument("--num_views", type=int, default=16)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--dec_upsample", default="resize",
                   choices=["resize", "subpixel"])
    p.add_argument("--epochs_per_dispatch", type=int, default=1)
    p.add_argument("--panel_every", type=int, default=10)
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="epochs between vae_weights_NNNN checkpoints "
                        "(0 = end only)")
    p.add_argument("--beta_kl", type=float, default=1.0)
    p.add_argument("--enc_features", default="32,64,128",
                   help="comma-separated encoder conv channels")
    p.add_argument("--dec_features", default="128,64,32",
                   help="comma-separated decoder conv channels")
    p.add_argument("--image_size", type=int, default=None,
                   help="spatial size for built datasets (default: builder's own)")
    args = p.parse_args(argv)

    from gppvae_tpu.config.datasets import build_dataset_from_flag

    ds = build_dataset_from_flag(args.data, args.num_objects, args.num_views,
                                 args.seed, image_size=args.image_size)
    config = VAETrainConfig(
        zdim=args.zdim, epochs=args.epochs, batch_size=args.bs, lr=args.lr,
        seed=args.seed, sigma_y=args.sigma_y, compute_dtype=args.dtype, dec_upsample=args.dec_upsample,
        epochs_per_dispatch=args.epochs_per_dispatch,
        outdir=args.outdir, panel_every=args.panel_every,
        checkpoint_every=args.checkpoint_every, beta_kl=args.beta_kl,
        enc_features=tuple(int(f) for f in args.enc_features.split(",")),
        dec_features=tuple(int(f) for f in args.dec_features.split(",")),
    )
    train_vae(ds, config)


if __name__ == "__main__":
    main()

"""CVAE baseline driver (the paper's comparison model; no GP).

Same fused scan-per-dispatch loop as train_vae, plus per-epoch out-of-sample
conditional generation: for a held-out (object, view*) cell, average the
object's encoded latent means over its TRAINING views and decode with the
target view conditioning. Exists so validate.py can reproduce the paper's
GPPVAE-vs-CVAE comparison inside this framework.
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

from gppvae_tpu.data.dataset import GridDataset
from gppvae_tpu.models.cvae import CVAE
from gppvae_tpu.models.vae import encode_all
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
class CVAETrainConfig:
    zdim: int = 16
    epochs: int = 50
    batch_size: int = 128
    lr: float = 2e-4
    seed: int = 0
    sigma_y: float = 0.1
    beta_kl: float = 1.0
    enc_features: Sequence[int] = (32, 64, 128)
    dec_features: Sequence[int] = (128, 64, 32)
    compute_dtype: str = "float32"
    # saturation-death barrier (losses.logit_saturation_penalty; <=0 off)
    sat_penalty: float = 1.0
    dec_upsample: str = "resize"  # 'subpixel' = exact fused low-res rewrite
    epochs_per_dispatch: int = 1
    outdir: str | None = None


@dataclasses.dataclass
class CVAETrainResult:
    params: Any
    config: CVAETrainConfig
    history: list[dict]
    model: CVAE


def train_cvae(
    dataset: GridDataset,
    config: CVAETrainConfig,
    *,
    log: MetricsLogger | None = None,
) -> CVAETrainResult:
    own_log = log is None
    log = log or MetricsLogger(config.outdir)
    model = CVAE(
        zdim=config.zdim,
        image_shape=tuple(dataset.image_shape),
        num_views=dataset.num_views,
        enc_features=tuple(config.enc_features),
        dec_features=tuple(config.dec_features),
        dtype=jnp.bfloat16 if config.compute_dtype == "bfloat16" else jnp.float32,
        upsample=config.dec_upsample,
    )
    rng = jax.random.PRNGKey(config.seed)
    rng, init_key, sample_key = jax.random.split(rng, 3)

    tr, ho = dataset.train_idx, dataset.heldout_idx
    images_tr = jnp.asarray(dataset.images[tr])
    d_tr = jnp.asarray(dataset.object_ids[tr])
    q_tr = jnp.asarray(dataset.view_ids[tr])
    y_ho = jnp.asarray(dataset.images[ho])
    d_ho = jnp.asarray(dataset.object_ids[ho])
    q_ho = jnp.asarray(dataset.view_ids[ho])
    num_train = len(tr)
    P = dataset.num_objects

    params = model.init(init_key, images_tr[:1], q_tr[:1], sample_key)
    optimizer = optax.adam(config.lr)
    opt_state = optimizer.init(params)

    bs = config.batch_size
    if bs > num_train:
        raise ValueError(f"batch_size {bs} exceeds train set {num_train}")
    nb = num_batches(num_train, bs)  # ceil: every row trains every epoch

    def oos_eval(params):
        mu = encode_all(
            model, params, images_tr, min(1024, num_train),
            method=CVAE.encode, extra=(q_tr,),
        )
        zsum = jax.ops.segment_sum(mu, d_tr, num_segments=P)
        counts = jax.ops.segment_sum(jnp.ones(num_train), d_tr, num_segments=P)
        zbar = zsum / jnp.maximum(counts, 1.0)[:, None]
        logits = model.apply(params, zbar[d_ho], q_ho, method=CVAE.decode)
        y_pred = jax.nn.sigmoid(logits)
        return y_pred, jnp.mean(jnp.square(y_ho - y_pred))

    @partial(jax.jit, donate_argnums=(0, 1), static_argnums=(2,))
    def run_epochs(params, opt_state, n_epochs, keys):
        def minibatch_step(carry, xs):
            params, opt_state = carry
            pos, w, step_key = xs
            # noise drawn OUTSIDE the differentiated loss (saved residual
            # instead of a threefry remat in backward; bit-identical z —
            # see train_gppvae.minibatch_epoch)
            eps = jax.random.normal(step_key, (bs, config.zdim), jnp.float32)

            def loss_fn(p):
                y = images_tr[pos]
                q = q_tr[pos]
                mu, logvar = model.apply(p, y, q, method=CVAE.encode)
                z = mu + jnp.exp(0.5 * logvar) * eps  # == reparameterize
                logits = model.apply(p, z, q, method=CVAE.decode)
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
            batches, weights = epoch_batches(epoch_key, num_train, bs)
            step_keys = jax.random.split(jax.random.fold_in(epoch_key, 1), nb)
            (params, opt_state), metrics = jax.lax.scan(
                minibatch_step, (params, opt_state),
                (batches, weights, step_keys),
            )
            _, oos = oos_eval(params)
            return (params, opt_state), jnp.concatenate(
                [jnp.mean(metrics, axis=0), jnp.stack([oos])]
            )

        (params, opt_state), rows = jax.lax.scan(
            epoch_body, (params, opt_state), keys
        )
        return params, opt_state, rows

    history: list[dict] = []
    done = 0
    while done < config.epochs:
        e = min(config.epochs_per_dispatch, config.epochs - done)
        t0 = time.perf_counter()
        # absolute-epoch keys (batching.epoch_keys): trajectory invariant to
        # epochs_per_dispatch
        params, opt_state, rows = run_epochs(
            params, opt_state, e, epoch_keys(rng, done, e)
        )
        rows = np.asarray(jax.device_get(rows))
        sec = (time.perf_counter() - t0) / e
        for i in range(e):
            rec = {
                "driver": "train_cvae",
                "epoch": done + i,
                "loss": float(rows[i, 0]),
                "recon_term": float(rows[i, 1]),
                "kl_term": float(rows[i, 2]),
                "mse": float(rows[i, 3]),
                "oos_mse": float(rows[i, 4]),
                "sec_epoch": sec,
            }
            log.log(rec)
            history.append(rec)
        done += e

    if config.outdir:
        from gppvae_tpu.checkpoint import save_train_state, save_vae_weights
        from gppvae_tpu.eval.panels import save_panel

        # cvae_weights: the same params-subtree artifact shape as the VAE
        # pretrain's vae_weights (cross-script handoff convention)
        save_vae_weights(os.path.join(config.outdir, "cvae_weights"), params)
        save_train_state(
            os.path.join(config.outdir, "final_state"),
            {"params": params, "opt_state": opt_state, "epoch": config.epochs},
        )
        y_pred, _ = oos_eval(params)
        k = min(8, len(ho))
        save_panel(
            os.path.join(config.outdir, "oos_panel.png"),
            [
                np.asarray(y_ho[:k]).reshape(k, *dataset.image_shape),
                np.asarray(y_pred[:k]).reshape(k, *dataset.image_shape),
            ],
        )
    if own_log:
        log.close()
    return CVAETrainResult(params=params, config=config, history=history, model=model)


def main(argv=None):
    """CLI: the paper's CVAE comparison baseline as a standalone driver
    (reference `pysrc/faceplace/train_cvae.py`-style entry; SURVEY.md §2.1).
    Flags mirror train_vae where the models share a knob."""
    import argparse

    p = argparse.ArgumentParser(
        description="CVAE comparison baseline (view-conditioned VAE, no GP)"
    )
    p.add_argument("--data", default="synthetic",
                   help="rotated-digits source: synthetic | sklearn | mnist:<dir> | faces[:h5path] | npz:<path>")
    p.add_argument("--outdir", default="./out/cvae")
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
    p.add_argument("--beta_kl", type=float, default=1.0)
    p.add_argument("--sat_penalty", type=float, default=1.0,
                   help="logit saturation barrier weight (<=0 off)")
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
    config = CVAETrainConfig(
        zdim=args.zdim, epochs=args.epochs, batch_size=args.bs, lr=args.lr,
        seed=args.seed, sigma_y=args.sigma_y, beta_kl=args.beta_kl,
        sat_penalty=args.sat_penalty,
        compute_dtype=args.dtype, dec_upsample=args.dec_upsample,
        epochs_per_dispatch=args.epochs_per_dispatch,
        enc_features=tuple(int(f) for f in args.enc_features.split(",")),
        dec_features=tuple(int(f) for f in args.dec_features.split(",")),
        outdir=args.outdir,
    )
    train_cvae(ds, config)


if __name__ == "__main__":
    main()

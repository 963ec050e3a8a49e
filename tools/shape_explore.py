"""Model/data-shape exploration: how training efficiency moves with the
image size and channel count. Larger images (more spatial rows per conv)
and more channels (wider C_out) should both push the convs toward
tensor-core-bound shapes. This measures it on the card:

    python tools/shape_explore.py [--epochs 40] [--epd 20] [--out PATH]

Each variant trains the real fused GPPVAE-joint program for `--epochs`
epochs in the headline fast mode (bf16 + subpixel/dilated) and reports
median/min s/epoch, images/s, and analytic MFU (utils/flops.py — the same
accounting as bench.py, priced against bench.BF16_PEAK_FLOPS by
device_kind; an unknown kind gets none). Exploration evidence, NOT the
headline: variants change the benchmark shape.

Variants:
  digits32   P=400×Q=16 rotated digits, 32², C=1   (the headline shape)
  digits64   same grid at 64² — 4× conv rows per image
  faces64    P=100×Q=8 synthetic faces, 64², C=3
  faces128   P=50×Q=8 synthetic faces, 128², C=3   (bench config 4's shape)
  digits32c8 32² digits tiled to C=8 — a wider logit conv, same
             pixels-per-image information (channel-tiled copies)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

# runnable as `python tools/shape_explore.py` without a pip install (the
# other tools/ scripts carry the same bootstrap; its absence cost the
# first on-chip drive of this tool an instant ModuleNotFoundError)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def _tile_channels(ds, c: int):
    """Channel-tile a C=1 grid dataset to C=c (same images repeated across
    channels — an exploration shape, not a new task)."""
    images = np.repeat(ds.images, c, axis=-1)
    return dataclasses.replace(ds, images=images, name=f"{ds.name}-c{c}")


def _variants(seed: int):
    from gppvae_tpu.data import build_faceplace, build_rotated_digits

    d32 = build_rotated_digits("synthetic", num_objects=400, num_views=16,
                               image_size=32, seed=seed)
    yield "digits32", d32, dict(zdim=16, batch_size=128)
    yield "digits64", build_rotated_digits(
        "synthetic", num_objects=400, num_views=16, image_size=64, seed=seed,
    ), dict(zdim=16, batch_size=128)
    yield "faces64", build_faceplace(
        "synthetic", num_people=100, num_poses=8, image_size=64, seed=seed,
    ), dict(zdim=32, batch_size=64)
    yield "faces128", build_faceplace(
        "synthetic", num_people=50, num_poses=8, image_size=128, seed=seed,
    ), dict(zdim=32, batch_size=64)
    yield "digits32c8", _tile_channels(d32, 8), dict(zdim=16, batch_size=128)


def main(argv=None):
    p = argparse.ArgumentParser(description="GPPVAE shape exploration")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--epd", type=int, default=20, help="epochs per dispatch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--only", default=None,
                   help="comma-separated variant names to run")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    import jax

    from bench import mfu
    from gppvae_tpu.train import GPPVAETrainConfig, train_gppvae
    from gppvae_tpu.utils.flops import gppvae_epoch_flops
    from gppvae_tpu.utils.metrics import NullLogger

    only = set(args.only.split(",")) if args.only else None
    results = {}
    for name, ds, kw in _variants(args.seed):
        if only and name not in only:
            continue
        cfg = GPPVAETrainConfig(
            mode="joint", epochs=args.epochs, obj_feature_dim=8,
            view_num_freqs=3, seed=args.seed,
            epochs_per_dispatch=min(args.epd, args.epochs),
            compute_dtype="bfloat16", dec_upsample="subpixel", **kw,
        )
        t0 = time.perf_counter()
        res = train_gppvae(ds, cfg, log=NullLogger())
        wall = time.perf_counter() - t0
        skip = min(cfg.epochs_per_dispatch, args.epochs // 2)
        times = sorted(h["sec_epoch"] for h in res.history[skip:])
        sec = times[len(times) // 2]
        rank = cfg.obj_feature_dim * (2 * cfg.view_num_freqs + 1)
        fl = gppvae_epoch_flops(
            image_shape=ds.image_shape, enc_features=cfg.enc_features,
            dec_features=cfg.dec_features, zdim=cfg.zdim,
            n_train=len(ds.train_idx), n_heldout=len(ds.heldout_idx),
            batch_size=cfg.batch_size, rank=rank, upsample="subpixel",
        )
        results[name] = {
            "image_shape": list(ds.image_shape),
            "n_train": int(len(ds.train_idx)),
            "sec_epoch": round(sec, 4),
            "sec_epoch_min": round(times[0], 4),
            "images_per_sec": round(len(ds.train_idx) / sec),
            "flops_per_epoch": fl["total"],
            "achieved_tflops": round(fl["total"] / sec / 1e12, 2),
            "mfu_vs_bf16_peak": mfu(fl["total"] / sec,
                                    jax.devices()[0].device_kind),
            "oos_mse": round(res.history[-1]["oos_mse"], 5),
            "wall_s": round(wall, 1),
        }
        print(json.dumps({name: results[name]}), flush=True)

    line = json.dumps({"shape_explore": results})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()

"""Device time of the fused GPPVAE-joint epoch, read from a profiler trace.

    python tools/epoch_trace.py [--rank 56|256] [--epochs 25] [--warmup 3]
        [--dtype float32] [--upsample resize] [--out DIR]

Builds the paper's rotated-digits benchmark shape (P=400 x Q=16, 32x32,
zdim 16, bs 128; R=56 with the linear object kernel, R=256 with
`--object_kernel rbf --extra_effects object`), compiles the trainer's fused
one-epoch program, runs `--warmup` epochs, then traces `--epochs` epochs,
each inside a `jax.profiler.TraceAnnotation("epoch")` and ended by
`block_until_ready`. From the trace's device planes it reports, per epoch,
the device busy time (union of kernel intervals inside the epoch's host
window), its median, and the share of device time spent in kernels whose
names match each op family (the Cholesky and triangular-solve chain above
all). Prints one JSON object; run it on the card.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# op families, matched case-insensitively against each device event's
# kernel name and its string stats (the HLO op and instruction XLA records)
FAMILIES = {
    "cholesky": r"potrf|cholesky",
    "trsm": r"trsm|triangular",
}
# derived lines some profilers add beside the per-stream lines
_SKIP_LINES = {"XLA Modules", "XLA Ops", "Steps", "Source code",
               "XLA TraceMe", "TensorFlow Name Scope", "TensorFlow Ops"}


def _union(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_events(profile) -> list[tuple[str, float, float, str]]:
    """(name, start_ns, end_ns, stats text) of every kernel on the GPU
    device planes; the stats text joins the event's string-valued stats."""
    out = []
    for plane in profile.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name not in _SKIP_LINES]
        for line in lines:
            for ev in line.events:
                text = " ".join(str(v) for _, v in ev.stats
                                if isinstance(v, str))
                out.append((ev.name, ev.start_ns,
                            ev.start_ns + ev.duration_ns, text))
    return out


def host_windows(profile, name: str = "epoch") -> list[tuple[float, float]]:
    wins = []
    for plane in profile.planes:
        if not plane.name.startswith("/host"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.name == name:
                    wins.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    return sorted(wins)


def summarize(profile, n_epochs: int) -> dict:
    """Per-epoch device busy time and op-family shares of a traced run."""
    evs = device_events(profile)
    wins = host_windows(profile)
    per_epoch = []
    for s, e in wins:
        per_epoch.append(_union((a, b) for _, a, b, _ in evs
                                if a >= s and b <= e))
    busy_total = _union((a, b) for _, a, b, _ in evs)
    if not per_epoch or not any(per_epoch):
        per_epoch = [busy_total / max(n_epochs, 1)]
    by_name = collections.Counter()
    for n, a, b, _ in evs:
        by_name[n] += b - a
    kernel_total = sum(by_name.values()) or 1.0
    shares, members = {}, {}
    for fam, rx in FAMILIES.items():
        hit = [(n, b - a) for n, a, b, text in evs
               if re.search(rx, n + " " + text, re.I)]
        shares[fam] = sum(t for _, t in hit) / kernel_total
        members[fam] = sorted({n[:120] for n, _ in hit})[:10]
    span = (max(e[2] for e in evs) - min(e[1] for e in evs)) if evs else 0
    return {
        "n_windows": len(wins),
        "device_s_per_epoch_median": statistics.median(per_epoch) / 1e9,
        "device_s_per_epoch": [t / 1e9 for t in per_epoch],
        "busy_share_of_span": busy_total / span if span else None,
        "kernel_share": shares,
        "family_kernels": members,
        "top_kernels": [
            {"name": n[:160], "share": t / kernel_total}
            for n, t in by_name.most_common(25)
        ],
    }


def build(rank: int, dtype: str, upsample: str):
    """(dataset, config) of the benchmark shape at feature rank `rank`."""
    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.train import GPPVAETrainConfig

    ds = build_rotated_digits("synthetic", num_objects=400, num_views=16,
                              image_size=32, seed=0)
    kernel = {56: {}, 256: {"object_kernel": "rbf",
                            "extra_effects": ("object",)}}[rank]
    cfg = GPPVAETrainConfig(mode="joint", zdim=16, epochs=1, batch_size=128,
                            obj_feature_dim=8, view_num_freqs=3, seed=0,
                            compute_dtype=dtype, dec_upsample=upsample,
                            **kernel)
    return ds, cfg


def measure(rank: int = 56, epochs: int = 25, warmup: int = 3,
            dtype: str = "float32", upsample: str = "resize",
            out: str = "out/epoch_trace") -> dict:
    import jax
    from jax.profiler import ProfileData

    from gppvae_tpu.train.batching import epoch_keys
    from gppvae_tpu.train.train_gppvae import _Loop, _setup, make_optimizer

    ds, config = build(rank, dtype, upsample)
    model, params, fixed_W, a, rng, num_train = _setup(ds, config, None, None)
    ov = make_optimizer(config.lr_vae, config.clip_grad_norm)
    og = make_optimizer(config.lr_gp, config.clip_grad_norm)
    loop = _Loop(model, ov, og, config, num_train, None)
    fused = loop.make_fused_fn(1)
    state = (params, ov.init(params["vae"]), og.init(params["gp"]))

    def epoch(i, state):
        p, o1, o2 = state
        p, o1, o2, rows, _ = fused(
            p, o1, o2, fixed_W, a["images_tr"], a["d_tr"], a["q_tr"],
            a["y_ho"], a["d_ho"], a["q_ho"], epoch_keys(rng, i, 1),
            a["row_mask"])
        jax.block_until_ready(rows)
        return (p, o1, o2), rows

    t0 = time.perf_counter()
    state, _ = epoch(0, state)
    compile_s = time.perf_counter() - t0
    for i in range(1, warmup):
        state, _ = epoch(i, state)
    os.makedirs(out, exist_ok=True)
    walls = []
    with jax.profiler.trace(out):
        for i in range(warmup, warmup + epochs):
            t0 = time.perf_counter()
            with jax.profiler.TraceAnnotation("epoch"):
                state, rows = epoch(i, state)
            walls.append(time.perf_counter() - t0)
    paths = sorted(glob.glob(os.path.join(out, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    summary = summarize(ProfileData.from_file(paths[-1]), epochs)
    return {"rank": rank, "dtype": dtype, "upsample": upsample,
            "n_train": int(num_train), "epochs": epochs,
            "first_call_s": compile_s,
            "wall_s_per_epoch_median": statistics.median(walls),
            "loss_last": float(rows[0, 0]), **summary}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rank", type=int, default=56, choices=[56, 256])
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--upsample", default="resize")
    p.add_argument("--out", default="out/epoch_trace")
    args = p.parse_args(argv)
    print(json.dumps(measure(args.rank, args.epochs, args.warmup, args.dtype,
                             args.upsample, args.out)))


if __name__ == "__main__":
    main()

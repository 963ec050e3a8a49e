"""HLO copy audit for the fused GPPVAE program.

Copies inside the fused multi-epoch dispatch (scan-carry / donation
copies) cost device time without computing anything. This tool compiles the EXACT
headline program, parses the optimized HLO, and reports every copy /
copy-start instruction with its shape and byte count, grouped and ranked —
the evidence base for deciding which carried trees XLA fails to alias
(ROADMAP #2) and for proving (or disproving) an aliasing floor.

    python tools/hlo_audit.py [--out DIR] [--dtype bfloat16]
        [--upsample subpixel] [--epochs_per_dispatch 20] [--bs 128]

Writes <out>/fused.hlo.txt (full optimized HLO) and prints a JSON summary.
Platform-agnostic: runs on the default backend (the GPU where there is
one), the CPU with JAX_PLATFORMS=cpu (layout decisions differ — audit on
the card for real numbers).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """Bytes of the FIRST shape in an HLO shape string — handles both
    plain `f32[128,32,32,1]{3,2,1,0}` and the data element of a tuple
    `(f32[64,64]{1,0}, u32[])` (copy-start results)."""
    m = _SHAPE_RE.search(shape_str)
    if not m:
        return 0
    dtype, dims = m.groups()
    nbytes = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4, "pred": 1,
              "f16": 2, "s8": 1, "u8": 1, "f64": 8, "s64": 8, "u64": 8}
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * nbytes.get(dtype, 4)


def audit_hlo_text(hlo: str) -> dict:
    """Parse optimized HLO text; summarize copy ops by shape."""
    copies = collections.Counter()
    copy_bytes = collections.Counter()
    total = 0
    for line in hlo.splitlines():
        s = line.strip()
        # e.g.: %copy.1154 = f32[5700,16]{1,0} copy(%fusion.123)
        # or:   %cs.1 = (f32[64,64]{1,0}, u32[]) copy-start(%fusion.3)
        # tuple shapes contain SPACES, so the shape alternation must admit
        # a parenthesized group — \S+ alone silently dropped every
        # copy-start from the byte count (caught by tests/test_tools.py)
        m2 = re.match(r"%?([\w.-]+) = (\([^)]*\)|\S+) (copy|copy-start)\(", s)
        if m2:
            name, shape, kind = m2.groups()
            b = _shape_bytes(shape)  # tuple shapes: first (data) element
            key = f"{kind} {shape.split('{')[0]}"
            copies[key] += 1
            copy_bytes[key] += b
            total += b
    ranked = [
        {"op": k, "count": copies[k], "bytes": copy_bytes[k]}
        for k in sorted(copy_bytes, key=copy_bytes.get, reverse=True)
    ]
    return {"total_copy_bytes": total, "n_copy_ops": sum(copies.values()),
            "ranked": ranked[:25]}


def compile_fused(dtype: str, upsample: str, epd: int, bs: int,
                  num_objects: int = 400, num_views: int = 16):
    """Compile the exact benchmark fused program; returns (compiled, meta)."""
    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.train.batching import epoch_keys
    from gppvae_tpu.train.train_gppvae import (
        GPPVAETrainConfig, _Loop, _setup, make_optimizer,
    )

    ds = build_rotated_digits(
        "synthetic", num_objects=num_objects, num_views=num_views,
        image_size=32, seed=0,
    )
    config = GPPVAETrainConfig(
        mode="joint", zdim=16, epochs=epd, batch_size=bs,
        obj_feature_dim=8, view_num_freqs=3, seed=0,
        epochs_per_dispatch=epd, compute_dtype=dtype, dec_upsample=upsample,
    )
    model, params, fixed_W, a, rng, num_train = _setup(
        ds, config, None, None
    )
    # the trainer's REAL guarded optimizers (spike_guard), so the audited
    # HLO is the shipped program, not an unguarded approximation
    opt_vae = make_optimizer(config.lr_vae, config.clip_grad_norm)
    opt_gp = make_optimizer(config.lr_gp, config.clip_grad_norm)
    loop = _Loop(model, opt_vae, opt_gp, config, num_train, None)
    compiled = loop.make_fused_fn(epd).lower(
        params, opt_vae.init(params["vae"]), opt_gp.init(params["gp"]),
        fixed_W, a["images_tr"], a["d_tr"], a["q_tr"],
        a["y_ho"], a["d_ho"], a["q_ho"], epoch_keys(rng, 0, epd),
        a["row_mask"],
    ).compile()
    return compiled, {"n_train": num_train, "epochs_per_dispatch": epd,
                      "dtype": dtype, "upsample": upsample, "bs": bs}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="out/hlo_audit")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--upsample", default="subpixel")
    p.add_argument("--epochs_per_dispatch", type=int, default=20)
    p.add_argument("--bs", type=int, default=128)
    args = p.parse_args(argv)

    compiled, meta = compile_fused(
        args.dtype, args.upsample, args.epochs_per_dispatch, args.bs
    )
    hlo = compiled.as_text()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "fused.hlo.txt")
    with open(path, "w") as f:
        f.write(hlo)
    summary = {"meta": meta, "hlo_path": path, "hlo_lines": hlo.count("\n"),
               **audit_hlo_text(hlo)}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()

"""Capture + summarize a device trace of the fused GPPVAE dispatch.

A reproducible device-trace audit of the fused dispatch:

    python tools/trace_summary.py --out out/trace_fast \
        --dtype bfloat16 --upsample subpixel

Runs the benchmark-shape GPPVAE-joint config with jax.profiler tracing,
then parses a catapult-format trace (plugins/profile/<ts>/*.trace.json.gz)
whose device planes carry "XLA Modules" and "XLA Ops" threads:
per-dispatch device time of the dominant jit module, device occupancy inside the dispatch window (union of
non-`while` op intervals on the "XLA Ops" thread), and an op-category time
breakdown. Writes <out>/summary.json and a one-dispatch slice
<out>/dispatch_slice.trace.json.gz viewable in Perfetto.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _categorize(name: str) -> str:
    n = name.lower()
    if n.startswith("copy") or ".copy" in n or "copy-start" in n or "copy-done" in n:
        return "copy"
    if "convolution" in n:
        return "conv/dense"
    if re.search(r"\bdot\b|dot_general|loop_dot", n):
        return "conv/dense"
    if "convert" in n and ("reduce" in n or "fusion" in n):
        return "convert_reduce_fusion"
    if "multiply" in n or "add" in n or "subtract" in n or "divide" in n:
        return "multiply_add_fusion"
    if "fusion" in n:
        return "other_fusion"
    if "while" in n:
        return "while_wrapper"
    if "custom-call" in n or "custom_call" in n:
        return "custom_call"
    return "other"


def _union_len(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize_trace(trace_path: str) -> dict:
    with gzip.open(trace_path) as f:
        tr = json.load(f)
    ev = tr["traceEvents"]
    dev_pids = {
        e["pid"]
        for e in ev
        if e.get("ph") == "M"
        and e.get("name") == "process_name"
        and str(e["args"].get("name", "")).startswith("/device:")
    }
    tids = {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "thread_name" and e["pid"] in dev_pids:
            tids[(e["pid"], e["tid"])] = e["args"]["name"]
    modules = [
        e for e in ev
        if e.get("ph") == "X" and tids.get((e.get("pid"), e.get("tid"))) == "XLA Modules"
    ]
    ops = [
        e for e in ev
        if e.get("ph") == "X" and tids.get((e.get("pid"), e.get("tid"))) == "XLA Ops"
    ]
    if not modules:
        raise SystemExit(f"no 'XLA Modules' events in {trace_path}")
    # dominant module by total duration
    by_mod: dict[str, list] = {}
    for m in modules:
        by_mod.setdefault(m["name"], []).append(m)
    mod_name, wins = max(
        by_mod.items(), key=lambda kv: sum(w["dur"] for w in kv[1])
    )
    wins = sorted(wins, key=lambda w: w["ts"])
    dispatch_us = [w["dur"] for w in wins]
    mean_dispatch = sum(dispatch_us) / len(dispatch_us)

    cat_us: dict[str, float] = {}
    op_us: dict[str, float] = {}
    occ, occ_incl = [], []
    for w in wins:
        s, e = w["ts"], w["ts"] + w["dur"]
        inner = [
            o for o in ops if o["ts"] >= s and o["ts"] + o["dur"] <= e
        ]
        iv, iv_all = [], []
        for o in inner:
            iv_all.append((o["ts"], o["ts"] + o["dur"]))
            c = _categorize(o["name"])
            if c == "while_wrapper":
                continue  # wrapper spans its body; would double-count
            cat_us[c] = cat_us.get(c, 0.0) + o["dur"]
            op_us[o["name"]] = op_us.get(o["name"], 0.0) + o["dur"]
            iv.append((o["ts"], o["ts"] + o["dur"]))
        if w["dur"] > 0:
            occ.append(_union_len(iv) / w["dur"])
            occ_incl.append(_union_len(iv_all) / w["dur"])
    tot = sum(cat_us.values()) or 1.0
    top_ops = sorted(op_us.items(), key=lambda kv: -kv[1])[:12]
    return {
        "module": mod_name,
        "n_dispatches": len(wins),
        "device_time_per_dispatch_s": round(mean_dispatch / 1e6, 4),
        # two occupancy readings: the non-while union UNDERCOUNTS whenever
        # the profiler's event budget truncates inner ops of long scans
        # (while wrappers still span everything) — if the two disagree, the
        # wrapper-inclusive number is the honest one (BASELINE.md lesson)
        "device_occupancy_in_dispatch_pct": round(
            100 * sum(occ) / max(len(occ), 1), 1
        ),
        "device_busy_incl_while_pct": round(
            100 * sum(occ_incl) / max(len(occ_incl), 1), 1
        ),
        "op_breakdown_pct": {
            k: round(100 * v / tot, 1)
            for k, v in sorted(cat_us.items(), key=lambda kv: -kv[1])
        },
        "top_ops_pct": {k: round(100 * v / tot, 1) for k, v in top_ops},
        "_windows": [(w["ts"], w["dur"]) for w in wins],
    }


def slice_dispatch(trace_path: str, window: tuple[float, float], out_path: str):
    """Extract one dispatch window (device planes only) for Perfetto."""
    with gzip.open(trace_path) as f:
        tr = json.load(f)
    ev = tr["traceEvents"]
    dev_pids = {
        e["pid"]
        for e in ev
        if e.get("ph") == "M"
        and e.get("name") == "process_name"
        and str(e["args"].get("name", "")).startswith("/device:")
    }
    s, dur = window
    keep = [
        e for e in ev
        if (e.get("ph") == "M" and e["pid"] in dev_pids)
        or (
            e.get("ph") == "X"
            and e.get("pid") in dev_pids
            and s <= e["ts"] <= s + dur
        )
    ]
    with gzip.open(out_path, "wt") as f:
        json.dump({"traceEvents": keep, "displayTimeUnit": "ns"}, f)


def map_top_ops(summary: dict, args) -> dict:
    """Annotate top_ops with op_name/source metadata from the optimized HLO
    of the SAME program (round-3 second pass workflow, automated): compile
    the capture config via hlo_audit.compile_fused (real guarded
    optimizers — fusion numbering matches the traced program) and look
    each trace op name up in the HLO text. Names that don't resolve (e.g.
    a trace from a different config) map to null rather than erroring."""
    import re as _re

    from hlo_audit import compile_fused

    compiled, _meta = compile_fused(
        args.dtype, args.upsample, args.epd or 10, 128,
        num_objects=args.num_objects,
    )
    hlo = compiled.as_text()
    meta_re = _re.compile(
        r'op_name="([^"]*)"(?:.*?source_file="([^"]*)" source_line=(\d+))?'
    )
    mapped = {}
    for op in summary.get("top_ops_pct", {}):
        m = _re.search(
            rf"%{_re.escape(op)} = .*", hlo
        )
        if not m:
            mapped[op] = None
            continue
        mm = meta_re.search(m.group(0))
        if not mm:
            mapped[op] = {}
            continue
        op_name, src, line = mm.groups()
        # keep the informative tail of the jaxpr path
        mapped[op] = {
            "op_name": "/".join(op_name.split("/")[-3:]),
            "source": f"{src.split('/')[-1]}:{line}" if src else None,
        }
    return mapped


def capture(args) -> str:
    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.train import GPPVAETrainConfig, train_gppvae
    from gppvae_tpu.utils.metrics import NullLogger

    ds = build_rotated_digits(
        "synthetic", num_objects=args.num_objects, num_views=16,
        image_size=32, seed=0,
    )
    tmp = tempfile.mkdtemp(prefix="gppvae_trace_")
    cfg = GPPVAETrainConfig(
        mode="joint", zdim=16, epochs=args.epochs, batch_size=128,
        obj_feature_dim=8, view_num_freqs=3, seed=0,
        epochs_per_dispatch=args.epd, compute_dtype=args.dtype,
        dec_upsample=args.upsample, profile_dir=tmp,
    )
    train_gppvae(ds, cfg, log=NullLogger())
    paths = glob.glob(os.path.join(tmp, "**", "*.trace.json.gz"), recursive=True)
    if not paths:
        raise SystemExit(f"no trace written under {tmp}")
    return max(paths, key=os.path.getsize)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--trace", help="summarize an existing trace instead of capturing")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--upsample", default="resize", choices=["resize", "subpixel"])
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--num_objects", type=int, default=400,
                   help="grid objects for the capture run (N scaling probes)")
    p.add_argument("--epd", type=int, default=None,
                   help="epochs per dispatch (capture default: 10; with "
                        "--trace it must be given explicitly or per-epoch "
                        "numbers are omitted — the tool cannot know how an "
                        "external trace was captured)")
    p.add_argument("--slice_frac", type=float, default=None,
                   help="fraction of the dispatch window to slice for the "
                        "Perfetto artifact (default 1/epd = one epoch)")
    p.add_argument("--map_hlo", action="store_true",
                   help="recompile the capture config and annotate top_ops "
                        "with their HLO op_name + source file:line "
                        "(top_ops_source in summary.json)")
    args = p.parse_args()

    external = args.trace is not None
    if not external and args.epd is None:
        args.epd = 10
    trace_path = args.trace or capture(args)
    summary = summarize_trace(trace_path)
    windows = summary.pop("_windows")
    if args.epd is not None:
        summary["epochs_per_dispatch"] = args.epd
        summary["device_time_per_epoch_ms"] = round(
            1e3 * summary["device_time_per_dispatch_s"] / args.epd, 2
        )
    if external:
        # config flags describe a capture run, not someone else's trace
        summary["config"] = {"source": os.path.abspath(args.trace)}
    else:
        summary["config"] = {"dtype": args.dtype, "upsample": args.upsample}
    if args.map_hlo:
        summary["top_ops_source"] = map_top_ops(summary, args)
    os.makedirs(args.out, exist_ok=True)
    # slice a mid-run dispatch (first is the least warm); keep the artifact
    # small by default — one epoch's worth of the window
    frac = args.slice_frac or (1.0 / args.epd if args.epd else 1.0)
    ts, dur = windows[len(windows) // 2]
    slice_dispatch(trace_path, (ts, dur * frac),
                   os.path.join(args.out, "dispatch_slice.trace.json.gz"))
    summary["slice_fraction_of_dispatch"] = round(frac, 3)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()

"""The perf-audit tools are evidence generators for PERF.md claims — pin
their parsers so a refactor cannot silently change what the numbers
mean."""

import gzip
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO / "tools"))


def _synthetic_trace(path):
    """A catapult trace with one device plane: two dispatches of module
    `jit_fused` (1000 µs each) and one of a smaller module; inside each
    fused window a conv (400 µs), a fusion (300 µs), a custom call (100 µs)
    and a `while` wrapper spanning them."""
    ev = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
         "args": {"name": "XLA Modules"}},
        {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "/host:CPU"}},
    ]
    for t0 in (0.0, 5000.0):
        ev.append({"ph": "X", "pid": 1, "tid": 1, "name": "jit_fused",
                   "ts": t0, "dur": 1000.0})
        ev += [
            {"ph": "X", "pid": 1, "tid": 2, "name": "while.1", "ts": t0,
             "dur": 1000.0},
            {"ph": "X", "pid": 1, "tid": 2, "name": "convolution.3",
             "ts": t0 + 10, "dur": 400.0},
            {"ph": "X", "pid": 1, "tid": 2, "name": "fusion.7",
             "ts": t0 + 410, "dur": 300.0},
            {"ph": "X", "pid": 1, "tid": 2, "name": "custom-call.2",
             "ts": t0 + 800, "dur": 100.0},
        ]
    ev.append({"ph": "X", "pid": 1, "tid": 1, "name": "jit_small",
               "ts": 9000.0, "dur": 50.0})
    ev.append({"ph": "X", "pid": 9, "tid": 1, "name": "host_span",
               "ts": 0.0, "dur": 9999.0})
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)


def test_summarize_trace_on_committed_artifact(tmp_path):
    """summarize_trace on a synthetic trace: the dominant module, its
    per-dispatch device time, occupancy with and without the while
    wrapper, an op breakdown that sums to 100%, and a device-only slice."""
    from trace_summary import slice_dispatch, summarize_trace

    src = tmp_path / "t.trace.json.gz"
    _synthetic_trace(src)
    s = summarize_trace(str(src))
    assert s["module"] == "jit_fused"
    assert s["n_dispatches"] == 2
    assert s["device_time_per_dispatch_s"] == 0.001
    assert s["device_occupancy_in_dispatch_pct"] == 80.0
    assert s["device_busy_incl_while_pct"] == 100.0
    assert s["op_breakdown_pct"] == {
        "conv/dense": 50.0, "other_fusion": 37.5, "custom_call": 12.5,
    }
    out = tmp_path / "slice.json.gz"
    slice_dispatch(str(src), s["_windows"][0], str(out))
    kept = json.loads(gzip.open(out).read())["traceEvents"]
    assert all(e["pid"] == 1 for e in kept)
    assert sum(e.get("ph") == "X" for e in kept) == 5


def test_hlo_audit_copy_parser():
    from hlo_audit import audit_hlo_text

    hlo = "\n".join([
        "ENTRY %main {",
        "  %copy.1 = f32[128,32,32,1]{3,2,1,0} copy(%fusion.9)",
        "  %copy.2 = bf16[5700,16]{1,0} copy(%param.0)",
        "  %cs.1 = (f32[64,64]{1,0}, u32[]) copy-start(%fusion.3)",
        "  %notacopy = f32[8]{0} add(%a, %b)",
        "}",
    ])
    out = audit_hlo_text(hlo)
    assert out["n_copy_ops"] == 3
    # 128·32·32·1·4 + 5700·16·2 + 64·64·4
    assert out["total_copy_bytes"] == 128 * 32 * 32 * 4 + 5700 * 16 * 2 + 64 * 64 * 4
    kinds = {r["op"] for r in out["ranked"]}
    assert any(k.startswith("copy-start") for k in kinds)


def test_shape_explore_tiny_variants(tmp_path, capsys, monkeypatch):
    """shape_explore's measurement loop (variant build → train → stats →
    analytic MFU) on monkeypatched tiny variants, including the channel
    tiler; the real five-shape run is chip work."""
    import json

    import shape_explore
    from gppvae_tpu.data import build_rotated_digits

    def tiny(seed):
        ds = build_rotated_digits("synthetic", num_objects=8, num_views=8,
                                  image_size=32, seed=seed)
        kw = dict(zdim=8, batch_size=16, enc_features=(8, 16),
                  dec_features=(16, 8))
        yield "digits32", ds, kw
        yield "digits32c8", shape_explore._tile_channels(ds, 8), kw

    monkeypatch.setattr(shape_explore, "_variants", tiny)
    out = str(tmp_path / "shapes.json")
    shape_explore.main(["--epochs", "2", "--epd", "1", "--out", out])
    rec = json.loads(open(out).read())["shape_explore"]
    assert set(rec) == {"digits32", "digits32c8"}
    assert rec["digits32c8"]["image_shape"] == [32, 32, 8]
    for r in rec.values():
        assert r["sec_epoch"] > 0 and r["flops_per_epoch"] > 0
    # channel tiling must scale the analytic FLOPs up
    assert (rec["digits32c8"]["flops_per_epoch"]
            > rec["digits32"]["flops_per_epoch"])


def _art(value=0.016, sha="aaaa", sustained=50000, s_sha="bbbb",
         s_batch=200, dtype="float32", verdict="PASS", sec=0.047):
    """Minimal bench artifact for bench_diff tests."""
    return {
        "metric": "rotated_mnist_gppvae_joint_sec_per_epoch",
        "value": value, "unit": "s/epoch", "vs_baseline": None,
        "extra": {
            "program_sha1": sha,
            "configs": {
                "face_view_128": {
                    "sec_epoch": sec, "sec_epoch_min": sec,
                    "serving_sustained_b200_images_per_sec": sustained,
                    "serving_batch": s_batch,
                    "serving_program_sha1": s_sha, "model_dtype": dtype,
                },
                "face_accuracy_64": {"verdict": verdict},
            },
        },
    }


def test_bench_diff_same_program_regression_and_drift_band():
    """bench_diff applies the repo's arbitration discipline: same
    program_sha1 + wall beyond the band = regression; inside the band =
    run-to-run drift (ok); sha change = non-comparable, never a regression."""
    from bench_diff import diff

    base = _art()
    # inside the drift band: ok
    s = diff(base, _art(value=0.017))
    assert s["ok"] and not s["regressions"]
    # beyond the band, same sha: REGRESSION
    s = diff(base, _art(value=0.022))
    assert not s["ok"] and "program_sha1" in s["regressions"][0]
    # beyond the band, different sha: program changed -> non-comparable
    s = diff(base, _art(value=0.022, sha="cccc"))
    assert s["ok"] and s["non_comparable"]
    assert "trace" in s["non_comparable"][0]


def test_bench_diff_serving_identity_gates_comparison():
    """Serving rows compare only at equal (sha, dtype, batch) — the
    ADVICE round-4 #3 protocol rule, mechanised."""
    from bench_diff import diff

    base = _art()
    # slower at IDENTICAL serving identity: regression
    s = diff(base, _art(sustained=30000))
    assert not s["ok"] and "serving sustained" in s["regressions"][0]
    # slower but at a different batch: non-comparable, not a regression
    s = diff(base, _art(sustained=30000, s_batch=50))
    assert s["ok"]
    assert any("NOT comparable" in m for m in s["non_comparable"])
    # different precision likewise
    s = diff(base, _art(sustained=30000, dtype="bfloat16"))
    assert s["ok"] and any("NOT comparable" in m
                           for m in s["non_comparable"])


def test_bench_diff_verdict_flips_are_regressions():
    from bench_diff import diff

    base = _art()
    s = diff(base, _art(verdict="FAIL"))
    assert not s["ok"] and "PASS -> FAIL" in s["regressions"][0]
    s = diff(_art(verdict="FAIL"), _art())
    assert s["ok"] and not s["regressions"]


def test_bench_diff_loads_wrapper_logs_and_cli(tmp_path, capsys):
    """load_artifact accepts the raw artifact, the driver wrapper (parsed
    or tail), and a log whose last JSON line is the artifact; the CLI
    exits 0/1 by verdict."""
    import json as _json

    from bench_diff import load_artifact, main

    art = _art()
    raw = tmp_path / "raw.json"
    raw.write_text(_json.dumps(art))
    wrapped = tmp_path / "wrap.json"
    wrapped.write_text(_json.dumps(
        {"cmd": "python bench.py", "rc": 0, "parsed": [art], "n": 1}))
    tail = tmp_path / "tail.json"
    tail.write_text(_json.dumps(
        {"cmd": "python bench.py", "rc": 0, "parsed": None,
         "tail": "noise\n" + _json.dumps(art) + "\n"}))
    log = tmp_path / "run.log"
    log.write_text("INFO starting\n" + _json.dumps(art) + "\n")
    for p in (raw, wrapped, tail, log):
        assert load_artifact(str(p))["value"] == art["value"]
    assert main([str(raw), str(wrapped)]) == 0
    slow = tmp_path / "slow.json"
    slow.write_text(_json.dumps(_art(value=0.022)))
    assert main([str(raw), str(slow)]) == 1
    out = capsys.readouterr().out
    assert "REGRESSION" in out


def test_epoch_trace_summarize_synthetic_profile():
    """epoch_trace's reduction from xplane events: per-epoch device busy
    time inside each host `epoch` window (overlaps counted once), op
    families matched on kernel names and on the events' string stats, and
    derived module/op lines left out."""
    from types import SimpleNamespace as NS

    from epoch_trace import summarize

    def ev(name, start, dur, **stats):
        return NS(name=name, start_ns=start, duration_ns=dur,
                  stats=list(stats.items()))

    stream = NS(name="Stream #7", events=[
        ev("sm90_gemm", 100, 400),
        ev("void potrf_kernel", 450, 100),           # overlaps the gemm
        ev("fusion_3", 2100, 300, hlo_op="custom-call.4 triangular-solve"),
        ev("fusion_9", 2500, 200),
    ])
    derived = NS(name="XLA Ops", events=[ev("fusion_3", 2100, 300)])
    device = NS(name="/device:GPU:0", lines=[stream, derived])
    host = NS(name="/host:CPU", lines=[NS(name="python", events=[
        ev("epoch", 0, 1000), ev("epoch", 2000, 1000)])])
    s = summarize(NS(planes=[host, device]), 2)
    assert s["n_windows"] == 2
    assert s["device_s_per_epoch"] == [450e-9, 500e-9]
    assert s["device_s_per_epoch_median"] == 475e-9
    assert s["kernel_share"] == {"cholesky": 0.1, "trsm": 0.3}
    assert s["family_kernels"]["trsm"] == ["fusion_3"]
    assert s["top_kernels"][0] == {"name": "sm90_gemm", "share": 0.4}
    assert s["busy_share_of_span"] == 950 / 2600

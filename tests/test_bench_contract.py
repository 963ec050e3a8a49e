"""bench.py artifact contract, pinned WITHOUT running the heavy benchmark
itself (trainers are stubbed):

  * a non-headline config failure degrades to an {"error": …} entry — the
    final JSON line still prints with the headline metric — and the
    process then exits non-zero;
  * the headline value is the median of post-compile epochs;
  * _require_gpu gates entry (stubbed OK here);
  * MFU is priced only against a device_kind in the peak table.
"""

import json

import numpy as np
import pytest


class _FakeRes:
    def __init__(self, n_epochs, sec=0.015):
        self.history = [
            {"sec_epoch": sec + 0.001 * (i % 3), "oos_mse": 0.001,
             "mse": 0.002, "loss": 1.0}
            for i in range(n_epochs)
        ]
        # no .model/.params → downstream serving/oos blocks raise inside
        # _safe and must degrade to error entries, not kill the run


class _FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"

    def __str__(self):
        return "cuda:0"


def test_bench_emits_artifact_despite_subconfig_failures(monkeypatch, capsys):
    import bench
    import gppvae_tpu.train as tr

    monkeypatch.setattr(bench, "_require_gpu", lambda: _FakeDevice())
    monkeypatch.setattr(bench, "_card_info", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(
        tr, "train_vae",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("device lost")),
    )
    monkeypatch.setattr(tr, "train_gppvae",
                        lambda ds, cfg, **k: _FakeRes(cfg.epochs))
    # keep the hash cheap/irrelevant (fetch the MODULE via sys.modules —
    # the package attr of the same name is the function patched above)
    import importlib
    import sys as _sys

    importlib.import_module("gppvae_tpu.train.train_gppvae")
    tg = _sys.modules["gppvae_tpu.train.train_gppvae"]
    monkeypatch.setattr(tg, "fused_epoch_program_hash",
                        lambda *a, **k: "deadbeefdeadbeef")
    # the accuracy block runs the full validate protocol — stub it
    import validate

    monkeypatch.setattr(validate, "run_validation",
                        lambda **kw: {"verdict": "STUBBED"})

    with pytest.raises(SystemExit, match="configs failed"):
        bench.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)

    assert rec["metric"] == "rotated_mnist_gppvae_joint_sec_per_epoch"
    # median of the fake post-compile epochs: sec in {0.015, 0.016, 0.017}
    assert rec["value"] == pytest.approx(0.016, abs=1e-9)
    cfgs = rec["extra"]["configs"]
    assert "error" in cfgs["vae_pretrain"], "failed config must be recorded"
    # downstream consumers of the fake result objects degrade, not crash
    assert "error" in cfgs["oos_generation"]
    assert "error" in cfgs["oos_serving"]
    # healthy configs still report numbers
    assert cfgs["gppvae_joint"]["sec_epoch_min"] == 0.015
    assert np.isfinite(cfgs["gppvae_joint"]["oos_mse"])
    assert rec["extra"]["program_sha1"] == "deadbeefdeadbeef"
    assert rec["extra"]["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert rec["extra"]["platform"] == "gpu"
    assert 0 < rec["extra"]["mfu"]["mfu_vs_bf16_peak"] < 1


def test_bench_sec_stats_distribution():
    import bench

    hist = [{"sec_epoch": s} for s in (9.0, 9.0, 0.03, 0.01, 0.02)]
    stats = bench._sec_stats(hist, skip=2)
    assert stats == {"sec_epoch": 0.02, "sec_epoch_min": 0.01,
                     "sec_epoch_spread": 0.02}


def test_await_backend_rejects_cpu_fallback(monkeypatch):
    """The bench refuses a non-GPU backend in-process and fast: a CPU-timed
    headline is exactly the misleading artifact the check exists to
    prevent."""
    import jax

    import bench

    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(SystemExit, match="not 'gpu'"):
        bench._require_gpu()


def test_await_backend_accepts_device_backend(monkeypatch):
    """A GPU backend passes the check and hands back the first device."""
    import jax

    import bench

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice()])
    assert bench._require_gpu().device_kind == "NVIDIA H100 80GB HBM3"


def test_mfu_unknown_device_kind_has_no_peak():
    """An unknown device_kind gets no MFU (None), never a guessed peak; a
    known one is priced against its data-sheet rate."""
    import bench

    assert bench.mfu(1e12, "NVIDIA A100-SXM4-80GB") is None
    assert bench.mfu(1e12, "cpu") is None
    assert bench.mfu(98.9e12, "NVIDIA H100 80GB HBM3") == 0.1

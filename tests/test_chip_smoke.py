"""chip_smoke.py's contract, checked off the card: it refuses a non-GPU
backend and a directory without the package, `--multi` runs the mesh phase
alone, the last line is the result object, and its float64 references are
right."""

import json
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
    )


def _no_result(stdout):
    return not any(line.startswith("{") and '"ok"' in line
                   for line in stdout.splitlines())


def test_refuses_a_cpu_backend():
    r = _run(REPO)
    assert r.returncode != 0
    assert "not 'gpu'" in r.stderr
    assert _no_result(r.stdout)


def test_refuses_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path)
    assert r.returncode != 0
    assert _no_result(r.stdout)


class _Card:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def _stub_phases(monkeypatch):
    calls = []

    def rec(name):
        def f(*a, **k):
            calls.append(name)
            return {}
        return f

    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda n: calls.append(("device", n)) or _Card())
    for name in ("phase_train", "phase_serve", "phase_gp_reference",
                 "phase_net_reference", "phase_multi"):
        monkeypatch.setattr(chip_smoke, name, rec(name))
    return calls


def test_multi_runs_only_the_mesh_phase(monkeypatch, capsys):
    calls = _stub_phases(monkeypatch)
    chip_smoke.main(["--multi"])
    assert calls == [("device", 4), "phase_multi"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_one_card_runs_train_serve_reference(monkeypatch, capsys):
    calls = _stub_phases(monkeypatch)
    chip_smoke.main([])
    assert calls == [("device", 1), "phase_train", "phase_serve",
                     "phase_gp_reference", "phase_net_reference"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == 1 and last["ok"] is True


def test_failed_check_raises():
    with pytest.raises(chip_smoke.SmokeFailure, match="loss did not fall"):
        chip_smoke.check_training("x", [{"loss": 2.0}, {"loss": 3.0}], 2,
                                  oos=False)
    with pytest.raises(chip_smoke.SmokeFailure, match="non-finite"):
        chip_smoke.check_training("x", [{"loss": 2.0, "oos_mse": 1.0},
                                        {"loss": float("nan"),
                                         "oos_mse": 0.5}], 2)


def test_float64_references_match_autodiff():
    """gp_reference's closed-form NLL and dNLL/dU and the dense oracle
    agree with float64 autodiff through the package's ops."""
    from gppvae_tpu import ops

    rng = np.random.default_rng(0)
    U = rng.normal(size=(300, 12)) / 3
    Z = rng.normal(size=(300, 4))
    ref = chip_smoke.gp_reference(U, Z, 0.5)

    def nll(u):
        G, UtZ, zn = ops.factor_prep(u, jnp.asarray(Z))
        return ops.woodbury_nll_core(G, UtZ, zn, jnp.float64(0.5), 300, 4)

    val, grad = jax.value_and_grad(nll)(jnp.asarray(U))
    np.testing.assert_allclose(float(val), ref["nll"], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(grad), ref["dU"], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(chip_smoke.dense_nll64(U, Z, 0.5), ref["nll"],
                               rtol=1e-12)
    assert chip_smoke._relerr(ref["G"], U.T @ U) == 0.0

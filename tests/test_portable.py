"""The main path needs only JAX, numpy and optax: the .npz checkpoint
format, the stdlib PNG writer, and the imports of the training and serving
entry points with the optional packages blocked."""

import os
import pathlib
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gppvae_tpu.checkpoint import (
    CheckpointFormatError,
    load_pytree,
    load_train_state,
    save_pytree,
    save_train_state,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
_OPTIONAL = ("flax", "orbax", "PIL", "matplotlib", "h5py", "sklearn")


def _state():
    from gppvae_tpu.train.train_gppvae import make_optimizer

    params = {"vae": {"w": jnp.arange(6.0).reshape(2, 3)},
              "gp": {"log_vs": jnp.zeros((2,)), "X": jnp.ones((4, 2))}}
    ov = make_optimizer(1e-3, 1e5, grad_accum_steps=2)  # MultiSteps(spike_guard(adam))
    og = make_optimizer(1e-3)
    return {"params": params, "ov_state": ov.init(params["vae"]),
            "og_state": og.init(params["gp"]),
            "half": jnp.asarray([1.5, -2.25], jnp.bfloat16), "epoch": 7}


def test_npz_train_state_roundtrip_with_optax_states(tmp_path):
    state = _state()
    path = str(tmp_path / "run" / "final_state")
    save_train_state(path, state)
    assert os.path.isfile(path) and os.path.isfile(path + ".format.json")
    abstract = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype) if hasattr(x, "shape")
        else x, state)
    back = load_train_state(path, abstract)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    assert back["epoch"] == 7 and isinstance(back["epoch"], int)
    assert type(back["ov_state"]) is type(state["ov_state"])  # NamedTuple kept
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert jnp.asarray(a).dtype == jnp.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))


def test_npz_load_without_abstract_tree_gives_nested_dicts(tmp_path):
    path = str(tmp_path / "p")
    save_pytree(path, {"a": {"b": jnp.ones((2,)), "c": jnp.zeros((1, 3))}})
    back = load_pytree(path)
    assert set(back) == {"a"} and set(back["a"]) == {"b", "c"}
    assert back["a"]["c"].shape == (1, 3)


def test_npz_tree_mismatch_is_a_named_error(tmp_path):
    state = _state()
    path = str(tmp_path / "final_state")
    save_train_state(path, state)
    bad = dict(state, params={**state["params"], "vae": {"w": jnp.zeros((3, 3))}})
    with pytest.raises(CheckpointFormatError, match="does not match"):
        load_train_state(path, bad)
    with pytest.raises(CheckpointFormatError, match="does not match"):
        load_train_state(path, {k: v for k, v in state.items() if k != "half"})


def test_orbax_era_checkpoint_raises_named_error(tmp_path):
    """A v3 checkpoint is an orbax directory: loading it names the format
    instead of failing inside numpy."""
    old = tmp_path / "final_state"
    old.mkdir()
    (old / "_METADATA").write_text("{}")
    (tmp_path / "final_state.format.json").write_text('{"format_version": 3}')
    with pytest.raises(CheckpointFormatError, match="orbax checkpoint"):
        load_train_state(str(old), _state())
    with pytest.raises(CheckpointFormatError, match="orbax checkpoint"):
        load_pytree(str(old))


def _read_png(path):
    data = pathlib.Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    ch = {0: 1, 2: 3}[color]
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + w * ch)
    assert depth == 8 and not rows[:, 0].any()  # filter type 0 everywhere
    return rows[:, 1:].reshape(h, w, ch) if ch == 3 else rows[:, 1:]


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)])
def test_png_writer_reads_back_through_zlib(tmp_path, shape):
    from gppvae_tpu.eval.panels import write_png

    arr = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), arr)
    np.testing.assert_array_equal(_read_png(path), arr)


def test_save_panel_png_grid(tmp_path):
    from gppvae_tpu.eval.panels import save_panel

    rows = [np.full((3, 8, 8, 1), 0.5), np.ones((3, 8, 8, 1))]
    path = tmp_path / "p.png"
    save_panel(str(path), rows, pad=2)
    img = _read_png(path)
    assert img.ndim == 2 and img.shape[1] >= 3 * 8 and img.shape[0] >= 2 * 8
    assert img.max() == 255


def _run_blocked(code, blocked=_OPTIONAL):
    """Run `code` in a fresh interpreter where importing any of the
    `blocked` top-level packages raises ImportError."""
    blocker = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {tuple(blocked)!r}:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
    )
    return subprocess.run(
        [sys.executable, "-c", blocker + code], capture_output=True,
        text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": str(REPO)},
    )


def test_main_path_imports_without_optional_packages():
    r = _run_blocked(
        "import gppvae_tpu.train, gppvae_tpu.eval.serving\n"
        "import gppvae_tpu.eval.generate, gppvae_tpu.data, gppvae_tpu.checkpoint\n"
        f"blocked = [m for m in sys.modules if m.split('.')[0] in {_OPTIONAL!r}]\n"
        "assert not blocked, blocked\n"
        "print('ok')\n"
    )
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_side_paths_name_their_missing_package(tmp_path):
    r = _run_blocked(
        "from gppvae_tpu.eval.plots import plot_history\n"
        "try:\n"
        f"    plot_history({str(tmp_path / 'metrics.jsonl')!r})\n"
        "except ImportError as e:\n"
        "    print(e)\n"
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "'matplotlib'" in r.stdout and "plotting" in r.stdout


def test_exported_program_roundtrip_without_flatbuffers():
    """Serving programs serialize and load with flatbuffers blocked: the
    symbolic batch dim, dict/tuple/None outputs and a registered NamedTuple
    argument survive, and the loaded program answers like the function."""
    r = _run_blocked("""
import jax, jax.numpy as jnp, numpy as np
from jax import export as jexport
from gppvae_tpu import gp
from gppvae_tpu.eval import exported_io
from gppvae_tpu.eval.serving import _ensure_core_serialization
_ensure_core_serialization()
core = gp.PosteriorCore(M=jnp.ones((3, 2)), G=jnp.eye(3), Lb=jnp.eye(3),
                        v_noise=jnp.float32(0.5))
def f(c, d):
    y = d[:, None] * c.M.sum() + c.v_noise
    return {"y": y, "t": (y.sum(), None)}
b, = jexport.symbolic_shape("b")
spec = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), core)
exp = jexport.export(jax.jit(f), platforms=("cuda", "cpu"))(
    spec, jax.ShapeDtypeStruct((b,), jnp.float32))
back = exported_io.deserialize(exported_io.serialize(exp))
assert back.platforms == ("cuda", "cpu") and back.in_tree == exp.in_tree
for n in (3, 5):
    d = jnp.arange(n, dtype=jnp.float32)
    got, want = back.call(core, d), f(core, d)
    np.testing.assert_allclose(got["y"], want["y"])
    assert got["t"][1] is None
assert "flatbuffers" not in sys.modules
try:
    exported_io.deserialize(b"not a blob")
except ValueError as e:
    assert "re-export" in str(e)
print("ok")
""", blocked=("flatbuffers",))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]

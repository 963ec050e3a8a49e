"""Checkpoint/resume (SURVEY.md §5): a run interrupted at epoch k and
resumed from its state checkpoint must continue (not restart), and the
standalone out-of-sample generation CLI must work from a final_state."""

import json

import numpy as np

from gppvae_tpu.data import build_rotated_digits
from gppvae_tpu.train import GPPVAETrainConfig, train_gppvae


def _cfg(**kw):
    base = dict(
        mode="joint", zdim=8, epochs=2, batch_size=16, lr_gp=5e-3,
        obj_feature_dim=4, view_num_freqs=2,
        enc_features=(8, 16), dec_features=(16, 8),
    )
    base.update(kw)
    return GPPVAETrainConfig(**base)


def test_resume_is_trajectory_preserving(tmp_path):
    """Interrupted-at-k + resumed must equal the UNINTERRUPTED run epoch by
    epoch: full state (params + both Adam states) restores exactly and the
    per-epoch RNG stream is keyed by absolute epoch (batching.epoch_keys),
    so nothing distinguishes the two runs."""
    ds = build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=0)
    full = train_gppvae(ds, _cfg(epochs=4))

    out1 = str(tmp_path / "run1")
    train_gppvae(ds, _cfg(epochs=2, outdir=out1))
    r2 = train_gppvae(ds, _cfg(epochs=4, resume=out1 + "/final_state"))

    # resumed run executes only epochs 2..3
    assert [h["epoch"] for h in r2.history] == [2, 3]
    for h_res, h_full in zip(r2.history, full.history[2:]):
        for key in ("loss", "recon_term", "gp_term", "pen_term",
                    "gp_nll_full", "oos_mse"):
            np.testing.assert_allclose(
                h_res[key], h_full[key], rtol=1e-5,
                err_msg=f"epoch {h_full['epoch']} {key!r} diverged on resume",
            )


def test_resume_mid_polish_preserves_trajectory(tmp_path):
    """A resume landing INSIDE the f32 polish window must keep the
    checkpoint's optimizer states: the Adam restart at the precision switch
    already happened before that checkpoint was written, and re-running it
    would diverge the trajectory (round-3 VERDICT weak #2 / ADVICE).
    Also covers the boundary case: resuming from the bulk/polish switch
    itself must still fire the restart."""
    ds = build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=0)
    kw = dict(epochs=4, compute_dtype="bfloat16", polish_epochs=2)
    out = str(tmp_path / "full")
    # bulk = epochs 0..1, polish = epochs 2..3; checkpoint_every=1 writes
    # state_0001/0002/0003 — 0002 is the switch boundary, 0003 is mid-polish
    full = train_gppvae(ds, _cfg(**kw, outdir=out, checkpoint_every=1))

    mid = train_gppvae(ds, _cfg(**kw, resume=out + "/state_0003"))
    assert [h["epoch"] for h in mid.history] == [3]
    boundary = train_gppvae(ds, _cfg(**kw, resume=out + "/state_0002"))
    assert [h["epoch"] for h in boundary.history] == [2, 3]

    for resumed, offset, name in ((mid, 3, "mid-polish"),
                                  (boundary, 2, "boundary")):
        for h_res, h_full in zip(resumed.history, full.history[offset:]):
            for key in ("loss", "recon_term", "gp_term", "pen_term",
                        "gp_nll_full", "oos_mse"):
                np.testing.assert_allclose(
                    h_res[key], h_full[key], rtol=1e-5,
                    err_msg=f"epoch {h_full['epoch']} {key!r} diverged on "
                            f"{name} resume",
                )


def test_resume_preserves_trajectory_across_dispatch_sizes(tmp_path):
    """epochs_per_dispatch must not change the math either — the same
    absolute-epoch keys drive every dispatch split."""
    ds = build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=0)
    a = train_gppvae(ds, _cfg(epochs=4, epochs_per_dispatch=1))
    b = train_gppvae(ds, _cfg(epochs=4, epochs_per_dispatch=4))
    for ha, hb in zip(a.history, b.history):
        np.testing.assert_allclose(ha["loss"], hb["loss"], rtol=1e-5)
        np.testing.assert_allclose(ha["oos_mse"], hb["oos_mse"], rtol=1e-5)


def test_checkpoint_format_version_sidecar(tmp_path):
    """Round-4 (VERDICT round-3 weak #4): every saved train state records
    FORMAT_VERSION in a .format.json sidecar; a version mismatch raises the
    NAMED CheckpointFormatError instead of a raw structure error."""
    import pytest as _pytest

    from gppvae_tpu.checkpoint import CheckpointFormatError, FORMAT_VERSION

    ds = build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=0)
    out = str(tmp_path / "run")
    train_gppvae(ds, _cfg(outdir=out))
    sidecar = out + "/final_state.format.json"
    assert json.load(open(sidecar))["format_version"] == FORMAT_VERSION

    json.dump({"format_version": 1}, open(sidecar, "w"))
    with _pytest.raises(CheckpointFormatError, match="format_version=1"):
        train_gppvae(ds, _cfg(epochs=3, resume=out + "/final_state"))

    # a truncated sidecar (partial write during a crash) gets the same
    # named error, not a raw JSONDecodeError (round-4 review)
    with open(sidecar, "w") as f:
        f.write('{"format_ver')
    with _pytest.raises(CheckpointFormatError, match="unreadable"):
        train_gppvae(ds, _cfg(epochs=3, resume=out + "/final_state"))


def test_old_format_checkpoint_raises_named_error(tmp_path):
    """A pre-round-3 state tree (plain optax.adam optimizer states, no
    spike_guard wrapper, no sidecar) must fail with the named
    CheckpointFormatError explaining the format history — not an opaque
    structure traceback."""
    import optax
    import pytest as _pytest

    from gppvae_tpu.checkpoint import CheckpointFormatError, save_pytree

    ds = build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=0)
    res = train_gppvae(ds, _cfg())
    # synthesize the v2 (rounds 1-2) layout: un-guarded Adam states
    old = {
        "params": res.params,
        "ov_state": optax.adam(2e-4).init(res.params["vae"]),
        "og_state": optax.adam(5e-3).init(res.params["gp"]),
        "epoch": 2,
    }
    path = str(tmp_path / "old_state")
    save_pytree(path, old)  # no sidecar — mimics a pre-round-4 artifact
    with _pytest.raises(CheckpointFormatError, match="spike_guard"):
        train_gppvae(ds, _cfg(epochs=3, resume=path))


def test_generate_cli_from_final_state(tmp_path, capsys):
    ds_args = dict(num_objects=12, num_views=8, seed=0)
    out = str(tmp_path / "run")
    ds = build_rotated_digits("synthetic", **ds_args)
    train_gppvae(ds, _cfg(outdir=out))

    from gppvae_tpu.eval.generate import main

    main([
        "--state", out + "/final_state",
        "--data", "synthetic",
        "--num_objects", "12", "--num_views", "8",
        "--outdir", out,
    ])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert np.isfinite(rec["heldout_mse"])
    assert rec["n_heldout"] == 12
    assert (tmp_path / "run" / "oos_panel.png").exists()


def test_generate_cli_dis_mode_fixed_W_roundtrip(tmp_path, capsys):
    """dis-mode checkpoints carry fixed_W; generate must rebuild the same
    view kernel from the saved state."""
    ds = build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=0)
    out = str(tmp_path / "dis")
    train_gppvae(ds, _cfg(mode="dis", outdir=out))

    from gppvae_tpu.eval.generate import main

    main([
        "--state", out + "/final_state",
        "--data", "synthetic", "--num_objects", "12", "--num_views", "8",
        "--outdir", out,
    ])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(rec["heldout_mse"])


def test_generate_cli_views_and_samples(tmp_path, capsys):
    ds = build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=0)
    out = str(tmp_path / "run")
    train_gppvae(ds, _cfg(outdir=out))

    from gppvae_tpu.eval.generate import main

    common = ["--state", out + "/final_state", "--data", "synthetic",
              "--num_objects", "12", "--num_views", "8", "--outdir", out]
    main([*common, "--object", "3"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["object"] == 3
    assert (tmp_path / "run" / "views_obj3.png").exists()

    main([*common, "--sample", "6"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n"] == 6
    assert (tmp_path / "run" / "prior_samples.png").exists()

    # posterior sampling: K decoded draws from N(μ*, σ*²) of one cell, with
    # a finite positive predictive variance reported
    main([*common, "--posterior_sample", "5", "--object", "3", "--view", "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n"] == 5 and rec["object"] == 3 and rec["view"] == 2
    assert np.isfinite(rec["posterior_var"]) and rec["posterior_var"] > 0
    panel = tmp_path / "run" / "posterior_obj3_view2.png"
    assert panel.exists()
    # all K=5 sample columns must render (save_panel truncates rows to the
    # SHORTEST row, so a 1-image truth row would silently drop 4 draws)
    import struct

    w = struct.unpack(">I", panel.read_bytes()[16:20])[0]  # IHDR width
    assert w >= 5 * 32, f"panel width {w}: sample columns were truncated"

    # joint sweep: K COHERENT draws over the object's full view row from
    # the exact Q×Q posterior covariance — one panel row per draw, a
    # per-view variance vector reported
    main([*common, "--posterior_sample", "3", "--object", "3", "--joint"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n"] == 3 and rec["object"] == 3
    assert len(rec["posterior_var"]) == 8
    assert all(np.isfinite(v) and v > 0 for v in rec["posterior_var"])
    sweep = tmp_path / "run" / "posterior_sweep_obj3.png"
    assert sweep.exists()
    w, h = struct.unpack(">II", sweep.read_bytes()[16:24])  # IHDR
    assert w >= 8 * 32 and h >= 4 * 32, (w, h)  # truth + 3 draws × 8 views

    # --draw_seed varies ONLY the draws (the feature-map seed — which must
    # match training on rbf kernels — stays put): a new draw_seed changes
    # the samples, the same one reproduces them, and the default equals
    # the legacy seed-tied behavior
    # this CLI writes panels (not npz) — compare the panel pixel bytes
    def _panel_bytes(extra):
        main([*common, "--posterior_sample", "4", "--object", "3",
              "--view", "2", *extra])
        capsys.readouterr()
        return (tmp_path / "run" / "posterior_obj3_view2.png").read_bytes()

    default = _panel_bytes([])
    legacy = _panel_bytes(["--draw_seed", "0"])  # training seed is 0
    fresh = _panel_bytes(["--draw_seed", "123"])
    fresh2 = _panel_bytes(["--draw_seed", "123"])
    assert default == legacy, "draw_seed default must equal the legacy draws"
    assert fresh == fresh2, "equal draw_seed must reproduce"
    assert fresh != default, "a new draw_seed must change the draws"

    # --joint without --posterior_sample is an error, not a silent no-op
    import pytest

    with pytest.raises(SystemExit):
        main([*common, "--joint"])


def test_generate_cli_defaults_dataset_from_sidecar(tmp_path, capsys):
    """A run trained with a non-default seed evaluated WITHOUT dataset flags
    must rebuild the run's own data from the sidecar config.json — not a
    different seed-0 dataset of identical grid shape (ADVICE.md round-1)."""
    ds = build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=5)
    out = str(tmp_path / "run")
    train_gppvae(ds, _cfg(outdir=out, seed=5))

    from gppvae_tpu.eval.generate import main

    main(["--state", out + "/final_state", "--outdir", out])
    implicit = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    main(["--state", out + "/final_state", "--data", "synthetic",
          "--num_objects", "12", "--num_views", "8", "--seed", "5",
          "--outdir", out])
    explicit = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert implicit["heldout_mse"] == explicit["heldout_mse"]
    assert implicit["n_heldout"] == 12


def test_generate_cli_rejects_mismatched_grid(tmp_path):
    ds = build_rotated_digits("synthetic", num_objects=12, num_views=8, seed=0)
    out = str(tmp_path / "run")
    train_gppvae(ds, _cfg(outdir=out))

    import pytest as _pytest

    from gppvae_tpu.eval.generate import main

    with _pytest.raises(ValueError, match="does not match the checkpoint"):
        main([
            "--state", out + "/final_state",
            "--data", "synthetic",
            "--num_objects", "24", "--num_views", "8",  # wrong grid
        ])

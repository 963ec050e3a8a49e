"""Smoke test of the GPU path: train and serve GPPVAE through the CLIs on one
card, and compare the GP hot ops and the conv nets with plain references at
real widths.

    python chip_smoke.py           # one card: device, train, serve, reference
    python chip_smoke.py --multi   # four cards: mesh runs vs one card, wire audit

Everything runs in this one process (one JAX process per card). The data is
the synthetic rotated-digits grid of the paper's benchmark shape (P=400
objects x Q=16 views, 32x32x1, zdim 16, bs 128, R=56) and a synthetic
face-view grid at 128x128x3, built from the seed, so nothing is downloaded.
Each phase prints its key numbers on `#` lines. The first failed check
raises, so the exit code is non-zero and no result line is printed; the same
holds when JAX finds no GPU, or when the package is not beside this file.
The last line of stdout is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the paper's rotated-MNIST benchmark configuration (bench.py, BASELINE.json)
DIGITS = ["--data", "synthetic", "--num_objects", "400", "--num_views", "16",
          "--zdim", "16", "--bs", "128", "--seed", "0"]
# the face-view configuration of bench.py config 4, at 128x128
FACES = ["--data", "faces", "--num_objects", "50", "--num_views", "8",
         "--image_size", "128", "--zdim", "32", "--bs", "64", "--seed", "0",
         "--dec_upsample", "subpixel"]
# tolerances of the reference comparison (norm-wise relative errors)
HIGHEST_TOL = {"G": 1e-5, "UtZ": 1e-5, "zn": 1e-6, "nll": 1e-6, "dU": 1e-4}
# a float32 dot at default precision may run as TF32 (10-bit mantissa)
DEFAULT_TOL = 5e-3
NET_TOL = 1e-4
EXE_ATOL = 1e-4


class SmokeFailure(RuntimeError):
    """A check of the smoke test failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def note(msg: str) -> None:
    print(f"# {msg}", flush=True)


def _import_package():
    """The package beside this file, never an installed copy."""
    if not os.path.isdir(os.path.join(REPO, "gppvae_tpu")):
        raise SystemExit(
            f"chip_smoke: no gppvae_tpu package beside {__file__}; run it "
            "from a checkout of the repository"
        )
    sys.path.insert(0, REPO)
    import gppvae_tpu

    return gppvae_tpu


# ---------------------------------------------------------------- device


def phase_device(n_cards: int):
    """Refuse anything but a GPU backend with `n_cards` cards; print the
    card's name and power limit, its JAX kind, the JAX version and the
    compile cache in use."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX backend is {backend!r}, not 'gpu'; this test "
            "runs only on the card"
        )
    devices = jax.devices()
    check(len(devices) >= n_cards,
          f"need {n_cards} GPUs, JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines()[:max(n_cards, 1)]:
        print(line.strip(), flush=True)
    cache = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
             or jax.config.jax_compilation_cache_dir)
    note(f"device_kind={devices[0].device_kind!r} count={len(devices)} "
         f"jax={jax.__version__} compile_cache={cache}")
    return devices[0]


# ---------------------------------------------------------------- CLI glue


def run_cli(main, argv: list[str]) -> list[str]:
    """Call a CLI's own main(argv) in-process; echo and return its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    sys.stdout.flush()
    return out.strip().splitlines()


def last_json(lines: list[str]) -> dict:
    return json.loads(lines[-1])


def read_metrics(outdir: str) -> list[dict]:
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def check_training(name: str, recs: list[dict], epochs: int,
                   oos: bool = True) -> dict:
    """Every logged loss finite, the last epoch's loss below the first's,
    and (GPPVAE) the out-of-sample MSE falling."""
    check(len(recs) == epochs, f"{name}: logged {len(recs)} epochs, "
                               f"expected {epochs}")
    losses = [r["loss"] for r in recs]
    check(all(math.isfinite(v) for v in losses),
          f"{name}: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
    out = {"loss": losses}
    if oos:
        mse = [r["oos_mse"] for r in recs]
        check(all(math.isfinite(v) for v in mse),
              f"{name}: non-finite oos_mse in {mse}")
        check(mse[-1] < mse[0], f"{name}: oos_mse did not fall: {mse}")
        out["oos_mse"] = mse
    return out


# ---------------------------------------------------------------- train


def phase_train(work: str, digits=DIGITS, faces=FACES,
                epochs=(2, 3, 2)) -> dict:
    """The trainers' own main(argv): VAE pretrain, GPPVAE joint in float32
    (resize decoder) and bfloat16 (subpixel decoder) from its weights, a
    --resume of each, and a face-view run at 128x128."""
    # the CLI modules (the package namespace exports same-named functions)
    tg = importlib.import_module("gppvae_tpu.train.train_gppvae")
    tv = importlib.import_module("gppvae_tpu.train.train_vae")

    e_vae, e_gp, e_face = epochs
    runs = {}

    def gppvae(name, argv, n_epochs):
        outdir = os.path.join(work, name)
        t0 = time.perf_counter()
        run_cli(tg.main, [*argv, "--epochs", str(n_epochs),
                          "--outdir", outdir])
        sec = time.perf_counter() - t0
        stats = check_training(name, read_metrics(outdir), n_epochs)
        final = os.path.join(outdir, "final_state")
        check(os.path.isfile(final), f"{name}: no checkpoint at {final}")
        # the checkpoint reloads through --resume and trains one more epoch
        rdir = outdir + "_resumed"
        run_cli(tg.main, [*argv, "--resume", final,
                          "--epochs", str(n_epochs + 1), "--outdir", rdir])
        rrecs = read_metrics(rdir)
        check([r["epoch"] for r in rrecs] == [n_epochs],
              f"{name}: --resume logged epochs "
              f"{[r['epoch'] for r in rrecs]}, expected [{n_epochs}]")
        check(math.isfinite(rrecs[0]["loss"]),
              f"{name}: non-finite loss after --resume")
        runs[name] = {**stats, "seconds": round(sec, 2),
                      "resumed_loss": rrecs[0]["loss"]}
        note(f"train {name}: {json.dumps(runs[name])}")

    vae_dir = os.path.join(work, "vae")
    t0 = time.perf_counter()
    run_cli(tv.main, [*digits, "--epochs", str(e_vae), "--outdir", vae_dir])
    runs["vae"] = {
        **check_training("vae", read_metrics(vae_dir), e_vae, oos=False),
        "seconds": round(time.perf_counter() - t0, 2),
    }
    weights = os.path.join(vae_dir, "vae_weights")
    check(os.path.isfile(weights), f"vae: no weights at {weights}")
    note(f"train vae: {json.dumps(runs['vae'])}")

    joint = [*digits, "--mode", "joint", "--vae_weights", weights]
    gppvae("gppvae_f32", joint, e_gp)
    gppvae("gppvae_bf16_subpixel",
           [*joint, "--dtype", "bfloat16", "--dec_upsample", "subpixel"], e_gp)
    gppvae("faces_128", [*faces, "--mode", "joint"], e_face)
    return runs


# ---------------------------------------------------------------- serve


def phase_serve(work: str, run_dir: str, n_requests: int = 8) -> dict:
    """generate --export_server, then serve from the live state (--var,
    --sample --joint, --observe) and from exported blobs (--export_exe,
    --exe), whose answers must match the live path."""
    import jax
    import numpy as np

    from gppvae_tpu.config.datasets import build_dataset_from_flag
    generate = importlib.import_module("gppvae_tpu.eval.generate")
    serving = importlib.import_module("gppvae_tpu.eval.serving")

    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    dcfg = cfg.get("dataset", {})
    ds = build_dataset_from_flag(
        cfg.get("data") or "synthetic", dcfg["num_objects"],
        dcfg["num_views"], cfg.get("seed", 0),
        image_size=dcfg.get("image_size"),
    )
    # the requests are held-out cells: the fold below observes exactly them
    cells = ds.heldout_idx[:n_requests]
    req = ",".join(f"{int(ds.object_ids[i])}:{int(ds.view_ids[i])}"
                   for i in cells)
    obs = os.path.join(work, "observe.npz")
    np.savez(obs, images=ds.images[cells], objects=ds.object_ids[cells],
             views=ds.view_ids[cells])

    out = {}
    srv = os.path.join(work, "model.srv")
    t0 = time.perf_counter()
    exported = last_json(run_cli(generate.main, [
        "--state", os.path.join(run_dir, "final_state"),
        "--export_server", srv]))
    check(exported["rank"] == 56, f"server rank {exported['rank']} != 56")
    out["export_server_s"] = round(time.perf_counter() - t0, 2)

    def serve(tag, *argv):
        outdir = os.path.join(work, tag)
        rec = last_json(run_cli(serving.main, [*argv, "--outdir", outdir]))
        with np.load(os.path.join(outdir, "served.npz")) as z:
            images = np.asarray(z["images"])
        check(bool(np.isfinite(images).all()), f"serve {tag}: non-finite")
        return rec, images

    t0 = time.perf_counter()
    live, y_live = serve("live_var", "--state", srv, "--requests", req,
                         "--var")
    image_shape = tuple(ds.image_shape)
    check(y_live.shape == (n_requests, *image_shape),
          f"serve --var: images {y_live.shape}")
    var0 = np.asarray(live["posterior_var"])
    check(bool((var0 > 0).all()), f"serve --var: variances {var0}")
    _, y_s = serve("live_sample", "--state", srv, "--requests", req,
                   "--sample", "4", "--joint")
    check(y_s.shape == (n_requests, 4, *image_shape),
          f"serve --sample 4 --joint: images {y_s.shape}")
    out["serve_live_s"] = round(time.perf_counter() - t0, 2)

    # observing a held-out cell shrinks its latent variance by ~1e-4 of a
    # predictive variance that v_noise dominates, below what TF32 dots
    # resolve: the before/after pair runs at "highest" precision
    srv2 = os.path.join(work, "model_obs.srv")
    with jax.default_matmul_precision("highest"):
        before, y_before = serve("highest_var", "--state", srv,
                                 "--requests", req, "--var")
        after, _ = serve("live_observed", "--state", srv, "--observe", obs,
                         "--save_state", srv2, "--requests", req, "--var")
    var_b = np.asarray(before["posterior_var"])
    var_a = np.asarray(after["posterior_var"])
    check(bool((var_a < var_b).all()),
          f"--observe did not shrink the variance: {var_b} -> {var_a}")
    out["var_before"], out["var_after"] = var_b.tolist(), var_a.tolist()

    # The blobs are compared with the live path twice. At "highest" both
    # run the same f32 arithmetic (gate EXE_ATOL). At the default precision
    # each compilation rounds its convs to TF32 on its own, so they are
    # gated like the other default-precision errors (DEFAULT_TOL).
    live_ref = {"highest": (y_before, var_b), "default": (y_live, var0)}
    for prec, tol in (("highest", EXE_ATOL), ("default", DEFAULT_TOL)):
        ctx = (jax.default_matmul_precision(prec) if prec == "highest"
               else contextlib.nullcontext())
        exe = os.path.join(work, f"model_{prec}.exe")
        with ctx:
            t0 = time.perf_counter()
            emeta = last_json(run_cli(serving.main, [
                "--state", srv, "--export_exe", exe]))
            check(set(emeta["platforms"]) == {"cuda", "cpu"},
                  f"--export_exe lowered for {emeta['platforms']}")
            out[f"export_exe_{prec}_s"] = round(time.perf_counter() - t0, 2)
            _, y_mean = serve(f"exe_{prec}_mean", "--exe", exe,
                              "--requests", req)
            exe_var, y_exe = serve(f"exe_{prec}", "--exe", exe,
                                   "--requests", req, "--var")
        y_ref, var_ref = live_ref[prec]
        err = float(max(np.max(np.abs(y_mean - y_ref)),
                        np.max(np.abs(y_exe - y_ref))))
        verr = float(np.max(np.abs(np.asarray(exe_var["posterior_var"])
                                   - var_ref)))
        out[f"exe_vs_live_{prec}"] = {"images": err, "variances": verr}
        check(err <= tol and verr <= tol,
              f"--exe answers at {prec} precision differ from the live "
              f"path: images {err}, variances {verr} (atol {tol})")
    note(f"serve: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- reference


def _relerr(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def gp_inputs(n_objects=400, n_views=16, rank=56, zdim=16, seed=0):
    """Feature rows U (N, R) and latents Z (N, L) at the training shapes:
    U is built like the trainer builds it from the digits grid's train
    split (object features x Fourier view features; at R=256 an RFF object
    map of rank 32 x 7 view features plus an object effect of rank 32, as
    --object_kernel rbf --extra_effects object gives)."""
    import numpy as np

    import jax.numpy as jnp

    from gppvae_tpu import gp
    from gppvae_tpu.data import build_rotated_digits

    ds = build_rotated_digits("synthetic", num_objects=n_objects,
                              num_views=n_views, seed=seed)
    tr = ds.train_idx
    d, q = jnp.asarray(ds.object_ids[tr]), jnp.asarray(ds.view_ids[tr])
    rng = np.random.default_rng(seed)
    W = gp.fourier_view_features(
        jnp.linspace(0.0, 2 * jnp.pi, n_views, endpoint=False), 3)
    X = gp.normalize_rows(jnp.asarray(rng.normal(size=(n_objects, 8)),
                                      jnp.float32))
    if rank == 56:
        U = gp.build_V(X, W, d, q)
    elif rank == 256:
        rff, m = gp.make_rff_map(8, 32, 1.0, seed=seed)
        F = rff(X)
        U = jnp.concatenate([gp.kron_rows(F[d], W[q]), F[d]], axis=1)
    else:
        raise ValueError(f"no feature construction for rank {rank}")
    Z = jnp.asarray(rng.normal(size=(len(tr), zdim)), jnp.float32)
    return np.asarray(U, np.float32), np.asarray(Z, np.float32)


def gp_reference(U, Z, vn: float) -> dict:
    """float64 numpy: G, UᵀZ, ‖Z‖², the NLL through the determinant lemma
    and dNLL/dU = L·K⁻¹U − A(AᵀU) with A = K⁻¹Z, K = UUᵀ + v_n·I."""
    import numpy as np

    U = np.asarray(U, np.float64)
    Z = np.asarray(Z, np.float64)
    N, R = U.shape
    L = Z.shape[1]
    G = U.T @ U
    UtZ = U.T @ Z
    zn = float(np.sum(Z * Z))
    B = np.eye(R) + G / vn
    _, logdet_b = np.linalg.slogdet(B)
    Binv_UtZ = np.linalg.solve(B, UtZ)
    quad = (zn - float(np.sum(UtZ * Binv_UtZ)) / vn) / vn
    nll = 0.5 * (L * (N * math.log(vn) + logdet_b) + quad
                 + N * L * math.log(2 * math.pi))
    A = (Z - U @ Binv_UtZ / vn) / vn
    dU = L * np.linalg.solve(B, U.T).T / vn - A @ (A.T @ U)
    return {"G": G, "UtZ": UtZ, "zn": zn, "nll": nll, "dU": dU}


def dense_nll64(U, Z, vn: float) -> float:
    """The dense oracle (gp/dense.py's formula) in float64 numpy: the
    N x N covariance is materialized and factored."""
    import numpy as np

    U = np.asarray(U, np.float64)
    Z = np.asarray(Z, np.float64)
    N, L = Z.shape
    K = U @ U.T
    K[np.diag_indices(N)] += vn
    Lk = np.linalg.cholesky(K)
    W = np.linalg.solve(Lk, Z)
    return 0.5 * (L * 2.0 * float(np.sum(np.log(np.diag(Lk))))
                  + float(np.sum(W * W)) + N * L * math.log(2 * math.pi))


def gp_device(U, Z, vn: float, precision: str | None) -> dict:
    """ops.factor_prep + ops.woodbury_nll_core and dNLL/dU, jitted on the
    default device at `precision` (None = the program's default)."""
    import jax
    import jax.numpy as jnp

    from gppvae_tpu import ops

    N, L = Z.shape

    def nll_of(u, z):
        G, UtZ, zn = ops.factor_prep(u, z)
        return ops.woodbury_nll_core(G, UtZ, zn, jnp.float32(vn), N, L)

    def fn(u, z):
        return ops.factor_prep(u, z), jax.value_and_grad(nll_of)(u, z)

    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        (G, UtZ, zn), (nll, dU) = jax.jit(fn)(jnp.asarray(U), jnp.asarray(Z))
    return jax.device_get({"G": G, "UtZ": UtZ, "zn": zn, "nll": nll,
                           "dU": dU})


def phase_gp_reference(ranks=(56, 256), vn: float = 0.5, n_objects=400,
                       dense_rank: int | None = 56) -> dict:
    out = {}
    for rank in ranks:
        U, Z = gp_inputs(n_objects=n_objects, rank=rank)
        check(U.shape[1] == rank, f"feature rank {U.shape[1]} != {rank}")
        ref = gp_reference(U, Z, vn)
        row = {"N": U.shape[0], "R": rank, "L": Z.shape[1]}
        if rank == dense_rank:
            dense = dense_nll64(U, Z, vn)
            row["dense_vs_woodbury64"] = abs(dense - ref["nll"]) / abs(dense)
            check(row["dense_vs_woodbury64"] < 1e-9,
                  f"R={rank}: float64 references disagree "
                  f"({row['dense_vs_woodbury64']})")
        for prec in ("highest", None):
            dev = gp_device(U, Z, vn, prec)
            errs = {k: _relerr(dev[k], ref[k]) for k in HIGHEST_TOL}
            key = prec or "default"
            row[key] = errs
            for k, e in errs.items():
                tol = HIGHEST_TOL[k] if prec else DEFAULT_TOL
                check(e <= tol, f"R={rank} precision={key}: {k} error {e} "
                                f"> {tol}")
        out[f"R{rank}"] = row
        note(f"reference gp R={rank}: {json.dumps(row)}")
    return out


def phase_net_reference(configs=((32, 1, 16, 128), (128, 3, 32, 64))) -> dict:
    """Encoder and decoder forward (f32, both decoders) on the card at
    'highest' against the same jitted function on the CPU device."""
    import jax
    import jax.numpy as jnp

    from gppvae_tpu.models import VAE

    cpu = jax.devices("cpu")[0]
    out = {}
    key = jax.random.PRNGKey(0)
    for size, ch, zdim, bs in configs:
        for upsample in ("resize", "subpixel"):
            model = VAE(zdim=zdim, image_shape=(size, size, ch),
                        upsample=upsample)
            k1, k2, k3 = jax.random.split(jax.random.fold_in(key, size), 3)
            y = jax.random.uniform(k1, (bs, size, size, ch), jnp.float32)
            z = jax.random.normal(k2, (bs, zdim), jnp.float32)
            params = model.init(k3, y[:1])
            enc = jax.jit(lambda p, y: model.apply(p, y, method=VAE.encode))
            dec = jax.jit(lambda p, z: model.apply(p, z, method=VAE.decode))
            with jax.default_matmul_precision("highest"):
                on_card = jax.device_get((enc(params, y), dec(params, z)))
            p_cpu, y_cpu, z_cpu = jax.device_put((params, y, z), cpu)
            on_cpu = jax.device_get((enc(p_cpu, y_cpu), dec(p_cpu, z_cpu)))
            errs = {
                "mu": _relerr(on_card[0][0], on_cpu[0][0]),
                "logvar": _relerr(on_card[0][1], on_cpu[0][1]),
                "logits": _relerr(on_card[1], on_cpu[1]),
            }
            name = f"{size}x{size}x{ch}_{upsample}"
            out[name] = errs
            for k, e in errs.items():
                check(e <= NET_TOL, f"nets {name}: {k} card-vs-cpu error "
                                    f"{e} > {NET_TOL}")
    note(f"reference nets: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- multi


def phase_multi(n_objects: int = 400, epochs: int = 2) -> dict:
    """The digits config trained on make_mesh(4) and make_mesh_2d(2, 2),
    each compared with a one-card run at 'highest' precision, and the SPMD
    wire audit on the real 4-card mesh."""
    import dataclasses

    import jax
    import numpy as np

    from gppvae_tpu.data import build_rotated_digits
    from gppvae_tpu.parallel import assert_wire_structure, make_mesh, make_mesh_2d
    from gppvae_tpu.train import GPPVAETrainConfig, train_gppvae
    from gppvae_tpu.utils.metrics import NullLogger

    ds = build_rotated_digits("synthetic", num_objects=n_objects,
                              num_views=16, seed=0)
    config = GPPVAETrainConfig(mode="joint", zdim=16, epochs=epochs,
                               batch_size=128, obj_feature_dim=8,
                               view_num_freqs=3, seed=0)
    keys = ("loss", "gp_nll_full", "oos_mse")
    out = {}
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        ref = train_gppvae(ds, config, log=NullLogger()).history
        out["single_s"] = round(time.perf_counter() - t0, 2)
        for name, mesh in (("mesh_4", make_mesh(4)),
                           ("mesh_2x2", make_mesh_2d(2, 2))):
            t0 = time.perf_counter()
            hist = train_gppvae(ds, config, mesh=mesh, log=NullLogger()).history
            row = {"seconds": round(time.perf_counter() - t0, 2)}
            for k in keys:
                got = [h[k] for h in hist]
                want = [h[k] for h in ref]
                row[k] = got
                row[f"{k}_single"] = want
                check(bool(np.allclose(got, want, rtol=1e-4, atol=1e-6)),
                      f"{name}: {k} {got} differs from one card {want}")
            out[name] = row
            note(f"multi {name}: {json.dumps(row)}")
        ds2 = build_rotated_digits("synthetic", num_objects=n_objects,
                                   num_views=16, seed=0, heldout_per_object=3)
        audit = assert_wire_structure(
            ds, dataclasses.replace(config, epochs=1, encode_chunk=512),
            make_mesh(4), dataset_2=ds2)
    out["wire_audit"] = {"n_collectives": audit["n_collectives"],
                         "max_bytes": audit["max_bytes"],
                         "budget": audit["budget"]}
    note(f"multi wire audit: {json.dumps(out['wire_audit'])}")
    return out


# ---------------------------------------------------------------- main


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="four cards: mesh-vs-one-card training and the wire "
                        "audit, and no other phase")
    args = p.parse_args(argv)
    _import_package()
    n_cards = 4 if args.multi else 1
    device = phase_device(n_cards)
    t_start = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        scratch = os.path.join(REPO, "out")
        os.makedirs(scratch, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                         dir=scratch) as work:
            t0 = time.perf_counter()
            phase_train(work)
            note(f"phase train: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_serve(work, os.path.join(work, "gppvae_f32"))
            note(f"phase serve: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_gp_reference()
        phase_net_reference()
        note(f"phase reference: {time.perf_counter() - t0:.1f} s")
    note(f"all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": n_cards}}), flush=True)


if __name__ == "__main__":
    main()

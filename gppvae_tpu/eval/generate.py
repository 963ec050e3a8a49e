"""Standalone out-of-sample conditional generation CLI (BASELINE.json:11).

Loads a trained GPPVAE state, refreshes the training latents with the saved
encoder, and generates images for the held-out (object, view) grid cells
from GP-predictive latents alone (SURVEY.md §3.4) — reporting the pixel-MSE
parity metric and writing a truth/prediction panel.

    python -m gppvae_tpu.eval.generate --state out/gppvae/final_state \
        --data synthetic [--num_objects 400 --num_views 16]

Extras beyond the reference:
    --object D    novel-view synthesis: predict ALL views of object D from
                  its training views (panel: truth row / prediction row)
    --sample K    unconditional generation: decode K latent rows drawn from
                  the learned GP prior z ~ N(0, K) (uses U·ε + √v_n·ε)
    --posterior_sample K --object D --view V
                  conditional UNCERTAINTY rendering: decode K draws from the
                  GP-predictive posterior N(μ*, σ*² I) of one grid cell —
                  tight posteriors give near-identical samples, extrapolated
                  cells visibly vary (gp.predict_latents return_var)
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from gppvae_tpu import gp
from gppvae_tpu.checkpoint import load_pytree
from gppvae_tpu.data.dataset import GridDataset
from gppvae_tpu.eval.oos import predict_heldout
from gppvae_tpu.eval.panels import save_panel
from gppvae_tpu.eval.serving import decode_images, stable_cholesky
from gppvae_tpu.models import VAE, encode_all


def _check_grid_matches(params, fixed_W, dataset: GridDataset) -> None:
    """Loud error when the rebuilt dataset's grid doesn't match the
    checkpoint (JAX gathers clamp out-of-range ids and would otherwise
    silently produce garbage predictions)."""
    P = params["gp"]["X"].shape[0]
    W = params["gp"].get("W", fixed_W)
    Q = None if W is None else W.shape[0]
    if dataset.num_objects != P or (Q is not None and dataset.num_views != Q):
        raise ValueError(
            f"dataset grid ({dataset.num_objects} objects × "
            f"{dataset.num_views} views) does not match the checkpoint "
            f"({P} objects × {Q} views) — pass the same --data/--num_objects/"
            "--num_views the run was trained with"
        )


def _model_and_xmap(state, dataset, *, zdim, enc_features, dec_features,
                    object_kernel, rff_features, rff_lengthscale, seed,
                    dec_upsample="resize", compute_dtype="float32",
                    **_ignored):
    """Shared checkpoint→(model, x_map) construction for every CLI path,
    WITH the grid-mismatch guard (gathers clamp out-of-range ids, so a
    wrong dataset would otherwise produce silent garbage).

    dec_upsample/compute_dtype come from the run's sidecar config.json so
    eval runs through the SAME decoder lowering/precision the model
    trained (and was benchmarked) with — every lowering computes the same
    function on the same params, but a model benchmarked with the subpixel
    decoder must not be evaluated through the slower literal resize path."""
    params = state["params"]
    _check_grid_matches(params, state.get("fixed_W"), dataset)
    x_map = gp.make_x_map(
        object_kernel, params["gp"]["X"].shape[1], rff_features,
        rff_lengthscale, seed, state.get("nystrom_idx"),
    )
    model = VAE(
        zdim=zdim,
        image_shape=tuple(dataset.image_shape),
        enc_features=tuple(enc_features),
        dec_features=tuple(dec_features),
        dtype=jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32,
        upsample=dec_upsample,
    )
    return model, x_map


def generate_heldout(
    state: dict,
    dataset: GridDataset,
    *,
    zdim: int,
    enc_features=(32, 64, 128),
    dec_features=(128, 64, 32),
    object_kernel: str = "linear",
    rff_features: int = 32,
    rff_lengthscale: float = 1.0,
    extra_effects: tuple = (),
    seed: int = 0,
    dec_upsample: str = "resize",
    compute_dtype: str = "float32",
) -> tuple[np.ndarray, float]:
    """Returns (predicted heldout images, pixel MSE vs ground truth)."""
    params = state["params"]
    fixed_W = state.get("fixed_W")
    model, x_map = _model_and_xmap(
        state, dataset, zdim=zdim, enc_features=enc_features,
        dec_features=dec_features, object_kernel=object_kernel,
        rff_features=rff_features, rff_lengthscale=rff_lengthscale, seed=seed,
        dec_upsample=dec_upsample, compute_dtype=compute_dtype,
    )
    tr, ho = dataset.train_idx, dataset.heldout_idx
    images_tr = jnp.asarray(dataset.images[tr])
    d_tr = jnp.asarray(dataset.object_ids[tr])
    q_tr = jnp.asarray(dataset.view_ids[tr])
    chunk = min(1024, len(tr))  # same activation cap as the trainer's Phase A

    @jax.jit
    def run(params, fixed_W):
        Z0 = encode_all(model, params["vae"], images_tr, chunk)
        return predict_heldout(
            model, params, fixed_W, Z0, d_tr, q_tr,
            jnp.asarray(dataset.object_ids[ho]),
            jnp.asarray(dataset.view_ids[ho]),
            jnp.asarray(dataset.images[ho]),
            x_map=x_map, extra_effects=tuple(extra_effects),
        )

    y_pred, mse = run(params, fixed_W)
    return np.asarray(y_pred), float(mse)


def synthesize_views(
    state: dict,
    dataset: GridDataset,
    object_id: int,
    *,
    zdim: int,
    enc_features=(32, 64, 128),
    dec_features=(128, 64, 32),
    object_kernel: str = "linear",
    rff_features: int = 32,
    rff_lengthscale: float = 1.0,
    extra_effects: tuple = (),
    seed: int = 0,
    dec_upsample: str = "resize",
    compute_dtype: str = "float32",
) -> np.ndarray:
    """Novel-view synthesis: GP-predict every view of one object from the
    TRAINING rows only (its held-out views are genuinely extrapolated)."""
    params = state["params"]
    fixed_W = state.get("fixed_W")
    if not 0 <= object_id < dataset.num_objects:
        raise ValueError(
            f"object {object_id} out of range [0, {dataset.num_objects})"
        )
    model, x_map = _model_and_xmap(
        state, dataset, zdim=zdim, enc_features=enc_features,
        dec_features=dec_features, object_kernel=object_kernel,
        rff_features=rff_features, rff_lengthscale=rff_lengthscale, seed=seed,
        dec_upsample=dec_upsample, compute_dtype=compute_dtype,
    )
    tr = dataset.train_idx
    Q = dataset.num_views
    images_tr = jnp.asarray(dataset.images[tr])
    d_tr = jnp.asarray(dataset.object_ids[tr])
    q_tr = jnp.asarray(dataset.view_ids[tr])
    d_all = jnp.full((Q,), object_id, jnp.int32)
    q_all = jnp.arange(Q, dtype=jnp.int32)

    @jax.jit
    def run(params, fixed_W):
        Z0 = encode_all(model, params["vae"], images_tr, min(1024, len(tr)))
        y_pred, _ = predict_heldout(
            model, params, fixed_W, Z0, d_tr, q_tr, d_all, q_all,
            jnp.zeros((Q, *dataset.image_shape), jnp.float32),
            x_map=x_map, extra_effects=tuple(extra_effects),
        )
        return y_pred

    return np.asarray(run(params, fixed_W))


def sample_prior(
    state: dict,
    dataset: GridDataset,
    num_samples: int,
    *,
    zdim: int,
    enc_features=(32, 64, 128),
    dec_features=(128, 64, 32),
    object_kernel: str = "linear",
    rff_features: int = 32,
    rff_lengthscale: float = 1.0,
    extra_effects: tuple = (),
    seed: int = 0,
    draw_seed: int | None = None,
    dec_upsample: str = "resize",
    compute_dtype: str = "float32",
) -> np.ndarray:
    """Unconditional generation from the learned GP prior: draw latent rows
    z = U ε_r + √v_n ε_n for randomly chosen (object, view) cells, decode.

    draw_seed: RNG seed for the draws alone. `seed` also fixes the RFF
    feature map (it must match training for rbf kernels), so re-rolling it
    to get fresh samples would silently change the KERNEL; draw_seed varies
    only the randomness (default None = use `seed`, the legacy behavior)."""
    params = state["params"]
    fixed_W = state.get("fixed_W")
    model, x_map = _model_and_xmap(
        state, dataset, zdim=zdim, enc_features=enc_features,
        dec_features=dec_features, object_kernel=object_kernel,
        rff_features=rff_features, rff_lengthscale=rff_lengthscale, seed=seed,
        dec_upsample=dec_upsample, compute_dtype=compute_dtype,
    )
    key = jax.random.PRNGKey(seed if draw_seed is None else draw_seed)
    kd, kq, kr, kn = jax.random.split(key, 4)
    d = jax.random.randint(kd, (num_samples,), 0, dataset.num_objects)
    q = jax.random.randint(kq, (num_samples,), 0, dataset.num_views)
    W = params["gp"].get("W", fixed_W)
    Vs = gp.build_effect_rows(params["gp"]["X"], W, d, q,
                              extra_effects=tuple(extra_effects), x_map=x_map)
    v_sig, v_noise = gp.variances_from_log(
        params["gp"]["log_vs"], params["gp"]["log_vn"]
    )
    v_sig = jnp.reshape(v_sig, (-1,))
    U = gp.scaled_features(Vs, [v_sig[i] for i in range(len(Vs))])
    z = U @ jax.random.normal(kr, (U.shape[1], zdim)) + jnp.sqrt(
        v_noise
    ) * jax.random.normal(kn, (num_samples, zdim))
    logits = model.apply(params["vae"], z, method=VAE.decode)
    return np.asarray(jax.nn.sigmoid(logits))


def _posterior_scaffold(state, dataset, d_star, q_star, *, zdim,
                        enc_features=(32, 64, 128),
                        dec_features=(128, 64, 32),
                        object_kernel: str = "linear",
                        rff_features: int = 32,
                        rff_lengthscale: float = 1.0,
                        extra_effects: tuple = (), seed: int = 0,
                        dec_upsample: str = "resize",
                        compute_dtype: str = "float32"):
    """Shared scaffold of sample_posterior / sample_posterior_sweep
    (ADVICE.md round-4: the two differed only in the star rows and the
    draw step): checkpoint→model rebuild with the grid guard, training
    arrays, and a traceable setup(params, fixed_W) →
    (Z0, V_star, v_sigs, factors) that runs the Phase-A encode and the
    Woodbury factorization. Callers keep only their own draw math."""
    params = state["params"]
    fixed_W = state.get("fixed_W")
    model, x_map = _model_and_xmap(
        state, dataset, zdim=zdim, enc_features=enc_features,
        dec_features=dec_features, object_kernel=object_kernel,
        rff_features=rff_features, rff_lengthscale=rff_lengthscale, seed=seed,
        dec_upsample=dec_upsample, compute_dtype=compute_dtype,
    )
    tr = dataset.train_idx
    images_tr = jnp.asarray(dataset.images[tr])
    d_tr = jnp.asarray(dataset.object_ids[tr])
    q_tr = jnp.asarray(dataset.view_ids[tr])
    v_sig, v_noise = gp.variances_from_log(
        params["gp"]["log_vs"], params["gp"]["log_vn"]
    )
    v_sig = jnp.reshape(v_sig, (-1,))

    def setup(params, fixed_W):
        Z0 = encode_all(model, params["vae"], images_tr, min(1024, len(tr)))
        Wp = params["gp"].get("W", fixed_W)
        V_tr = gp.build_effect_rows(params["gp"]["X"], Wp, d_tr, q_tr,
                                    extra_effects=tuple(extra_effects),
                                    x_map=x_map)
        V_star = gp.build_effect_rows(params["gp"]["X"], Wp, d_star, q_star,
                                      extra_effects=tuple(extra_effects),
                                      x_map=x_map)
        v_sigs = [v_sig[i] for i in range(len(V_tr))]
        factors = gp.factorize(V_tr, v_sigs, v_noise)
        return Z0, V_star, v_sigs, factors

    return model, params, fixed_W, setup


def sample_posterior(
    state: dict,
    dataset: GridDataset,
    object_id: int,
    view_id: int,
    num_samples: int,
    *,
    seed: int = 0,
    draw_seed: int | None = None,
    **arch,
) -> tuple[np.ndarray, float]:
    """Posterior SAMPLING for one (object, view) cell: decode K draws
    z* ~ N(μ*, σ*² I_L) from the GP-predictive posterior (mean AND variance
    — gp.predict_latents return_var; the variance is shared across the L
    iid latent dims). Where generate_heldout decodes only the posterior
    mean, this renders the model's calibrated uncertainty as image
    diversity: tight posteriors (object seen from nearby views) give
    near-identical samples, extrapolated cells visibly vary.

    Returns (images (K, H, W, C), posterior variance σ*²)."""
    if not 0 <= object_id < dataset.num_objects:
        raise ValueError(
            f"object {object_id} out of range [0, {dataset.num_objects})"
        )
    if not 0 <= view_id < dataset.num_views:
        raise ValueError(f"view {view_id} out of range [0, {dataset.num_views})")
    d_star = jnp.asarray([object_id], jnp.int32)
    q_star = jnp.asarray([view_id], jnp.int32)
    model, params, fixed_W, setup = _posterior_scaffold(
        state, dataset, d_star, q_star, seed=seed, **arch
    )

    @jax.jit
    def run(params, fixed_W):
        Z0, V_star, v_sigs, factors = setup(params, fixed_W)
        mean, var = gp.predict_latents(
            V_star, factors, Z0, v_sigs, return_var=True
        )
        eps = jax.random.normal(
            jax.random.PRNGKey(seed if draw_seed is None else draw_seed),
            (num_samples, mean.shape[1]),
        )
        z = mean + jnp.sqrt(jnp.maximum(var[:, None], 0.0)) * eps
        logits = model.apply(params["vae"], z, method=VAE.decode)
        return jax.nn.sigmoid(logits), var[0]

    y_s, var = run(params, fixed_W)
    return np.asarray(y_s), float(var)


def sample_posterior_sweep(
    state: dict,
    dataset: GridDataset,
    object_id: int,
    num_samples: int,
    *,
    seed: int = 0,
    draw_seed: int | None = None,
    jitter: float = 1e-6,
    **arch,
) -> tuple[np.ndarray, np.ndarray]:
    """COHERENT posterior sampling over one object's FULL view sweep: K
    joint draws of all Q views at once from the exact Q×Q posterior
    covariance (gp.predict_cov_from_core — Cov = U*B⁻¹U*ᵀ + vₙI from the
    R-sized core), so each draw is one self-consistent object seen from
    every view, not Q independently-wobbled cells. Views of the same
    object are strongly correlated under the GP posterior (they share the
    object's x_d row); sample_posterior's per-cell N(μ*, σ*²) draws throw
    that correlation away, which is exactly what a whole-sweep panel makes
    visible: here a sample row drifts COHERENTLY (the object identity
    wobbles, the view structure stays), there each cell wobbles alone.

    Returns (images (K, Q, H, W, C), per-view posterior variance (Q,))."""
    if not 0 <= object_id < dataset.num_objects:
        raise ValueError(
            f"object {object_id} out of range [0, {dataset.num_objects})"
        )
    Q = dataset.num_views
    d_star = jnp.full((Q,), object_id, jnp.int32)
    q_star = jnp.arange(Q, dtype=jnp.int32)
    model, params, fixed_W, setup = _posterior_scaffold(
        state, dataset, d_star, q_star, seed=seed, **arch
    )

    @jax.jit
    def run(params, fixed_W):
        Z0, V_star, v_sigs, factors = setup(params, fixed_W)
        core = gp.posterior_core(factors, Z0)
        mean, cov = gp.predict_cov_from_core(V_star, core, v_sigs)
        L = mean.shape[1]
        Lc = stable_cholesky(cov, jitter)
        eps = jax.random.normal(
            jax.random.PRNGKey(seed if draw_seed is None else draw_seed),
            (Q, num_samples, L), mean.dtype,
        )
        z = mean[:, None, :] + jnp.einsum("ij,jkl->ikl", Lc, eps)
        y = decode_images(model, params["vae"], z.reshape(Q * num_samples, L))
        return y.reshape(Q, num_samples, *y.shape[1:]), jnp.diagonal(cov)

    y_s, var = run(params, fixed_W)
    return np.asarray(jnp.swapaxes(y_s, 0, 1)), np.asarray(var)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="GPPVAE out-of-sample generation")
    p.add_argument("--state", required=True, help="final_state checkpoint dir")
    # dataset flags default from the run's sidecar config.json so the
    # evaluated data/split is the one the run trained on (a non-default
    # training seed silently rebuilt DIFFERENT synthetic images before —
    # same grid shape, so _check_grid_matches could not catch it)
    p.add_argument("--data", default=None)
    p.add_argument("--image_size", type=int, default=None,
                   help="spatial size for built datasets (defaults from the"
                        " sidecar; builder default otherwise)")
    p.add_argument("--num_objects", type=int, default=None)
    p.add_argument("--num_views", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--zdim", type=int, default=None)
    p.add_argument("--object", type=int, default=None,
                   help="synthesize ALL views of this object id")
    p.add_argument("--sample", type=int, default=0,
                   help="decode N draws from the learned GP prior")
    p.add_argument("--posterior_sample", type=int, default=0,
                   help="with --object/--view: decode N draws from the "
                        "GP-predictive POSTERIOR of that cell (mean ± "
                        "calibrated σ*, rendered as image diversity)")
    p.add_argument("--view", type=int, default=0,
                   help="view id for --posterior_sample (default 0)")
    p.add_argument("--draw_seed", type=int, default=None,
                   help="RNG seed for --sample/--posterior_sample draws "
                        "only (default: the run's training seed). The "
                        "training seed also fixes the RFF feature map, so "
                        "this is the ONLY safe way to get fresh draws — "
                        "overriding --seed would silently change the "
                        "kernel on rbf runs")
    p.add_argument("--joint", action="store_true",
                   help="with --posterior_sample --object: draw the K "
                        "samples JOINTLY over the object's FULL view sweep "
                        "from the exact Q×Q posterior covariance (each "
                        "panel row is one coherent scene across all views; "
                        "--view is ignored), instead of per-cell draws "
                        "from the diagonal variance")
    p.add_argument("--export_server", default=None, metavar="PATH",
                   help="fold the GP posterior into an R-sized server state "
                        "(eval/serving.py) and save the deployment artifact")
    p.add_argument("--outdir", default=None)
    args = p.parse_args(argv)

    from gppvae_tpu.config.datasets import build_dataset_from_flag

    # model architecture from the run's sidecar config.json (written by
    # train_gppvae next to its checkpoints), overridable by --zdim
    run_dir = os.path.dirname(os.path.abspath(args.state))
    arch = {
        "zdim": 16, "enc_features": (32, 64, 128),
        "dec_features": (128, 64, 32), "object_kernel": "linear",
        "rff_features": 32, "rff_lengthscale": 1.0, "extra_effects": (),
        "seed": 0,
        # decoder lowering + compute precision the run trained with: eval
        # and export must take the SAME (fast) path as the trainer/bench
        # (round-3 VERDICT Missing #5)
        "dec_upsample": "resize", "compute_dtype": "float32",
    }
    cfg_path = os.path.join(run_dir, "config.json")
    saved = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            saved = json.load(f)
        arch.update({k: saved[k] for k in arch if k in saved})
    if args.zdim is not None:
        arch["zdim"] = args.zdim

    saved_ds = saved.get("dataset", {})
    data = args.data if args.data is not None else saved.get("data") or "synthetic"
    num_objects = (
        args.num_objects if args.num_objects is not None
        else saved_ds.get("num_objects", 400)
    )
    num_views = (
        args.num_views if args.num_views is not None
        else saved_ds.get("num_views", 16)
    )
    seed = args.seed if args.seed is not None else saved.get("seed", 0)
    image_size = (
        args.image_size if args.image_size is not None
        else saved_ds.get("image_size")
    )

    ds = build_dataset_from_flag(
        data, num_objects, num_views, seed, image_size=image_size
    )
    state = load_pytree(args.state)
    outdir = args.outdir or os.path.dirname(os.path.abspath(args.state))

    if args.export_server:
        from gppvae_tpu.eval.serving import build_server_state, save_server_state

        params = state["params"]
        # _model_and_xmap applies the same grid-mismatch guard as every
        # other CLI path: a mismatch would fold a silently-wrong posterior
        # into the deployment artifact (gathers clamp out-of-range ids)
        model, x_map = _model_and_xmap(state, ds, **arch)
        tr = ds.train_idx
        srv = build_server_state(
            model, params, state.get("fixed_W"),
            jnp.asarray(ds.images[tr]), jnp.asarray(ds.object_ids[tr]),
            jnp.asarray(ds.view_ids[tr]), x_map=x_map,
            extra_effects=tuple(arch["extra_effects"]),
        )
        # record HOW to rebuild the feature map + model at serve time
        save_server_state(
            args.export_server, srv,
            meta={**arch, "image_shape": tuple(ds.image_shape)},
            nystrom_idx=state.get("nystrom_idx"),
        )
        print(json.dumps({
            "server_state": os.path.abspath(args.export_server),
            "rank": int(srv.core.M.shape[0]), "zdim": int(srv.core.M.shape[1]),
        }))
        return
    if args.joint and not args.posterior_sample:
        raise SystemExit("--joint modifies --posterior_sample; pass "
                         "--posterior_sample K --object D")
    if args.posterior_sample:
        if args.object is None:
            raise SystemExit("--posterior_sample needs --object (and --view)")
        if args.joint:
            y_s, var = sample_posterior_sweep(
                state, ds, args.object, args.posterior_sample,
                draw_seed=args.draw_seed, **arch
            )
            truth = ds.images[
                (ds.object_ids == args.object).nonzero()[0]
            ][np.argsort(ds.view_ids[(ds.object_ids == args.object)])]
            path = os.path.join(
                outdir, f"posterior_sweep_obj{args.object}.png"
            )
            # one panel row per joint draw: a coherent scene across views
            save_panel(path, ([truth] if len(truth) else [])
                       + [y_s[k] for k in range(len(y_s))])
            print(json.dumps({
                "posterior_sweep_panel": path, "object": args.object,
                "n": int(args.posterior_sample),
                "posterior_var": [round(float(v), 6) for v in var],
            }))
            return
        y_s, var = sample_posterior(
            state, ds, args.object, args.view, args.posterior_sample,
            draw_seed=args.draw_seed, **arch
        )
        cell = np.where(
            (ds.object_ids == args.object) & (ds.view_ids == args.view)
        )[0]
        path = os.path.join(
            outdir, f"posterior_obj{args.object}_view{args.view}.png"
        )
        # save_panel truncates every row to the SHORTEST row — tile the
        # single truth image across the K sample columns so all K draws
        # render (a 1-image truth row would silently drop K−1 samples)
        rows = (
            [np.repeat(ds.images[cell[:1]], len(y_s), axis=0)]
            if len(cell) else []
        ) + [y_s]
        save_panel(path, rows)
        print(json.dumps({
            "posterior_panel": path, "object": args.object, "view": args.view,
            "n": int(args.posterior_sample), "posterior_var": var,
        }))
        return
    if args.object is not None:
        y_views = synthesize_views(state, ds, args.object, **arch)
        truth = ds.images[args.object * ds.num_views:(args.object + 1) * ds.num_views]
        path = os.path.join(outdir, f"views_obj{args.object}.png")
        save_panel(path, [truth, y_views])
        print(json.dumps({"views_panel": path, "object": args.object}))
        return
    if args.sample:
        y_s = sample_prior(state, ds, args.sample, draw_seed=args.draw_seed,
                           **arch)
        path = os.path.join(outdir, "prior_samples.png")
        save_panel(path, [y_s])
        print(json.dumps({"samples_panel": path, "n": int(args.sample)}))
        return

    y_pred, mse = generate_heldout(state, ds, **arch)
    print(json.dumps({"heldout_mse": mse, "n_heldout": len(ds.heldout_idx)}))
    save_panel(
        os.path.join(outdir, "oos_panel.png"),
        [ds.images[ds.heldout_idx[:12]], y_pred[:12]],
    )


if __name__ == "__main__":
    main()

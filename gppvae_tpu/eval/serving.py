"""Serving path for conditional generation: precompute once, decode per
request.

The reference's OOS protocol (SURVEY.md §3.4; eval/oos.predict_heldout)
re-encodes ALL N training rows and re-factorizes the GP for every
evaluation — right for training-time monitoring, wasteful for serving. A
deployed model answers many (object, view) requests against ONE trained
state, so everything N-sized can be folded into an R-sized posterior core
up front (gp.posterior_core):

    build_server_state: one full encode (Phase-A machinery) + one Woodbury
        factorization + one K⁻¹Z solve  →  ServerState{core (R×L / R×R),
        X, W, variances, vae params}. O(N·R²) once; the state itself is
        O(R² + P·M + Q·M_w) — independent of N.
    predict_images: per request, build the feature rows for the asked
        (object, view) pairs (O(R) each), z* = U*·M, decode. The only
        O(pixels) work left is the decoder forward — the serving
        throughput ceiling is the decoder, not the GP or the dataset size.

Also returns the GP-predictive per-row latent variance on request
(return_var=True) — the serving-side uncertainty signal the training
monitor never needed.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from gppvae_tpu import gp
from gppvae_tpu.eval import exported_io
from gppvae_tpu.models import VAE, encode_all


class ServerState(NamedTuple):
    """Pytree snapshot a server holds per trained model (N-independent)."""

    core: gp.PosteriorCore  # (R,L) mean core + (R,R) variance factors
    X: jax.Array  # (P, M) object features
    W: jax.Array  # (Q, M_w) view features (learned or fixed)
    v_sig: jax.Array  # (n_eff,) signal variances
    vae_params: Any  # decoder (and encoder) params


def build_server_state(
    model,
    params,
    fixed_W,
    images_tr: jax.Array,
    d_tr: jax.Array,
    q_tr: jax.Array,
    *,
    x_map=None,
    extra_effects: tuple = (),
    encode_chunk: int = 1024,
    batch_sharding=None,
) -> ServerState:
    """Fold the training set into the R-sized posterior core (jittable).

    Runs the grad-free full encode (the trainer's Phase A), factorizes
    K = Σ_r v_r V_r V_rᵀ + v_n I, and solves the K⁻¹Z core once. Inputs
    mirror eval/oos.predict_heldout so trainer checkpoints serve directly.
    batch_sharding (parallel.row_sharding(mesh)): shard the fold's encode
    chunks over a mesh — the resulting core is tiny and replicated.
    """
    W = params["gp"].get("W", fixed_W)
    X = params["gp"]["X"]
    Z0 = encode_all(model, params["vae"], images_tr,
                    min(encode_chunk, images_tr.shape[0]),
                    batch_sharding=batch_sharding)
    V_tr = gp.build_effect_rows(X, W, d_tr, q_tr,
                                extra_effects=extra_effects, x_map=x_map)
    v_sig, v_noise = gp.variances_from_log(
        params["gp"]["log_vs"], params["gp"]["log_vn"]
    )
    v_sigs = [jnp.reshape(v_sig, (-1,))[i] for i in range(len(V_tr))]
    factors = gp.factorize(V_tr, v_sigs, v_noise)
    return ServerState(
        core=gp.posterior_core(factors, Z0),
        X=X, W=W, v_sig=jnp.reshape(v_sig, (-1,)),
        vae_params=params["vae"],
    )


def predict_images(
    model,
    state: ServerState,
    d: jax.Array,
    q: jax.Array,
    *,
    x_map=None,
    extra_effects: tuple = (),
    return_var: bool = False,
    batch_sharding=None,
):
    """Serve one request batch: images for (object, view) index vectors.

    O(R) GP work per row + one decoder forward; jit this with `model`,
    `x_map`, `extra_effects` closed over and `state` as a pytree argument.
    With return_var=True also returns the (n,) GP-predictive latent
    variance per requested row. batch_sharding (parallel.row_sharding):
    DP-serve a large request batch over a mesh — the state is replicated
    (R-sized), the request rows and decode shard.
    """
    V_star = gp.build_effect_rows(state.X, state.W, d, q,
                                  extra_effects=extra_effects, x_map=x_map)
    if len(V_star) != state.v_sig.shape[0]:
        # effect rows pair with v_sig entries purely by position — serving
        # with a different extra_effects tuple than at build time would
        # silently apply the wrong variances whenever ranks line up
        # (ADVICE.md round-2); the exported meta records the right tuple
        raise ValueError(
            f"extra_effects={extra_effects!r} builds {len(V_star)} effect(s) "
            f"but the server state carries {state.v_sig.shape[0]} variance(s); "
            "pass the extra_effects recorded in the artifact's meta"
        )
    v_sigs = [state.v_sig[i] for i in range(len(V_star))]
    out = gp.predict_from_core(V_star, state.core, v_sigs,
                               return_var=return_var)
    z_star, var = out if return_var else (out, None)
    if batch_sharding is not None:
        z_star = jax.lax.with_sharding_constraint(z_star, batch_sharding)
    y = jax.nn.sigmoid(model.apply(state.vae_params, z_star, method=VAE.decode))
    return (y, var) if return_var else y


def stable_cholesky(cov: jax.Array, jitter: float = 1e-6) -> jax.Array:
    """Cholesky with symmetrization + SCALE-RELATIVE jitter (ADVICE.md
    round-4): the analytic eigenvalue floor of Cov = U*B⁻¹U*ᵀ + vₙI is vₙ,
    itself floored at 1e-6 — but f32 roundoff in the U*B⁻¹U*ᵀ product grows
    with the core's scale, so for large-R cores with duplicated request
    rows an ABSOLUTE 1e-6 jitter can sit below the roundoff and yield NaN
    draws. jitter is scaled by mean(diag) (≥1 so small covs keep the
    absolute floor), and (C+Cᵀ)/2 removes the asymmetric half of the
    roundoff outright."""
    cov = 0.5 * (cov + cov.T)
    scale = jnp.maximum(1.0, jnp.mean(jnp.diagonal(cov)))
    eye = jnp.eye(cov.shape[0], dtype=cov.dtype)
    return jnp.linalg.cholesky(cov + (jitter * scale) * eye)


def decode_images(model, vae_params, z: jax.Array, chunk: int | None = 512):
    """sigmoid(decode(z)) in bounded chunks (round-4 VERDICT Weak #3): a
    joint K-sample over an n-request batch decodes n·K latent rows, and ONE
    decoder forward at face 128² costs ~0.6 MB of output per row — a
    400-request × K=10 joint sample was a single 4000-row forward, an
    OOM/latency cliff with no cap. Chunking bounds the live activation
    footprint to `chunk` rows (default 512 ≈ 100 MB of f32 output at face
    128²) with zero math change; rows ≤ chunk (every interactive request)
    still take exactly one forward. chunk=None disables (required under
    jax.export's symbolic batch, where n is not a Python int — deployments
    control the request size instead)."""
    n = z.shape[0]
    if chunk is None or not isinstance(n, int) or n <= chunk:
        return jax.nn.sigmoid(model.apply(vae_params, z, method=VAE.decode))
    pad = (-n) % chunk
    zp = jnp.pad(z, ((0, pad), (0, 0))).reshape(-1, chunk, z.shape[1])
    y = jax.lax.map(
        lambda zz: jax.nn.sigmoid(model.apply(vae_params, zz, method=VAE.decode)),
        zp,
    )
    return y.reshape(-1, *y.shape[2:])[:n]


def sample_images(
    model,
    state: ServerState,
    d: jax.Array,
    q: jax.Array,
    key: jax.Array,
    num_samples: int,
    *,
    x_map=None,
    extra_effects: tuple = (),
    joint: bool = False,
    jitter: float = 1e-6,
    decode_chunk: int | None = 512,
):
    """Posterior SAMPLING at serve time: K decoded draws per requested
    (object, view) row from N(μ*, σ*² I_L), using the folded core's mean
    AND variance (the serving counterpart of the generate CLI's
    --posterior_sample). Returns (n, K, H, W, C) — per-request uncertainty
    rendered as image diversity, still O(R) GP work + K decoder forwards
    per row and N-independent.

    joint=True draws COHERENT samples across the whole request batch from
    the full n×n posterior covariance (gp.predict_cov_from_core): sample k
    is one consistent scene over all requested cells — rows of the same
    object keep their posterior correlation (e.g. all views of one object
    vary together), which independent per-row draws (the default, and the
    only thing a diagonal variance can do) throw away. Cost on top of the
    diagonal path: one n×n Cholesky per batch (jitter stabilizes it —
    duplicate request rows make Cov + v_n I nearly rank-deficient when
    v_n is tiny)."""
    V_star = gp.build_effect_rows(state.X, state.W, d, q,
                                  extra_effects=extra_effects, x_map=x_map)
    if len(V_star) != state.v_sig.shape[0]:
        raise ValueError(
            f"extra_effects={extra_effects!r} builds {len(V_star)} effect(s) "
            f"but the server state carries {state.v_sig.shape[0]} variance(s); "
            "pass the extra_effects recorded in the artifact's meta"
        )
    v_sigs = [state.v_sig[i] for i in range(len(V_star))]
    if joint:
        mean, cov = gp.predict_cov_from_core(V_star, state.core, v_sigs)
        n, L = mean.shape
        Lc = stable_cholesky(cov, jitter)
        eps = jax.random.normal(key, (n, num_samples, L), mean.dtype)
        # z[:, k, l] = mean[:, l] + Lc @ eps[:, k, l] — per (sample, dim)
        # the draw is one correlated n-vector over the request rows
        z = mean[:, None, :] + jnp.einsum("ij,jkl->ikl", Lc, eps)
        y = decode_images(model, state.vae_params,
                          z.reshape(n * num_samples, L), decode_chunk)
        return y.reshape(n, num_samples, *y.shape[1:])
    mean, var = gp.predict_from_core(V_star, state.core, v_sigs,
                                     return_var=True)
    n, L = mean.shape
    eps = jax.random.normal(key, (n, num_samples, L), mean.dtype)
    z = mean[:, None, :] + jnp.sqrt(jnp.maximum(var, 0.0))[:, None, None] * eps
    y = decode_images(model, state.vae_params,
                      z.reshape(n * num_samples, L), decode_chunk)
    return y.reshape(n, num_samples, *y.shape[1:])


def observe(
    model,
    state: ServerState,
    images: jax.Array,
    d: jax.Array,
    q: jax.Array,
    *,
    x_map=None,
    extra_effects: tuple = (),
    encode_chunk: int = 1024,
    row_mask: jax.Array | None = None,
    batch_sharding=None,
) -> ServerState:
    """Fold NEW observed images into the serving posterior — streaming
    conditioning at the server, no training set and no training step.

    Encodes the new images (the same amortized-inference encoder the fold
    used), builds their (object, view) feature rows from the state's own
    X/W, and extends the R-sized core (gp.extend_posterior_core) in
    O(n·R² + R³): exactly the state build_server_state would have produced
    had these rows been in the training set (tested), for the cost of one
    n-row encode. Predictions for the observed cells sharpen immediately —
    predictive variance is monotonically non-increasing in observations.
    The reference's closest move is re-running the whole OOS pipeline over
    the enlarged dataset (SURVEY.md §3.4 re-encodes all N per call).

    The GP/VAE parameters are NOT updated — this is Bayesian conditioning,
    not training; observations of objects/views outside the trained P×Q
    grid need a training run (their X/W rows don't exist).

    row_mask (n,) ∈ {0, 1}: weight-0 rows contribute NOTHING to the update
    (their scaled feature row is zeroed, so both U₊ᵀU₊ and U₊ᵀZ₊ drop
    them exactly) — lets a fixed-shape compiled fold absorb variable-sized
    observation batches by padding, the same XLA-native discipline the
    stdin request loop uses.

    batch_sharding (parallel.row_sharding(mesh)): shard the new rows'
    encode over a mesh, exactly like build_server_state's fold — the
    extended core stays tiny and replicated."""
    V_new = gp.build_effect_rows(state.X, state.W, d, q,
                                 extra_effects=extra_effects, x_map=x_map)
    if row_mask is not None:
        m = row_mask.astype(V_new[0].dtype)[:, None]
        V_new = [v * m for v in V_new]
    if len(V_new) != state.v_sig.shape[0]:
        raise ValueError(
            f"extra_effects={extra_effects!r} builds {len(V_new)} effect(s) "
            f"but the server state carries {state.v_sig.shape[0]} variance(s); "
            "pass the extra_effects recorded in the artifact's meta"
        )
    Z_new = encode_all(model, state.vae_params, images,
                       min(encode_chunk, images.shape[0]),
                       batch_sharding=batch_sharding)
    v_sigs = [state.v_sig[i] for i in range(len(V_new))]
    core2 = gp.extend_posterior_core(state.core, V_new, v_sigs, Z_new)
    return state._replace(core=core2)


def save_server_state(
    path: str, state: ServerState, meta: dict | None = None,
    nystrom_idx=None,
) -> None:
    """Persist the folded state so a server boots without the training set
    (the deployment artifact: O(R²) + params, not O(N·pixels)).

    `meta` records how the feature rows must be rebuilt at serve time —
    object_kernel kind, rff_features/lengthscale/seed, extra_effects,
    model architecture — written as a JSON sidecar `<path>.meta.json`.
    Without it a server could silently rebuild the WRONG feature map (a
    linear map of coincidentally matching rank returns garbage, not an
    error). `nystrom_idx` (landmark indices, rbf-nystrom kernel) rides in
    the array tree itself.
    """
    import json
    import os

    from gppvae_tpu.checkpoint import save_pytree

    d = state._asdict()
    d["core"] = state.core._asdict()
    if nystrom_idx is not None:
        d["nystrom_idx"] = jnp.asarray(nystrom_idx)
    save_pytree(path, d)
    with open(os.path.abspath(os.path.expanduser(path)) + ".meta.json", "w") as f:
        json.dump(meta or {}, f, indent=1, default=list)


def load_server_state(
    path: str, *, allow_missing_meta: bool = False
) -> tuple[ServerState, dict]:
    """Returns (state, meta). meta carries the kernel/architecture config
    recorded at export; rebuild the feature map with `x_map_from_meta`.

    Fails loudly when the `.meta.json` sidecar is missing (ADVICE.md
    round-2): without it an RBF-exported artifact would silently be served
    with a default linear feature map — garbage predictions whenever the
    ranks coincide, not an error. allow_missing_meta=True opts back in for
    artifacts known to use every default.
    """
    import json
    import os

    from gppvae_tpu.checkpoint import load_pytree

    d = dict(load_pytree(path))
    core = gp.PosteriorCore(**{k: jnp.asarray(v) for k, v in d.pop("core").items()})
    nystrom_idx = d.pop("nystrom_idx", None)
    meta = {}
    meta_path = os.path.abspath(os.path.expanduser(path)) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    elif not allow_missing_meta:
        raise FileNotFoundError(
            f"server-state sidecar {meta_path} not found: it records the "
            "feature-map config (object_kernel, rff seed/rank, extra_effects) "
            "needed to serve this artifact correctly. Restore it next to the "
            "checkpoint, or pass allow_missing_meta=True to serve with "
            "all-default settings at your own risk."
        )
    if nystrom_idx is not None:
        meta["nystrom_idx"] = nystrom_idx
    return ServerState(core=core, **d), meta


# exported-program entry points (round-4 VERDICT Missing #4: the v1 blob
# covered posterior MEANS only — the uncertainty surface the serving path
# is proudest of all required the package + .srv path). Each entry is its
# own jax.export blob file (jax.export serializes one callable per blob);
# the meta's `entry_points` table names them with their calling
# conventions. `seed` is a scalar int32 argument (PRNGKey is built inside
# the program); `k_dummy` is a zeros int32[K] vector whose LENGTH carries
# the per-request sample count — jax.export resolves it as a second
# symbolic dimension, so one blob serves every K without recompiling.
_EXE_ENTRIES = {
    "mean": {"suffix": "", "sig": "call(d:i32[b], q:i32[b]) -> y[b,H,W,C]"},
    "var": {"suffix": ".var",
            "sig": "call(d, q) -> (y[b,H,W,C], var:f32[b])"},
    "sample": {"suffix": ".sample",
               "sig": "call(d, q, seed:i32[], k_dummy:i32[k]) -> "
                      "y[b,k,H,W,C]  (independent per-row draws)"},
    "sample_joint": {"suffix": ".joint",
                     "sig": "call(d, q, seed:i32[], k_dummy:i32[k]) -> "
                            "y[b,k,H,W,C]  (one coherent scene per draw "
                            "via the full b×b posterior covariance)"},
    "observe": {"suffix": ".observe",
                "sig": "call(core{M,G,Lb,v_noise}, images:f32[b,H,W,C], "
                       "d, q, mask:f32[b]) -> core'  (streaming "
                       "conditioning; mask 0-rows are ignored)"},
    "sample_core": {"suffix": ".sample_core",
                    "sig": "call(core{M,G,Lb,v_noise}, d, q, seed:i32[], "
                           "k_dummy:i32[k]) -> y[b,k,H,W,C]  (independent "
                           "per-row draws from an observe-updated core)"},
    "sample_joint_core": {"suffix": ".joint_core",
                          "sig": "call(core{M,G,Lb,v_noise}, d, q, "
                                 "seed:i32[], k_dummy:i32[k]) -> "
                                 "y[b,k,H,W,C]  (coherent scenes from the "
                                 "updated core's full b×b posterior "
                                 "covariance)"},
    "predict_core": {"suffix": ".predict",
                     "sig": "call(core{M,G,Lb,v_noise}, d, q) -> "
                            "(y[b,H,W,C], var:f32[b])  (serve from an "
                            "observe-updated core; initial core in "
                            "<path>.core.npz)"},
}


def _ensure_core_serialization() -> None:
    """Register PosteriorCore for jax.export pytree serialization (the
    stateful entry points pass it as an argument/result). Idempotent —
    jax raises on re-registration."""
    from jax import export as jexport

    try:
        jexport.register_namedtuple_serialization(
            gp.PosteriorCore, serialized_name="gppvae_tpu.gp.PosteriorCore"
        )
    except ValueError:
        pass


def export_compiled_program(
    model, state: ServerState, path: str, *, x_map=None, extra_effects=(),
    platforms: tuple = ("cuda", "cpu"),
    entry_points: tuple = tuple(_EXE_ENTRIES),
) -> dict:
    """Serialize the WHOLE serving surface with `jax.export`: server state
    (posterior core + decoder weights) baked in as constants, the batch
    (and sample-count) dimensions symbolic, lowered for every requested
    platform up front.

    This is the step beyond the `.srv` artifact: `.srv` + meta needs this
    package at serve time to rebuild the decoder; the exported programs are
    self-contained StableHLO blobs a deployment runs with
    `exported_io.deserialize(blob).call(...)` — no model code, no feature
    maps, no version skew (jax.export's calling convention is versioned),
    and no flatbuffers package.
    The reference's closest artifact is a torch.save of weights alone
    (SURVEY.md §5 checkpoint row), which always needs the source tree.

    Entry points (see _EXE_ENTRIES): posterior means, means+variance,
    K-sample (independent and joint — seed as an argument, K symbolic),
    and the STATEFUL quartet `observe`/`predict_core`/`sample_core`/
    `sample_joint_core` which take the R-sized posterior core as an
    explicit pytree argument, so a deployment can stream new observations
    (core' = observe(core, images, d, q, mask)) and serve the sharpened
    posterior's means, variances AND draws — without this package. The
    initial core rides in `<path>.core.npz`.

    Writes `<path>` (+ suffixed blobs per entry) and `<path>.meta.json`
    (grid bounds for request validation, entry-point table, provenance).
    Returns the meta dict.
    """
    import json
    import os

    import numpy as np
    from jax import export as jexport

    unknown = set(entry_points) - set(_EXE_ENTRIES)
    if unknown:
        raise ValueError(f"unknown export entry points: {sorted(unknown)}")
    _ensure_core_serialization()

    b, k = jexport.symbolic_shape("b, k")
    i_b = jax.ShapeDtypeStruct((b,), jnp.int32)
    i_scalar = jax.ShapeDtypeStruct((), jnp.int32)
    i_k = jax.ShapeDtypeStruct((k,), jnp.int32)
    f_img = jax.ShapeDtypeStruct((b, *model.image_shape), jnp.float32)
    f_b = jax.ShapeDtypeStruct((b,), jnp.float32)
    core_specs = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state.core
    )

    def _sample_fn(joint):
        def fn(d, q, seed, k_dummy):
            # k_dummy's length IS the sample count; its values are unused
            return sample_images(
                model, state, d, q, jax.random.PRNGKey(seed),
                k_dummy.shape[0], x_map=x_map, extra_effects=extra_effects,
                joint=joint, decode_chunk=None,
            )
        return fn

    def _observe_fn(core, images, d, q, mask):
        # encode_all's python-side chunking can't run under a symbolic
        # batch — one encoder forward instead (the CLI/deployment chunks
        # large observation batches before the call, like the stdin loop)
        V_new = gp.build_effect_rows(state.X, state.W, d, q,
                                     extra_effects=extra_effects, x_map=x_map)
        m = mask.astype(V_new[0].dtype)[:, None]
        V_new = [v * m for v in V_new]
        Z_new, _ = model.apply(state.vae_params, images, method=VAE.encode)
        v_sigs = [state.v_sig[i] for i in range(len(V_new))]
        return gp.extend_posterior_core(core, V_new, v_sigs, Z_new)

    def _predict_core_fn(core, d, q):
        return predict_images(model, state._replace(core=core), d, q,
                              x_map=x_map, extra_effects=extra_effects,
                              return_var=True)

    def _sample_core_fn(joint):
        # the stateful counterpart of _sample_fn: without it, a deployment
        # that streamed observations via `observe` could get means/vars
        # from the sharpened posterior (predict_core) but NOT draws — the
        # uncertainty surface went stale the moment the core moved
        def fn(core, d, q, seed, k_dummy):
            return sample_images(
                model, state._replace(core=core), d, q,
                jax.random.PRNGKey(seed), k_dummy.shape[0], x_map=x_map,
                extra_effects=extra_effects, joint=joint, decode_chunk=None,
            )
        return fn

    builders = {
        "mean": (
            lambda d, q: predict_images(model, state, d, q, x_map=x_map,
                                        extra_effects=extra_effects),
            (i_b, i_b),
        ),
        "var": (
            lambda d, q: predict_images(model, state, d, q, x_map=x_map,
                                        extra_effects=extra_effects,
                                        return_var=True),
            (i_b, i_b),
        ),
        "sample": (_sample_fn(joint=False), (i_b, i_b, i_scalar, i_k)),
        "sample_joint": (_sample_fn(joint=True), (i_b, i_b, i_scalar, i_k)),
        "observe": (_observe_fn, (core_specs, f_img, i_b, i_b, f_b)),
        "predict_core": (_predict_core_fn, (core_specs, i_b, i_b)),
        "sample_core": (_sample_core_fn(joint=False),
                        (core_specs, i_b, i_b, i_scalar, i_k)),
        "sample_joint_core": (_sample_core_fn(joint=True),
                              (core_specs, i_b, i_b, i_scalar, i_k)),
    }

    apath = os.path.abspath(os.path.expanduser(path))
    entries = {}
    for name in entry_points:
        fn, specs = builders[name]
        exp = jexport.export(jax.jit(fn), platforms=tuple(platforms))(*specs)
        blob = exported_io.serialize(exp)
        fname = apath + _EXE_ENTRIES[name]["suffix"]
        with open(fname, "wb") as f:
            f.write(blob)
        entries[name] = {
            "file": os.path.basename(fname),
            "sig": _EXE_ENTRIES[name]["sig"],
            "bytes": len(blob),
        }
    core_npz = None
    if any(e in entries for e in
           ("observe", "predict_core", "sample_core", "sample_joint_core")):
        core_npz = apath + ".core.npz"
        np.savez(core_npz, **{f: np.asarray(v)
                              for f, v in state.core._asdict().items()})
    meta = {
        "format": "jax.export.v2",
        "grid": [int(state.X.shape[0]), int(state.W.shape[0])],
        "image_shape": [int(s) for s in model.image_shape],
        "platforms": list(platforms),
        "entry_points": entries,
        "core_npz": os.path.basename(core_npz) if core_npz else None,
        "bytes": entries.get("mean", {}).get("bytes"),
    }
    with open(apath + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_compiled_program(path: str, entry: str = "mean"):
    """Returns (exported, meta) for an `export_compiled_program` artifact;
    the exported callable answers requests directly with the calling
    convention recorded in meta["entry_points"][entry]["sig"] (v1 artifacts
    carry only the means program). `entry="core"` instead returns
    (PosteriorCore, meta) from the `<path>.core.npz` initial-state sidecar
    of the stateful entries."""
    import json
    import os

    import numpy as np
    from jax import export as jexport

    _ensure_core_serialization()
    apath = os.path.abspath(os.path.expanduser(path))
    meta_path = apath + ".meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"compiled-program sidecar {meta_path} not found: it records "
            "the grid bounds used to validate requests."
        )
    with open(meta_path) as f:
        meta = json.load(f)
    fmt = meta.get("format")
    if fmt == "jax.export.v1":
        # round-4 artifacts: one blob, means only
        if entry not in ("mean",):
            raise ValueError(
                f"{path!r} is a v1 artifact (posterior means only); "
                f"entry {entry!r} needs a v2 re-export (serve --state … "
                "--export_exe)"
            )
        entry_file = os.path.basename(apath)
    elif fmt == "jax.export.v2":
        if entry == "core":
            if not meta.get("core_npz"):
                raise ValueError(
                    f"{path!r} was exported without the stateful entries — "
                    "no core sidecar"
                )
            with np.load(os.path.join(os.path.dirname(apath),
                                      meta["core_npz"])) as f:
                core = gp.PosteriorCore(
                    **{kk: jnp.asarray(f[kk]) for kk in f.files}
                )
            return core, meta
        if entry not in meta.get("entry_points", {}):
            raise ValueError(
                f"{path!r} exports {sorted(meta.get('entry_points', {}))}; "
                f"no entry {entry!r}"
            )
        entry_file = meta["entry_points"][entry]["file"]
    else:
        raise ValueError(
            f"{path!r} records format {fmt!r}; this build reads "
            "jax.export.v1/v2"
        )
    with open(os.path.join(os.path.dirname(apath), entry_file), "rb") as f:
        blob = f.read()
    # blobs written before exported_io are jax.export flatbuffers, which
    # need the optional flatbuffers package to read
    if blob.startswith(exported_io.MAGIC):
        return exported_io.deserialize(blob), meta
    return jexport.deserialize(blob), meta


def x_map_from_meta(meta: dict, in_dim: int):
    """Rebuild the object-kernel feature map an artifact was exported with
    (gp.make_x_map over the recorded meta; None for the linear kernel)."""
    return gp.make_x_map(
        meta.get("object_kernel", "linear"), in_dim,
        meta.get("rff_features", 32), meta.get("rff_lengthscale", 1.0),
        meta.get("seed", 0), meta.get("nystrom_idx"),
    )


def _load_observation_npz(path: str, P: int, Q: int, image_shape, err=ValueError):
    """Load + validate an observation npz (images + objects/views, with
    GridDataset's object_ids/view_ids key aliases). ONE loader for all
    three observe surfaces (--state CLI, --stdin loop, --exe blobs) —
    their hand-rolled copies had already diverged on which checks they ran
    (round-5 review: the --exe copy skipped the n-agreement check, so a
    ragged npz died deep inside jax.export's symbolic-dim solver instead
    of here). `err` picks the error type: SystemExit at CLI entry points,
    ValueError where callers catch-and-report (the stdin loop)."""
    import numpy as np

    with np.load(path, allow_pickle=False) as f:
        keys = set(f.files)
        try:
            imgs = np.asarray(f["images"], np.float32)
            d = np.asarray(
                f["objects" if "objects" in keys else "object_ids"], np.int32)
            q = np.asarray(
                f["views" if "views" in keys else "view_ids"], np.int32)
        except KeyError as e:
            raise err(
                f"observation npz {path!r} lacks {e}; want images + "
                "objects/views (or object_ids/view_ids)"
            )
    if tuple(imgs.shape[1:]) != tuple(image_shape):
        raise err(
            f"observed images are {tuple(imgs.shape[1:])} but the model "
            f"serves {tuple(image_shape)}"
        )
    if not (imgs.shape[0] == d.shape[0] == q.shape[0]):
        raise err("observation npz arrays disagree on n")
    if ((d < 0) | (d >= P) | (q < 0) | (q >= Q)).any():
        raise err(
            f"observed cells outside the {P}×{Q} grid — conditioning can "
            "only absorb observations of known objects/views (new ones "
            "need a training run)"
        )
    return imgs, d, q


def _parse_requests(s: str, P: int, Q: int, err=ValueError) -> list[tuple[int, int]]:
    """Parse + grid-validate a 'd:q,d:q,…' request string. ONE parser for
    all three request surfaces (--state, --exe, --stdin) — the hand-rolled
    copies let a malformed token ('3', '3:2:5', 'a:b') die as a raw
    tuple-unpack/int traceback at two CLI entry points instead of a clean
    message. `err` picks the error type: SystemExit at CLI entry points,
    ValueError where callers catch-and-report (the stdin loop)."""
    pairs = []
    for tok in s.split(","):
        parts = tok.split(":")
        try:
            if len(parts) != 2:
                raise ValueError(tok)
            d0, q0 = int(parts[0]), int(parts[1])
        except ValueError:
            raise err(
                f"bad request {tok.strip()!r}: want object:view, e.g. 3:2"
            ) from None
        if not (0 <= d0 < P and 0 <= q0 < Q):
            raise err(f"request {d0}:{q0} outside the {P}×{Q} grid")
        pairs.append((d0, q0))
    return pairs


def _serve_stdin_loop(model, state: ServerState, x_map, extra: tuple,
                      args, lines=None, meta: dict | None = None) -> None:
    """Persistent ONLINE serving loop (serve --stdin): one command per input
    line, one JSON response line each, EOF ends. Commands:

        d:q,d:q,…         answer a request batch (writes a .npz per batch)
        observe <npz>     fold new observed images into the posterior
                          (streaming conditioning — subsequent requests are
                          answered from the sharpened posterior)
        save <path>       persist the current (possibly updated) server
                          state + .meta.json sidecar

    Shape discipline: every line is padded (and, past --max_batch,
    chunked) to ONE fixed batch size, so the whole loop runs a single
    compiled program per command kind — a varying-length
    request/observation stream never triggers a recompile (a naive
    per-shape jit would compile on every new batch size). The observe fold pads with
    weight-0 rows (observe's row_mask) for the same reason; its program
    compiles lazily on the first observe line so pure request streams
    never pay for it. The state is a pytree ARGUMENT of the compiled
    programs, so a fold swaps it without recompiling anything.
    `lines` overrides sys.stdin for tests."""
    import json
    import os
    import sys
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    B = int(args.max_batch)
    if B < 1:
        raise SystemExit("serve: --max_batch must be >= 1")
    P, Q = int(state.X.shape[0]), int(state.W.shape[0])
    served = jax.jit(
        lambda s, dd, qq: predict_images(model, s, dd, qq, x_map=x_map,
                                         extra_effects=extra, return_var=True)
    )
    zeros = jnp.zeros((B,), jnp.int32)
    jax.block_until_ready(served(state, zeros, zeros))  # the ONE compile
    fold = jax.jit(
        lambda s, imgs, dd, qq, m: observe(model, s, imgs, dd, qq,
                                           x_map=x_map, extra_effects=extra,
                                           row_mask=m)
    )  # compiled lazily: first observe line pays it, request lines don't
    os.makedirs(args.outdir, exist_ok=True)
    print(json.dumps({"ready": True, "grid": [P, Q], "max_batch": B,
                      "commands": ["d:q,…", "observe <npz>", "save <path>"]}),
          flush=True)

    def _observe_line(k: int, path: str) -> None:
        nonlocal state
        imgs, dd, qq = _load_observation_npz(path, P, Q, model.image_shape)
        n = imgs.shape[0]
        t0 = time.perf_counter()
        for s0 in range(0, n, B):
            chunk = slice(s0, min(s0 + B, n))
            m = chunk.stop - chunk.start
            ib = np.zeros((B, *model.image_shape), np.float32)
            db = np.zeros((B,), np.int32)
            qb = np.zeros((B,), np.int32)
            mask = np.zeros((B,), np.float32)
            ib[:m], db[:m], qb[:m], mask[:m] = imgs[chunk], dd[chunk], qq[chunk], 1.0
            state = fold(state, jnp.asarray(ib), jnp.asarray(db),
                         jnp.asarray(qb), jnp.asarray(mask))
        jax.block_until_ready(state.core.M)
        print(json.dumps({
            "line": k, "observed": int(n),
            "fold_s": round(time.perf_counter() - t0, 5),
        }), flush=True)

    for k, line in enumerate(lines if lines is not None else sys.stdin):
        line = line.strip()
        if not line:
            continue
        if line.startswith("observe ") or line.startswith("save "):
            try:
                if line.startswith("observe "):
                    _observe_line(k, line[len("observe "):].strip())
                else:
                    path = line[len("save "):].strip()
                    save_meta = {kk: v for kk, v in (meta or {}).items()
                                 if kk != "nystrom_idx"}
                    save_server_state(path, state, meta=save_meta,
                                      nystrom_idx=(meta or {}).get("nystrom_idx"))
                    print(json.dumps({"line": k, "saved": path}), flush=True)
            except (ValueError, OSError) as e:
                print(json.dumps({"line": k, "error": str(e)}), flush=True)
            continue
        try:
            pairs = _parse_requests(line, P, Q)
        except ValueError as e:
            print(json.dumps({"line": k, "error": str(e)}), flush=True)
            continue
        t0 = time.perf_counter()
        d_all = np.fromiter((r[0] for r in pairs), np.int32)
        q_all = np.fromiter((r[1] for r in pairs), np.int32)
        imgs, var = [], []
        for s0 in range(0, len(pairs), B):
            dd = np.zeros((B,), np.int32)
            qq = np.zeros((B,), np.int32)
            chunk = slice(s0, min(s0 + B, len(pairs)))
            n = chunk.stop - chunk.start
            dd[:n], qq[:n] = d_all[chunk], q_all[chunk]
            y, v = served(state, jnp.asarray(dd), jnp.asarray(qq))
            imgs.append(np.asarray(y[:n]))
            var.append(np.asarray(v[:n]))
        y = np.concatenate(imgs, axis=0)
        var = np.concatenate(var, axis=0)
        npz = os.path.join(args.outdir, f"served_{k:04d}.npz")
        np.savez_compressed(npz, images=y, objects=d_all, views=q_all,
                            posterior_var=var)
        print(json.dumps({
            "line": k, "n_requests": len(pairs),
            "latency_s": round(time.perf_counter() - t0, 5),
            "posterior_var": [round(float(v0), 6) for v0 in var],
            "npz": npz,
        }), flush=True)


def _repeat_throughput(call, d, q, P: int, Q: int, repeat: int) -> dict:
    """Sustained-rate measurement shared by the --state and --exe serve
    paths: request indices rotated per rep (different grid cells) and the
    full image batch read back. Rotated index vectors are built in NUMPY
    and device_put — baking the changing python int i into an eager jnp op
    would dispatch a fresh constant-folded program per rep."""
    import time

    import numpy as np

    _ = jax.device_get(call(d, q))  # compile/warm outside the timing
    d_np, q_np = np.asarray(d), np.asarray(q)
    reqs = [
        (jax.device_put((d_np + i + 1) % P),
         jax.device_put((q_np + i + 1) % Q))
        for i in range(repeat)
    ]
    jax.block_until_ready(reqs)
    reps = []
    for dd, qq in reqs:
        t0 = time.perf_counter()
        _ = jax.device_get(call(dd, qq))
        reps.append(time.perf_counter() - t0)
    return {
        "repeat": repeat,
        "repeat_latency_s_min": round(min(reps), 5),
        "repeat_latency_s_median": round(sorted(reps)[len(reps) // 2], 5),
        "images_per_sec": round(len(d_np) / min(reps)),
    }


def _sustained_throughput(call, d, q, P: int, Q: int, k: int) -> dict:
    """bench.py's oos_serving protocol for the serve CLI: k rotated request
    batches answered inside ONE jit dispatch (lax.scan), per-image checksum
    readback only — measures decode CAPACITY. `--repeat` (full image
    readback per batch) measures the end-to-end wall path instead, which
    includes the device-to-host copy of every image, so only the sustained
    number is comparable to bench.py's. The checksum depends on every
    decoded pixel, so no decode can be skipped."""
    import time

    import numpy as np

    @jax.jit
    def burst(d0, q0):
        def step(_, i):
            y = call((d0 + i) % P, (q0 + i) % Q)
            return None, jnp.sum(y, axis=tuple(range(1, y.ndim)))

        _, sums = jax.lax.scan(step, None, jnp.arange(k, dtype=jnp.int32))
        return sums

    _ = jax.device_get(burst(d, q))  # compile/warm outside the timing
    d_np = np.asarray(d)
    # rotated request vectors materialized OUTSIDE the timed window (a
    # changing Python int inside it would add eager dispatches)
    reqs = [jax.device_put((d_np + 7 * i + 1) % P) for i in range(3)]
    jax.block_until_ready(reqs)
    reps = []
    for dd in reqs:
        t0 = time.perf_counter()
        _ = jax.device_get(burst(dd, q))
        reps.append(time.perf_counter() - t0)
    return {
        "sustained_chain": k,
        "sustained_latency_s_min": round(min(reps), 5),
        "sustained_images_per_sec": round(k * len(d_np) / min(reps)),
    }


def _serve_exe_stdin_loop(args, lines=None) -> None:
    """Persistent ONLINE serving from the BLOBS alone (`serve --exe
    --stdin`) — the zero-package-code counterpart of the --state loop.
    Commands per input line, one JSON response line each, EOF ends:

        d:q,d:q,…         answer a request batch from the CURRENT core
                          (predict_core entry: means + variances)
        observe <npz>     fold new observed images into the core
                          (observe entry — streaming conditioning)
        save <path>       persist the current core as a plain npz
                          (reloadable via --core / np.load)

    Same fixed-batch discipline as the --state loop: a deserialized
    jax.export program is shape-POLYMORPHIC in its StableHLO but still
    compiles one executable per CONCRETE batch size at call time, so a
    varying-length stream would recompile per new length. Every line is
    padded (and chunked past
    --max_batch) to ONE size per command kind; predict_core's pad rows
    are valid (0:0) cells sliced off the reply, observe's pad rows are
    dropped exactly by the mask argument. `lines` overrides sys.stdin
    for tests."""
    import json
    import os
    import sys
    import time

    import numpy as np

    B = int(args.max_batch)
    if B < 1:
        raise SystemExit("serve: --max_batch must be >= 1")
    exp_pc, meta = load_compiled_program(args.exe, entry="predict_core")
    if args.core:
        with np.load(args.core) as f:
            core = gp.PosteriorCore(**{k: jnp.asarray(f[k]) for k in f.files})
    else:
        core, _ = load_compiled_program(args.exe, entry="core")
    P, Q = meta["grid"]
    zeros = jnp.zeros((B,), jnp.int32)
    jax.block_until_ready(exp_pc.call(core, zeros, zeros))  # the ONE compile
    exp_obs = None  # observe blob loads+compiles on the first observe line
    os.makedirs(args.outdir, exist_ok=True)
    print(json.dumps({"ready": True, "grid": [P, Q], "max_batch": B,
                      "exe": args.exe,
                      "commands": ["d:q,…", "observe <npz>", "save <path>"]}),
          flush=True)

    def _observe_line(k: int, path: str) -> None:
        nonlocal core, exp_obs
        if exp_obs is None:
            exp_obs = load_compiled_program(args.exe, entry="observe")[0]
        imgs, dd, qq = _load_observation_npz(path, P, Q, meta["image_shape"])
        n = imgs.shape[0]
        t0 = time.perf_counter()
        for s0 in range(0, n, B):
            chunk = slice(s0, min(s0 + B, n))
            m = chunk.stop - chunk.start
            ib = np.zeros((B, *meta["image_shape"]), np.float32)
            db = np.zeros((B,), np.int32)
            qb = np.zeros((B,), np.int32)
            mask = np.zeros((B,), np.float32)
            ib[:m], db[:m], qb[:m], mask[:m] = imgs[chunk], dd[chunk], qq[chunk], 1.0
            core = exp_obs.call(core, jnp.asarray(ib), jnp.asarray(db),
                                jnp.asarray(qb), jnp.asarray(mask))
        jax.block_until_ready(core.M)
        print(json.dumps({
            "line": k, "observed": int(n),
            "fold_s": round(time.perf_counter() - t0, 5),
        }), flush=True)

    for k, line in enumerate(lines if lines is not None else sys.stdin):
        line = line.strip()
        if not line:
            continue
        if line.startswith("observe ") or line.startswith("save "):
            try:
                if line.startswith("observe "):
                    _observe_line(k, line[len("observe "):].strip())
                else:
                    path = line[len("save "):].strip()
                    np.savez(path, **{f: np.asarray(v)
                                      for f, v in core._asdict().items()})
                    print(json.dumps({"line": k, "saved": path}), flush=True)
            except (ValueError, OSError) as e:
                print(json.dumps({"line": k, "error": str(e)}), flush=True)
            continue
        try:
            pairs = _parse_requests(line, P, Q)
        except ValueError as e:
            print(json.dumps({"line": k, "error": str(e)}), flush=True)
            continue
        t0 = time.perf_counter()
        d_all = np.fromiter((r[0] for r in pairs), np.int32)
        q_all = np.fromiter((r[1] for r in pairs), np.int32)
        imgs, var = [], []
        for s0 in range(0, len(pairs), B):
            dd = np.zeros((B,), np.int32)
            qq = np.zeros((B,), np.int32)
            chunk = slice(s0, min(s0 + B, len(pairs)))
            n = chunk.stop - chunk.start
            dd[:n], qq[:n] = d_all[chunk], q_all[chunk]
            y, v = exp_pc.call(core, jnp.asarray(dd), jnp.asarray(qq))
            imgs.append(np.asarray(y[:n]))
            var.append(np.asarray(v[:n]))
        y = np.concatenate(imgs, axis=0)
        var = np.concatenate(var, axis=0)
        npz = os.path.join(args.outdir, f"served_{k:04d}.npz")
        np.savez_compressed(npz, images=y, objects=d_all, views=q_all,
                            posterior_var=var)
        print(json.dumps({
            "line": k, "n_requests": len(pairs),
            "latency_s": round(time.perf_counter() - t0, 5),
            "posterior_var": [round(float(v0), 6) for v0 in var],
            "npz": npz,
        }), flush=True)


def _serve_exe(args) -> None:
    """Answer --requests straight from a compiled-program artifact
    (`--export_exe` output): deserialize the requested entry point,
    validate against the recorded grid, call — no model rebuild, no
    feature maps, no package code in the serving path. v2 artifacts carry
    the full serving surface: --var (means+variance), --sample K
    [--joint] (posterior draws; seed is a program ARGUMENT, K a symbolic
    dimension, so neither triggers a recompile)."""
    import json
    import os
    import time

    import numpy as np

    from gppvae_tpu.eval.panels import save_panel

    core = None
    if args.core:
        # stateful flow from the blobs alone: the (observe-updated) core is
        # the only state, persisted as a plain npz (no package pytrees)
        with np.load(args.core) as f:
            core = gp.PosteriorCore(**{k: jnp.asarray(f[k]) for k in f.files})
    elif args.observe:
        core, _ = load_compiled_program(args.exe, entry="core")
    if args.observe:
        exp_obs, meta0 = load_compiled_program(args.exe, entry="observe")
        P, Q = meta0["grid"]
        imgs, d_new, q_new = _load_observation_npz(
            args.observe, P, Q, meta0["image_shape"], err=SystemExit)
        t0 = time.perf_counter()
        core = exp_obs.call(core, jnp.asarray(imgs), jnp.asarray(d_new),
                            jnp.asarray(q_new),
                            jnp.ones((imgs.shape[0],), jnp.float32))
        jax.block_until_ready(core.M)
        fold_s = round(time.perf_counter() - t0, 4)
        np.savez(args.save_core,
                 **{f: np.asarray(v) for f, v in core._asdict().items()})
        print(json.dumps({"observed": int(imgs.shape[0]), "fold_s": fold_s,
                          "save_core": args.save_core}), flush=True)
        if args.requests is None:
            return

    entry = "mean"
    if args.sample:
        if core is not None:  # draws from the observe-updated posterior
            entry = "sample_joint_core" if args.joint else "sample_core"
        else:
            entry = "sample_joint" if args.joint else "sample"
    elif core is not None:
        entry = "predict_core"
    elif args.var:
        entry = "var"
    exp, meta = load_compiled_program(args.exe, entry=entry)
    P, Q = meta["grid"]
    pairs = _parse_requests(args.requests, P, Q, err=SystemExit)
    d = jnp.asarray([r[0] for r in pairs], jnp.int32)
    q = jnp.asarray([r[1] for r in pairs], jnp.int32)
    out = {"n_requests": len(pairs), "exe": args.exe, "entry": entry}
    t0 = time.perf_counter()
    if entry == "predict_core":
        y, var = exp.call(core, d, q)
        y = np.asarray(y)
        rows = [y]
        if args.var:
            out["posterior_var"] = [round(float(v0), 6)
                                    for v0 in np.asarray(var)]
    elif args.sample:
        call_args = (d, q, jnp.int32(args.seed),
                     jnp.zeros((args.sample,), jnp.int32))
        if core is not None:
            call_args = (core, *call_args)
        y = np.asarray(exp.call(*call_args))
        rows = [y[i] for i in range(len(pairs))]  # one panel row per cell
        out["samples_per_request"] = args.sample
        if args.joint:
            out["joint"] = True
    elif args.var:
        y, var = exp.call(d, q)
        y = np.asarray(y)
        rows = [y]
        out["posterior_var"] = [round(float(v0), 6) for v0 in np.asarray(var)]
    else:
        y = np.asarray(exp.call(d, q))
        rows = [y]
    out["latency_s"] = round(time.perf_counter() - t0, 4)
    if args.repeat > 0:
        out.update(_repeat_throughput(exp.call, d, q, P, Q, args.repeat))
    if args.sustained > 0:
        # exported programs are traceable from another JAX computation
        # (jax.export), so the sustained scan wraps exp.call directly
        out.update(_sustained_throughput(exp.call, d, q, P, Q, args.sustained))
    os.makedirs(args.outdir, exist_ok=True)
    panel = os.path.join(args.outdir, "served.png")
    save_panel(panel, rows)
    npz = os.path.join(args.outdir, "served.npz")
    np.savez_compressed(npz, images=y, objects=np.asarray(d),
                        views=np.asarray(q))
    out["panel"], out["npz"] = panel, npz
    print(json.dumps(out))


def main(argv=None):
    """Serve conditional generations from an exported artifact:

        python -m gppvae_tpu serve --state model.srv \\
            --requests 3:2,5:0,12:7 [--sample K] [--var] [--outdir DIR]

    Loads the N-independent server state written by
    `generate --export_server` (model architecture + feature-map config
    from the .meta.json sidecar), answers the requested (object:view)
    cells — predictive means by default, K posterior draws per cell with
    --sample — and writes a PNG panel + .npz alongside a JSON stats line.
    """
    import argparse
    import json
    import time

    import numpy as np

    from gppvae_tpu.eval.panels import save_panel
    from gppvae_tpu.models import VAE

    p = argparse.ArgumentParser(description="GPPVAE serving CLI")
    p.add_argument("--state", default=None,
                   help="server-state artifact from generate --export_server")
    p.add_argument("--exe", default=None,
                   help="compiled-program artifact from --export_exe: "
                        "self-contained jax.export blobs (weights baked in, "
                        "symbolic batch) answered without rebuilding any "
                        "model — means by default, --var / --sample K "
                        "[--joint] select the uncertainty entry points of "
                        "v2 artifacts")
    p.add_argument("--export_exe", default=None, metavar="PATH",
                   help="with --state: serialize the WHOLE serving surface "
                        "(jax.export, state baked in, batch+sample dims "
                        "symbolic) — mean/var/sample/sample_joint blobs "
                        "plus stateful observe/predict_core entries with "
                        "the initial core in PATH.core.npz — to PATH* + "
                        "PATH.meta.json, then exit")
    p.add_argument("--exe_platforms", default="cuda,cpu",
                   help="--export_exe: comma-separated lowering platforms")
    p.add_argument("--requests", default=None,
                   help="comma-separated object:view pairs, e.g. 3:2,5:0")
    p.add_argument("--stdin", action="store_true",
                   help="persistent ONLINE serving loop (--state or --exe; "
                        "the --exe loop runs from the blobs alone via the "
                        "predict_core/observe entries): one command per "
                        "stdin line — 'd:q,d:q,…' answers a request batch "
                        "(JSON line + .npz under --outdir), 'observe "
                        "<npz>' folds new observed images into the "
                        "posterior (streaming conditioning), 'save <path>' "
                        "persists the updated state; EOF exits. Everything "
                        "is padded to --max_batch so each command kind "
                        "reuses ONE compiled program (no per-shape "
                        "recompiles — the XLA-native way to serve varying "
                        "request sizes)")
    p.add_argument("--max_batch", type=int, default=64,
                   help="--stdin mode: fixed compiled batch size; longer "
                        "lines are split into chunks of this size")
    p.add_argument("--sample", type=int, default=0,
                   help="decode K posterior draws per cell instead of the mean")
    p.add_argument("--joint", action="store_true",
                   help="with --sample: draw the K samples JOINTLY over the "
                        "whole request batch from the full n×n posterior "
                        "covariance (sample k is one coherent scene across "
                        "all requested cells, preserving cross-request "
                        "posterior correlation), instead of independently "
                        "per cell from the diagonal variance")
    p.add_argument("--var", action="store_true",
                   help="also report the GP-predictive latent variance per cell")
    p.add_argument("--repeat", type=int, default=0,
                   help="throughput mode: after answering, re-serve the "
                        "request batch K more times (indices rotated per rep) "
                        "and report images_per_sec over the best rep — an "
                        "END-TO-END wall number including full image "
                        "readback")
    p.add_argument("--sustained", type=int, default=0, metavar="K",
                   help="decode-capacity mode: answer K rotated request "
                        "batches inside ONE dispatch (lax.scan, checksum "
                        "readback only) and report sustained_images_per_sec "
                        "— the number comparable to bench.py's oos_serving "
                        "sustained rate")
    p.add_argument("--seed", type=int, default=0, help="--sample RNG seed")
    p.add_argument("--observe", default=None, metavar="NPZ",
                   help="fold NEW observed images into the posterior before "
                        "answering (streaming conditioning, O(n·R²) — no "
                        "training set, no training step): an .npz with "
                        "images (n,H,W,C in [0,1]), objects (n,) and views "
                        "(n,) int arrays — the layout serve itself writes; "
                        "GridDataset's object_ids/view_ids keys also work. "
                        "Requires --save_state for the updated artifact")
    p.add_argument("--save_state", default=None, metavar="PATH",
                   help="--observe with --state: write the updated server "
                        "state (+ its .meta.json sidecar) here")
    p.add_argument("--core", default=None, metavar="NPZ",
                   help="--exe: serve from this (previously observe-updated) "
                        "posterior core instead of the exported initial one "
                        "— means/variances via the predict_core entry, "
                        "posterior draws via --sample K [--joint] (the "
                        "sample_core entries)")
    p.add_argument("--save_core", default=None, metavar="NPZ",
                   help="--exe --observe: write the updated posterior core "
                        "here (feed back via --core)")
    p.add_argument("--outdir", default=".")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if (args.state is None) == (args.exe is None):
        raise SystemExit("serve: pass exactly one of --state or --exe")
    if args.exe:
        if args.export_exe:
            raise SystemExit("serve: --export_exe needs --state")
        if args.stdin:
            if args.requests or args.sample or args.repeat \
                    or args.sustained or args.var or args.observe:
                raise SystemExit(
                    "serve: --exe --stdin is a persistent loop (requests "
                    "and 'observe <npz>' are input LINES); drop the other "
                    "flags"
                )
            _serve_exe_stdin_loop(args)
            return
        if args.observe and args.save_core is None:
            raise SystemExit(
                "serve: --exe --observe needs --save_core for the updated "
                "posterior core (answerable later via --core)"
            )
        if args.requests is None and not args.observe:
            raise SystemExit("serve: --exe needs --requests (or --observe)")
        if args.joint and not args.sample:
            raise SystemExit("serve: --joint modifies --sample; pass --sample K")
        if args.sample and args.var:
            raise SystemExit(
                "serve: --sample decodes posterior draws; --var reports the "
                "diagonal of the same posterior — pass one of them"
            )
        if (args.repeat or args.sustained) and (
                args.sample or args.var or args.observe or args.core):
            raise SystemExit(
                "serve: --repeat/--sustained (throughput modes) time the"
                " baked posterior-mean program; drop the other flags"
            )
        _serve_exe(args)
        return

    state, meta = load_server_state(args.state)
    if "image_shape" not in meta:
        raise ValueError(
            f"{args.state}.meta.json lacks image_shape — re-export with "
            "generate --export_server"
        )
    # the exported meta records the decoder lowering + compute precision
    # the model trained with — serve through the SAME decoder path the
    # bench measured, not the default resize/f32 one
    model = VAE(
        zdim=int(meta["zdim"]),
        image_shape=tuple(meta["image_shape"]),
        enc_features=tuple(meta.get("enc_features", (32, 64, 128))),
        dec_features=tuple(meta.get("dec_features", (128, 64, 32))),
        dtype=(jnp.bfloat16 if meta.get("compute_dtype") == "bfloat16"
               else jnp.float32),
        upsample=meta.get("dec_upsample", "resize"),
    )
    x_map = x_map_from_meta(meta, state.X.shape[1])
    extra = tuple(meta.get("extra_effects", ()))

    if args.export_exe:
        if args.stdin or args.sample or args.repeat or args.var \
                or args.sustained or args.observe:
            raise SystemExit("serve: --export_exe only serializes; answer "
                             "requests from the artifact via --exe (fold new "
                             "observations into the .srv state first with "
                             "--observe, then re-export)")
        emeta = export_compiled_program(
            model, state, args.export_exe, x_map=x_map, extra_effects=extra,
            platforms=tuple(p0 for p0 in args.exe_platforms.split(",") if p0),
        )
        print(json.dumps({"export_exe": args.export_exe, **emeta}))
        return

    if args.observe:
        if args.save_state is None:
            raise SystemExit("serve: --observe needs --save_state for the "
                             "updated artifact")
        if args.stdin or args.sample:
            raise SystemExit("serve: --observe folds then optionally answers "
                             "--requests; --stdin/--sample are separate runs")
        P, Q = int(state.X.shape[0]), int(state.W.shape[0])
        imgs, d_new, q_new = _load_observation_npz(
            args.observe, P, Q, meta["image_shape"], err=SystemExit)
        t0 = time.perf_counter()
        state = observe(model, state, jnp.asarray(imgs), jnp.asarray(d_new),
                        jnp.asarray(q_new), x_map=x_map,
                        extra_effects=extra)
        jax.block_until_ready(state.core.M)
        fold_s = round(time.perf_counter() - t0, 4)
        save_meta = {k: v for k, v in meta.items() if k != "nystrom_idx"}
        save_server_state(args.save_state, state, meta=save_meta,
                          nystrom_idx=meta.get("nystrom_idx"))
        print(json.dumps({
            "observed": int(imgs.shape[0]), "fold_s": fold_s,
            "save_state": args.save_state,
        }), flush=True)
        if args.requests is None:
            return

    if args.stdin == (args.requests is not None) and not args.observe:
        raise SystemExit("serve: pass exactly one of --requests or --stdin")
    # unsupported combinations are errors, not silent drops (round-4
    # review: --stdin answered with posterior MEANS while --sample asked
    # for draws, and --repeat was a silent no-op under --sample)
    if args.stdin and (args.sample or args.repeat or args.sustained):
        raise SystemExit(
            "serve: --sample/--repeat/--sustained are not supported with "
            "--stdin"
        )
    if (args.repeat or args.sustained) and args.sample:
        raise SystemExit(
            "serve: --repeat/--sustained (throughput modes) measure the"
            " posterior-mean path; drop --sample or the throughput flag"
        )
    if args.stdin:
        _serve_stdin_loop(model, state, x_map, extra, args,
                          meta=meta)
        return

    P, Q = int(state.X.shape[0]), int(state.W.shape[0])
    pairs = _parse_requests(args.requests, P, Q, err=SystemExit)
    d = jnp.asarray([r[0] for r in pairs], jnp.int32)
    q = jnp.asarray([r[1] for r in pairs], jnp.int32)

    if args.joint and not args.sample:
        raise SystemExit("serve: --joint modifies --sample; pass --sample K")
    if args.sample and args.var:
        raise SystemExit(
            "serve: --sample decodes posterior draws; --var reports the "
            "diagonal of the same posterior — pass one of them"
        )
    t0 = time.perf_counter()
    out = {"n_requests": len(pairs), "state": args.state}
    if args.sample:
        y = sample_images(model, state, d, q, jax.random.PRNGKey(args.seed),
                          args.sample, x_map=x_map, extra_effects=extra,
                          joint=args.joint)
        rows = [np.asarray(y[i]) for i in range(len(pairs))]  # one row/cell
        out["samples_per_request"] = args.sample
        if args.joint:
            out["joint"] = True
    else:
        res = predict_images(model, state, d, q, x_map=x_map,
                             extra_effects=extra, return_var=args.var)
        y, var = res if args.var else (res, None)
        rows = [np.asarray(y)]
        if var is not None:
            out["posterior_var"] = [round(float(v), 6) for v in var]
    out["latency_s"] = round(time.perf_counter() - t0, 4)

    if args.repeat > 0:
        # throughput mode (VERDICT round-3 #3 done-criterion): the serve
        # CLI's own sustained rate on the SAME jitted program the answer
        # used, comparable to bench.py's oos_serving number.
        served = jax.jit(
            lambda s, dd, qq: predict_images(model, s, dd, qq, x_map=x_map,
                                             extra_effects=extra)
        )
        out.update(_repeat_throughput(
            lambda dd, qq: served(state, dd, qq), d, q, P, Q, args.repeat
        ))
    if args.sustained > 0:
        out.update(_sustained_throughput(
            lambda dd, qq: predict_images(model, state, dd, qq, x_map=x_map,
                                          extra_effects=extra),
            d, q, P, Q, args.sustained,
        ))

    import os

    os.makedirs(args.outdir, exist_ok=True)
    panel = os.path.join(args.outdir, "served.png")
    save_panel(panel, rows)
    npz = os.path.join(args.outdir, "served.npz")
    np.savez_compressed(npz, images=np.asarray(rows[0] if not args.sample else y),
                        objects=np.asarray(d), views=np.asarray(q))
    out["panel"] = panel
    out["npz"] = npz
    print(json.dumps(out))

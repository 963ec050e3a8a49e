"""GPPVAE training driver — the flagship loop (reference:
pysrc/faceplace/train_gppvae.py + the fork's rotated-MNIST dis/joint
variants; SURVEY.md §3.2; configs BASELINE.json:8-9).

Epoch structure (everything device-resident and jit'ed):

  Phase A  full-latent refresh: grad-free encoder pass over every training
           row → Z₀ (N×L latent means); V₀ = object⊗view feature rows.
  Phase B  one exact low-rank GP solve: Woodbury NLL at (Z₀, V₀) and its
           first-order Taylor coefficients by autodiff (gp.taylor_expand).
  Phase C  minibatch scan: amortized inference (encode→sample→decode with
           grads) + the Taylor surrogate of the GP term + encoder-entropy
           pen term; separate Adam optimizers for VAE vs GP parameters.
  Eval     out-of-sample conditional generation for held-out (object, view)
           cells via GP-predictive latents; pixel MSE is the parity metric.

Two execution paths:

  * fused pipeline (default) — `epochs_per_dispatch` whole epochs run as ONE
    jit'ed `lax.scan`: zero host↔device sync inside, and the per-epoch eval
    refresh doubles as the next epoch's Phase-A encode (the refresh is
    "pipelined against GP solves" at the XLA-schedule level — the reading
    of the north star, BASELINE.json:5). The host only uploads an
    RNG key and reads back a metrics block per dispatch.
  * phase-per-dispatch profile path (`profile_phases=True`) — phases A/B/C
    and eval dispatched separately with wall-clock per phase (SURVEY.md §5
    tracing), for the benchmark breakdown.

Modes:
  'dis'    fixed view kernel (Fourier features of the view angle); object
           features X and variance components still learn (BASELINE.json:8).
  'joint'  view features W learned too — the full GPPVAE-joint
           (BASELINE.json:9).

Loss convention (see train/losses.py and train/batching.py): per-sample
terms are summed over the valid rows of the batch and divided by the
constant batch size (equal to the batch mean when the batch is full); the
final batch of each epoch is wrap-around-padded and masked so EVERY row
trains every epoch, and the epoch-accumulated GP-surrogate gradient equals
(1/b)·∇NLL of the exact full-dataset NLL at the expansion point for any N
(property-tested, including non-divisible N/bs).
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gppvae_tpu import gp
from gppvae_tpu.checkpoint import (
    load_train_state,
    load_vae_weights,
    save_train_state,
)
from gppvae_tpu.data.dataset import GridDataset
from gppvae_tpu.eval.oos import predict_heldout
from gppvae_tpu.eval.panels import save_panel
from gppvae_tpu.models import VAE, encode_all
from gppvae_tpu.parallel import (
    replicated,
    row_sharding,
    shard_params_model_axis,
    shard_rows,
)
from gppvae_tpu.train.batching import (
    epoch_batches,
    epoch_keys,
    masked_means,
    num_batches,
)
from gppvae_tpu.train.losses import (
    gaussian_recon_nll,
    logit_saturation_penalty,
    neg_entropy,
)
from gppvae_tpu.utils import MetricsLogger, PhaseTimer, maybe_trace

_METRIC_KEYS = (
    "loss", "recon_term", "gp_term", "pen_term", "mse",
    "gp_nll_full", "v_sig", "v_noise", "oos_mse",
)


@dataclasses.dataclass(frozen=True)
class GPPVAETrainConfig:
    mode: str = "joint"  # 'joint' | 'dis'
    zdim: int = 16
    epochs: int = 100
    batch_size: int = 128
    lr_vae: float = 2e-4
    lr_gp: float = 1e-3
    seed: int = 0
    sigma_y: float = 0.1
    learn_sigma_y: bool = False  # learn the decoder noise std (log-param,
    # lives in the GP/likelihood optimizer group; recon's D/2·log(2πσ²)
    # term makes the MLE well-defined)
    # GP feature dims: object rank M, view rank M_w (R = M·M_w)
    obj_feature_dim: int = 8
    view_num_freqs: int = 3  # fixed Fourier view features → M_w = 2f+1
    view_feature_dim: int | None = None  # learned W dim (joint); default 2f+1
    # object kernel: 'linear' (reference), 'rbf' via random Fourier features
    # over the learned object embeddings (thesis-extension stretch,
    # SURVEY.md §2.1; rank becomes rff_features·M_w), or 'rbf-nystrom' —
    # the RFF map compressed to nystrom_rank landmark objects by pivoted
    # Cholesky (gp/nystrom.py), so R = nystrom_rank·M_w regardless of
    # rff_features. Landmarks are selected once from the initial object
    # features and ride in checkpoints (state['nystrom_idx']).
    object_kernel: str = "linear"
    rff_features: int = 32
    rff_lengthscale: float = 1.0
    nystrom_rank: int = 16
    # additional low-rank random effects beyond the object×view product
    # (the reference GP's n_rand_effs; K = Σ_r v_r V_r V_rᵀ + v_n I):
    # 'object' adds a per-object effect shared across views (rows x_d),
    # 'view' a per-view effect shared across objects (rows w_q)
    extra_effects: tuple = ()
    init_v_sig: float = 1.0
    init_v_noise: float = 0.5
    enc_features: Sequence[int] = (32, 64, 128)
    dec_features: Sequence[int] = (128, 64, 32)
    compute_dtype: str = "float32"
    dec_upsample: str = "resize"  # 'subpixel' = exact fused low-res rewrite
    # automatic mixed-precision schedule: with compute_dtype='bfloat16',
    # run the FINAL polish_epochs epochs in float32 (same param tree — the
    # dtype only changes compute, checkpoints interchange; both Adams
    # restart at the switch). NOTE: round 3 root-caused the round-2 "bf16
    # plateau at oos 0.025" as sigmoid saturation death, not precision
    # (see sat_penalty below) — with the barrier on, bf16 alone reaches
    # the f32-class floor (2000-epoch soak: oos 8e-4 by the bf16 bulk end,
    # BASELINE.md round-3). The polish tail remains as belt-and-braces for
    # workloads where bf16 noise does bind. 0 = off; ignored for f32 runs.
    polish_epochs: int = 0
    # gradient-spike guard: global-norm clip in front of Adam (<=0 off).
    # Exactly 1.0-scaling below the threshold, so healthy runs are
    # bit-unchanged; see make_optimizer for the ν-poisoning root cause.
    clip_grad_norm: float = 1e5
    # saturation-death barrier weight (<=0 off): keeps decoder logits out
    # of the exactly-zero-gradient sigmoid region on extreme-horizon runs;
    # identically zero for healthy trajectories (losses.py
    # logit_saturation_penalty — round-3 root cause).
    sat_penalty: float = 1.0
    # gradient accumulation: one optimizer step per k minibatches (both
    # Adams, averaged grads via optax.MultiSteps). THE large-N knob: keeps
    # per-epoch optimizer path length (and so the Taylor surrogate's
    # per-epoch drift) bounded as steps-per-epoch grows — set
    # k ≈ (N/bs)/45 to reproduce benchmark-shape dynamics at any N instead
    # of rescaling learning rates. 1 = step per minibatch (reference
    # semantics, default); -1 = AUTO: resolve that rule from the dataset's
    # true N at setup (resolve_grad_accum), so large-N runs get the
    # benchmark-shape optimizer cadence without hand-computing k.
    grad_accum_steps: int = 1
    # sub-epoch Taylor refresh: re-run Phase A+B (full-dataset encode +
    # surrogate re-expansion) every k minibatch steps INSIDE the epoch,
    # bounding coefficient staleness when steps-per-epoch is huge — the
    # complement of grad_accum_steps for workloads that want large-N AND
    # per-minibatch optimizer updates. Costs one extra full-N encode per
    # refresh and unrolls ceil(nb/k) scan segments into the epoch program
    # (compile time scales with it — keep nb/k modest). 0 = refresh once
    # per epoch (reference semantics, default).
    refresh_every_steps: int = 0
    vae_weights: str | None = None  # --vae_weights handoff (SURVEY.md §5)
    resume: str | None = None  # full-state checkpoint to resume from
    epochs_per_dispatch: int = 1  # fused pipeline super-step size
    scan_unroll: int = 1  # minibatch-scan unroll factor (loop overhead)
    # train images are stored FLAT (N, H·W·C) above this N and reshaped
    # per gather (default 0 = always), so XLA's layout assignment cannot
    # flip large NHWC arrays to an N-minor layout inside the epoch scan
    # (every batch gather would then stride the whole array). Flat is
    # value-exact; its speed on the GPU is not measured yet. Set huge to
    # force the NHWC layout back.
    flat_images_threshold: int = 0
    profile_phases: bool = False  # phase-per-dispatch path with timings
    profile_dir: str | None = None  # jax.profiler trace output (SURVEY.md §5)
    encode_chunk: int = 1024  # Phase-A scan chunk (activation footprint cap)
    outdir: str | None = None
    panel_every: int = 0
    checkpoint_every: int = 0
    data: str | None = None  # the CLI --data flag, recorded in the sidecar
    # config.json so eval tooling rebuilds the SAME dataset by default


@dataclasses.dataclass
class GPPVAETrainResult:
    params: Any  # {'vae': …, 'gp': {'X','W'?,'log_vs','log_vn'}}
    fixed_W: jax.Array | None  # the fixed view features in 'dis' mode
    config: GPPVAETrainConfig
    history: list[dict]
    model: VAE


# --------------------------------------------------------------- helpers


def _init_view_features(config: GPPVAETrainConfig, dataset: GridDataset):
    """Fixed view features from the dataset's view auxiliary: periodic
    Fourier features for rotation angles, polynomial features for linear
    axes (pose), else a deterministic random unit-row matrix.
    Returns (Q, M_w) float32."""
    Q = dataset.num_views
    aux = dataset.view_aux
    if aux.shape[1] == 1 and dataset.periodic_views:
        freqs = config.view_num_freqs
        if config.view_feature_dim is not None:
            # honor the explicit rank knob: Fourier dims are odd (1 + 2f)
            if config.view_feature_dim < 3 or config.view_feature_dim % 2 == 0:
                raise ValueError(
                    "view_feature_dim must be odd ≥ 3 for periodic view aux "
                    f"(got {config.view_feature_dim}); Fourier rank is 1+2f"
                )
            freqs = (config.view_feature_dim - 1) // 2
        return gp.fourier_view_features(
            jnp.asarray(aux[:, 0]), num_freqs=freqs
        ).astype(jnp.float32)
    if aux.shape[1] == 1:
        degree = (config.view_feature_dim or (2 * config.view_num_freqs + 1)) - 1
        return gp.polynomial_view_features(
            jnp.asarray(aux[:, 0]), degree=degree
        ).astype(jnp.float32)
    Mw = config.view_feature_dim or (2 * config.view_num_freqs + 1)
    W = jax.random.normal(jax.random.PRNGKey(7), (Q, Mw), jnp.float32)
    return gp.normalize_rows(W)


def spike_guard(opt: "optax.GradientTransformation", clip_grad_norm: float = 0.0):
    """Fused gradient-spike guard: ONE sum-of-squares pass over the
    gradients yields BOTH the global-norm clip scale and the nonfinite
    skip decision.

    Semantics (selects, no lax.cond — apply_if_finite's cond blocks fusion
    of the Adam chain): when the gradient sum-of-squares is nonfinite, emit zero
    updates and keep the inner optimizer state untouched; otherwise clip
    exactly like optax.clip_by_global_norm (bit-exact pass-through below
    the threshold, (g/‖g‖)·c above it). Deriving `finite` from the clip's
    own Σg² (nonfinite entries make Σg² inf/nan) removes the separate
    per-leaf reduce_and pass, which compiled to its own per-step fusion.
    Only divergence
    from the two-pass form: a FINITE gradient whose square overflows f32
    (|g| ≳ 2e19) now skips the step instead of clipping — strictly safer
    for the ν-poisoning hazard the guard exists for (see make_optimizer).
    State: {'inner': …, 'notfinite_count': int32 total skipped steps}."""

    def init(params):
        return {"inner": opt.init(params),
                "notfinite_count": jnp.zeros((), jnp.int32)}

    def update(grads, state, params=None):
        sumsq = jnp.zeros((), jnp.float32)
        for g in jax.tree.leaves(grads):
            sumsq = sumsq + jnp.sum(jnp.square(g))
        finite = jnp.isfinite(sumsq)
        if clip_grad_norm and clip_grad_norm > 0:
            # identical arithmetic to optax.clip_by_global_norm: norm from
            # the SAME leaf-order Σg², exact pass-through below threshold
            norm = jnp.sqrt(sumsq)
            below = norm < clip_grad_norm
            grads = jax.tree.map(
                # per-leaf dtype cast exactly like optax.clip_by_global_norm
                # (a promoted norm would silently upcast every leaf in x64)
                lambda g: jnp.where(
                    below, g, (g / norm.astype(g.dtype)) * clip_grad_norm
                ),
                grads,
            )
        updates, new_inner = opt.update(grads, state["inner"], params)
        updates = jax.tree.map(
            lambda u: jnp.where(finite, u, jnp.zeros_like(u)), updates
        )
        new_inner = jax.tree.map(
            lambda n, o: jnp.where(finite, n, o), new_inner, state["inner"]
        )
        return updates, {
            "inner": new_inner,
            "notfinite_count": state["notfinite_count"]
            + jnp.where(finite, 0, 1).astype(jnp.int32),
        }

    return optax.GradientTransformation(init, update)


def make_optimizer(lr: float, clip_grad_norm: float = 1e5,
                   grad_accum_steps: int = 1):
    """Adam guarded against gradient spikes: global-norm clip + a
    nonfinite-gradient skip, fused into one reduction pass (spike_guard).

    Root-caused in round 3 (BASELINE.md "polish soak"): at epoch ~880 of
    the 2000-epoch bf16 learn_sigma_y soak a FINITE gradient spike of
    ~1e13 magnitude hit the encoder (Adam ν measured at 3.9e26 in
    head_logvar afterwards). ν never recovers at β2=0.999, so every later
    update is sub-ulp (param + update == param in f32) and the run trains
    never again while all metrics stay finite — a silently dead run that
    round 2 misread as a "bf16 precision plateau". The clip caps the spike
    so ν stays sane; it multiplies by exactly 1.0 whenever the global norm
    is below clip_grad_norm, so healthy trajectories (goldens included) are
    bit-unchanged. spike_guard's select-based skip additionally zeroes the
    step on nonfinite gradients. clip_grad_norm <= 0 disables the clip.

    NOTE: wrapping changes the optimizer-state pytree, so full-state
    checkpoints written before the fused guard landed are not loadable
    (same policy as the round-1 log_vs format change — interim formats,
    never released)."""
    opt = spike_guard(optax.adam(lr), clip_grad_norm)
    if grad_accum_steps > 1:
        # gradient accumulation (optax.MultiSteps): one Adam step per k
        # minibatches on the averaged gradient. The large-N stabilizer:
        # per-epoch Adam path length is (steps-per-epoch/k)·lr, and the
        # Taylor surrogate stays inside its per-epoch trust region when
        # k ≈ steps-per-epoch/45 (the benchmark-shape step count) without
        # touching learning rates (BASELINE.md "large-N surrogate drift").
        opt = optax.MultiSteps(opt, every_k_schedule=grad_accum_steps)
    return opt


def resolve_grad_accum(grad_accum_steps: int, num_train: int,
                       batch_size: int) -> int:
    """Resolve the grad_accum_steps knob: -1 = auto ⇒ k ≈ (N/bs)/45, the
    round-3 rule that keeps the per-epoch Adam path length at the
    benchmark shape's ~45 steps/epoch for any N (BASELINE.md "large-N
    surrogate drift"); explicit positive values pass through."""
    if grad_accum_steps == -1:
        steps_per_epoch = num_batches(num_train, batch_size)
        return max(1, round(steps_per_epoch / 45))
    if grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1 or -1 (auto), got {grad_accum_steps}"
        )
    return grad_accum_steps


def _split_gp_aux(gp_params):
    return {"log_vs": gp_params["log_vs"], "log_vn": gp_params["log_vn"]}


_encode_all = encode_all  # Phase A = models.encode_all (shared with eval CLI)


def build_x_map(config: GPPVAETrainConfig, nystrom_idx=None):
    """Object-kernel feature map for this config (gp.make_x_map wrapper)."""
    return gp.make_x_map(
        config.object_kernel, config.obj_feature_dim, config.rff_features,
        config.rff_lengthscale, config.seed, nystrom_idx,
    )


def _select_nystrom_landmarks(X0, config: GPPVAETrainConfig) -> jax.Array:
    """Pick nystrom_rank landmark OBJECTS by greedy pivoted Cholesky on the
    initial RFF-mapped object features (host-side, once; gp/nystrom.py).
    Exactly nystrom_rank indices come back (rank-deficient residuals are
    padded with unused rows) so checkpoint shapes stay static."""
    rff, _ = gp.make_rff_map(
        config.obj_feature_dim, config.rff_features,
        config.rff_lengthscale, seed=config.seed,
    )
    F0 = np.asarray(rff(gp.normalize_rows(jnp.asarray(X0))))
    m = min(config.nystrom_rank, len(F0))
    idx = gp.pivoted_cholesky_landmarks(F0, m, tol=0.0)
    if len(idx) < m:
        rest = np.setdiff1d(np.arange(len(F0), dtype=np.int32), idx)
        idx = np.concatenate([idx, rest[: m - len(idx)]]).astype(np.int32)
    return jnp.asarray(idx)


class _Loop:
    """Closes over everything static; provides the epoch building blocks
    used by both execution paths."""

    def __init__(self, model, opt_vae, opt_gp, config, num_train, mesh,
                 nystrom_idx=None):
        self.model = model
        self.opt_vae = opt_vae
        self.opt_gp = opt_gp
        self.config = config
        self.num_train = num_train
        self.learn_W = config.mode == "joint"
        self.nystrom_idx = nystrom_idx
        self.x_map = build_x_map(config, nystrom_idx)
        for e in config.extra_effects:
            if e not in ("object", "view"):
                raise ValueError(f"unknown extra effect {e!r}")
        self.batch_sharding = row_sharding(mesh) if mesh is not None else None
        self.chunk = min(config.encode_chunk, num_train)
        if mesh is not None:
            # chunks stay row-sharded (encode_all constrains each scanned
            # chunk), so round to the data-axis size — bounded activation
            # footprint even at FacePlace scale on a mesh (no full-N encode)
            ndev = mesh.shape[mesh.axis_names[0]]
            self.chunk = max(ndev, (self.chunk // ndev) * ndev)
        bs = config.batch_size
        if bs > num_train:
            raise ValueError(f"batch_size {bs} exceeds train set {num_train}")
        self.nb = num_batches(num_train, bs)  # ceil: every row trains

        # NLL over possibly-padded rows: zeroed pad rows contribute nothing
        # to Gram/projection/‖Z‖², so only the scalar N-counts need the true
        # row count (num_rows == Z.shape[0] whenever there is no padding)
        def _nll_fn(Z, Vs, aux):
            v_sig, v_noise = gp.variances_from_log(aux["log_vs"], aux["log_vn"])
            v_sigs = [v_sig[i] for i in range(len(Vs))]
            return gp.gp_nll_from_features(
                Z, Vs, v_sigs, v_noise, num_rows=num_train
            )

        self.nll_fn = _nll_fn

    def build_effects(self, X, W, d, q):
        return gp.build_effect_rows(
            X, W, d, q, extra_effects=self.config.extra_effects,
            x_map=self.x_map,
        )

    def _mask_rows(self, row_mask, tree):
        if row_mask is None:
            return tree
        return jax.tree.map(lambda a: a * row_mask[:, None], tree)

    # -- phase A+B
    def refresh_and_solve(self, params, fixed_W, images_tr, d_tr, q_tr,
                          row_mask=None):
        Z0 = _encode_all(self.model, params["vae"], images_tr, self.chunk,
                         batch_sharding=self.batch_sharding)
        Z0 = self._mask_rows(row_mask, Z0)
        W = params["gp"]["W"] if self.learn_W else fixed_W
        V0 = self._mask_rows(
            row_mask, self.build_effects(params["gp"]["X"], W, d_tr, q_tr)
        )
        coeffs = gp.taylor_expand(self.nll_fn, Z0, V0, _split_gp_aux(params["gp"]))
        return Z0, coeffs

    # -- phase C
    def minibatch_epoch(self, params, ov_state, og_state, fixed_W, images_tr,
                        d_tr, q_tr, coeffs, epoch_key, row_mask=None):
        bs = self.config.batch_size
        config = self.config
        model, num_train = self.model, self.num_train
        learn_W, batch_sharding = self.learn_W, self.batch_sharding

        def make_step(coeffs):
          def minibatch_step(carry, xs):
            params, ov_state, og_state = carry
            pos, w, step_key = xs  # positions into the train arrays + mask
            # Draw the reparameterization noise OUTSIDE the differentiated
            # loss: with ε inside, XLA rematerializes the threefry hash in
            # the BACKWARD pass; pre-drawn, it is an 8 KB saved residual
            # instead. Same key, shape and dtype as
            # reparameterize(step_key, mu, logvar) → bit-identical z.
            eps = jax.random.normal(
                step_key, (bs, config.zdim), jnp.float32
            )

            def loss_fn(p):
                sy = (
                    jnp.exp(p["gp"]["log_sy"])
                    if config.learn_sigma_y
                    else config.sigma_y
                )
                y = images_tr[pos]
                if y.ndim == 2:  # flat large-N storage → NHWC batch
                    y = y.reshape(bs, *model.image_shape)
                if batch_sharding is not None:
                    # DP: split the gathered batch rows across the mesh
                    y = jax.lax.with_sharding_constraint(y, batch_sharding)
                mu, logvar = model.apply(p["vae"], y, method=VAE.encode)
                z = mu + jnp.exp(0.5 * logvar) * eps  # == reparameterize
                logits = model.apply(p["vae"], z, method=VAE.decode)
                recon, mse = gaussian_recon_nll(y, jax.nn.sigmoid(logits), sy)
                if config.sat_penalty > 0:
                    # saturation-death barrier (losses.py): exactly 0 while
                    # logits stay in the gradient-alive range
                    recon = recon + config.sat_penalty * logit_saturation_penalty(logits)
                W = p["gp"]["W"] if learn_W else fixed_W
                v = self.build_effects(p["gp"]["X"], W, d_tr[pos], q_tr[pos])
                aux = _split_gp_aux(p["gp"])
                gp_term = gp.surrogate_batch_term(
                    coeffs, pos, z, v, aux, num_train, weights=w
                ) / bs
                pen_rows = neg_entropy(logvar)
                # sum over VALID rows / constant bs: every sample contributes
                # exactly 1/bs to the epoch gradient (batching.py convention);
                # equals the old batch mean whenever the batch has no padding
                loss = (jnp.sum(w * recon) + jnp.sum(w * pen_rows)) / bs + gp_term
                recon_m, pen_m, mse_m = masked_means(w, recon, pen_rows, mse)
                return loss, (recon_m, gp_term, pen_m, mse_m)

            (loss, aux_m), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            vae_updates, ov2 = self.opt_vae.update(grads["vae"], ov_state,
                                                   params["vae"])
            gp_updates, og2 = self.opt_gp.update(grads["gp"], og_state,
                                                 params["gp"])
            params = {
                "vae": optax.apply_updates(params["vae"], vae_updates),
                "gp": optax.apply_updates(params["gp"], gp_updates),
            }
            return (params, ov2, og2), jnp.stack([loss, *aux_m])

          return minibatch_step

        batches, weights = epoch_batches(epoch_key, num_train, bs)
        step_keys = jax.random.split(jax.random.fold_in(epoch_key, 1), self.nb)
        k = config.refresh_every_steps
        carry = (params, ov_state, og_state)
        if k and 0 < k < self.nb:
            # sub-epoch Taylor refresh: static segmentation (host-side
            # bounds, traced arrays sliced with python ints — no dynamic
            # shapes); Phase A+B re-centers the surrogate at the CURRENT
            # params between segments. Segment 0 reuses the entering
            # coeffs (just computed by the caller's refresh).
            rows = []
            for s in range(0, self.nb, k):
                e = min(s + k, self.nb)
                if s > 0:
                    _, coeffs = self.refresh_and_solve(
                        carry[0], fixed_W, images_tr, d_tr, q_tr, row_mask
                    )
                carry, m = jax.lax.scan(
                    make_step(coeffs), carry,
                    (batches[s:e], weights[s:e], step_keys[s:e]),
                    unroll=min(config.scan_unroll, e - s),
                )
                rows.append(m)
            metrics = jnp.concatenate(rows, axis=0)
        else:
            carry, metrics = jax.lax.scan(
                make_step(coeffs), carry,
                (batches, weights, step_keys),
                unroll=min(config.scan_unroll, self.nb),
            )
        params, ov_state, og_state = carry
        return params, ov_state, og_state, jnp.mean(metrics, axis=0)

    # -- out-of-sample eval (given a fresh Z0 for the current params)
    def oos(self, params, fixed_W, Z0, d_tr, q_tr, d_ho, q_ho, y_ho,
            row_mask=None):
        return predict_heldout(
            self.model, params, fixed_W, Z0, d_tr, q_tr, d_ho, q_ho, y_ho,
            x_map=self.x_map, extra_effects=self.config.extra_effects,
            row_weights=row_mask,
        )

    # ---------------- fused multi-epoch pipeline (one dispatch) ----------
    def make_fused_fn(self, n_epochs: int):
        """E epochs in one jit: scan body = [Phase A (doubles as previous
        epoch's eval refresh) → oos eval → Phase B → Phase C]. After the
        scan, one final refresh+eval closes the last epoch. Metrics rows
        come back aligned so row e describes the state AFTER epoch e."""

        @partial(jax.jit, donate_argnums=(0, 1, 2))
        def fused(params, ov_state, og_state, fixed_W, images_tr, d_tr, q_tr,
                  y_ho, d_ho, q_ho, keys, row_mask=None):
            def body(carry, epoch_key):
                params, ov_state, og_state = carry
                Z0, coeffs = self.refresh_and_solve(
                    params, fixed_W, images_tr, d_tr, q_tr, row_mask
                )
                # oos of the ENTERING state (== end of previous epoch)
                _, oos_in = self.oos(
                    params, fixed_W, Z0, d_tr, q_tr, d_ho, q_ho, y_ho, row_mask
                )
                params, ov_state, og_state, cm = self.minibatch_epoch(
                    params, ov_state, og_state, fixed_W, images_tr, d_tr,
                    q_tr, coeffs, epoch_key, row_mask,
                )
                row = jnp.concatenate([
                    cm,
                    jnp.stack([
                        coeffs.value / self.num_train,
                        jnp.exp(params["gp"]["log_vs"][0]),  # product effect
                        jnp.exp(params["gp"]["log_vn"]),
                        oos_in,
                    ]),
                ])
                return (params, ov_state, og_state), row

            (params, ov_state, og_state), rows = jax.lax.scan(
                body, (params, ov_state, og_state), keys
            )
            # close the last epoch: fresh refresh + eval of the FINAL state
            Z_fin = _encode_all(self.model, params["vae"], images_tr, self.chunk,
                                batch_sharding=self.batch_sharding)
            y_pred, oos_fin = self.oos(
                params, fixed_W, Z_fin, d_tr, q_tr, d_ho, q_ho, y_ho, row_mask
            )
            # shift: row e's oos describes state entering e ⇒ align to e-1
            oos = jnp.concatenate([rows[1:, -1], jnp.stack([oos_fin])])
            rows = rows.at[:, -1].set(oos)
            return params, ov_state, og_state, rows, y_pred

        return fused


# ------------------------------------------------------------- driver


def train_gppvae(
    dataset: GridDataset,
    config: GPPVAETrainConfig,
    *,
    vae_params=None,
    mesh=None,
    log: MetricsLogger | None = None,
) -> GPPVAETrainResult:
    if config.mode not in ("joint", "dis"):
        raise ValueError(f"unknown mode {config.mode!r}; want 'joint' or 'dis'")
    return _train_gppvae_impl(
        dataset, config, vae_params=vae_params, mesh=mesh, log=log
    )


def _setup(dataset, config, vae_params, mesh):
    rng = jax.random.PRNGKey(config.seed)
    rng, init_key, sample_key, x_key = jax.random.split(rng, 4)

    model = VAE(
        zdim=config.zdim,
        image_shape=tuple(dataset.image_shape),
        enc_features=tuple(config.enc_features),
        dec_features=tuple(config.dec_features),
        dtype=jnp.bfloat16 if config.compute_dtype == "bfloat16" else jnp.float32,
        upsample=config.dec_upsample,
    )

    tr = dataset.train_idx
    num_train = len(tr)
    row_mask = None
    if mesh is not None:
        # row-sharded arrays need equal data-axis shards: pad N to the
        # data-axis size by wrap-around rows carrying weight 0. The loop
        # zeroes the padded Z/V rows after Phase A, the NLL counts the true
        # N (gp_nll_from_features num_rows), and batch plans index only the
        # first num_train positions — so every real row trains and the mesh
        # trajectory equals single-device for ANY N (round-2 VERDICT
        # Missing #2; tests/test_parallel.py non-divisible-N equality).
        ndev = mesh.shape[mesh.axis_names[0]]
        pad = (-num_train) % ndev
        if pad:
            # np.resize cycles the index vector, so pad > num_train (train
            # set smaller than the data axis) still yields exactly `pad`
            # wrap-around rows instead of a short array that later fails
            # with an opaque sharding error (ADVICE.md round-3)
            tr = np.asarray(tr)
            tr = np.concatenate([tr, np.resize(tr, pad)])
            row_mask = jnp.concatenate(
                [jnp.ones((num_train,), jnp.float32),
                 jnp.zeros((pad,), jnp.float32)]
            )
    images_tr = jnp.asarray(dataset.images[tr])
    if len(tr) > config.flat_images_threshold:
        # flat (N, H·W·C) storage: keeps gathers contiguous at large N (see
        # flat_images_threshold); rows are reshaped back per gather/chunk
        images_tr = images_tr.reshape(len(tr), -1)
    arrays = dict(
        images_tr=images_tr,
        d_tr=jnp.asarray(dataset.object_ids[tr]),
        q_tr=jnp.asarray(dataset.view_ids[tr]),
        y_ho=jnp.asarray(dataset.images[dataset.heldout_idx]),
        d_ho=jnp.asarray(dataset.object_ids[dataset.heldout_idx]),
        q_ho=jnp.asarray(dataset.view_ids[dataset.heldout_idx]),
        row_mask=row_mask,
    )
    if mesh is not None:
        # N-axis sharding: dataset rows (and therefore Z, V, Taylor coeff
        # rows) live distributed; GP reductions psum across the mesh (SURVEY.md §5)
        arrays["images_tr"], arrays["d_tr"], arrays["q_tr"] = shard_rows(
            mesh, arrays["images_tr"], arrays["d_tr"], arrays["q_tr"]
        )
        if row_mask is not None:
            arrays["row_mask"] = shard_rows(mesh, row_mask)

    fresh = model.init(
        init_key, arrays["images_tr"][:1].reshape(1, *dataset.image_shape),
        sample_key,
    )
    if vae_params is None and config.vae_weights:
        vae_params = load_vae_weights(config.vae_weights, abstract_params=fresh)
    if vae_params is None:
        vae_params = fresh
    else:
        # phase C donates the params buffers; own a copy so the caller's
        # arrays (e.g. a result reused across runs) survive
        vae_params = jax.tree.map(lambda x: jnp.array(x, copy=True), vae_params)

    W0 = _init_view_features(config, dataset)
    n_eff = 1 + len(config.extra_effects)
    gp_params = {
        "X": jax.random.normal(
            x_key, (dataset.num_objects, config.obj_feature_dim), jnp.float32
        ) / np.sqrt(config.obj_feature_dim),
        # one signal variance per random effect (reference GP: n_rand_effs)
        "log_vs": jnp.full((n_eff,), np.log(config.init_v_sig), jnp.float32),
        "log_vn": jnp.log(jnp.asarray(config.init_v_noise, jnp.float32)),
    }
    if config.learn_sigma_y:
        gp_params["log_sy"] = jnp.log(jnp.asarray(config.sigma_y, jnp.float32))
    fixed_W = None
    if config.mode == "joint":
        gp_params["W"] = W0
    else:
        fixed_W = W0
    params = {"vae": vae_params, "gp": gp_params}
    if mesh is not None:
        # 1-D mesh → replicate params (DP); 2-D mesh with a 'model' axis →
        # large kernels shard their output features (TP), rest replicates
        params = shard_params_model_axis(mesh, params)
        if fixed_W is not None:
            fixed_W = jax.device_put(fixed_W, replicated(mesh))
    # num_train is the TRUE row count: batch plans, the surrogate's 1/N
    # scaling and the NLL's N-counts all use it; padded rows (mesh only)
    # exist solely to even out the shard split and carry weight 0
    return model, params, fixed_W, arrays, rng, num_train


def _train_gppvae_impl(dataset, config, *, vae_params, mesh, log):
    own_log = log is None
    log = log or MetricsLogger(config.outdir)
    if config.outdir:
        # sidecar config so eval tooling can rebuild the exact model AND the
        # exact dataset (grid shape + seed; generate.py defaults from this)
        os.makedirs(config.outdir, exist_ok=True)
        with open(os.path.join(config.outdir, "config.json"), "w") as f:
            import json

            json.dump(
                {
                    **dataclasses.asdict(config),
                    "dataset": {
                        "name": dataset.name,
                        "num_objects": dataset.num_objects,
                        "num_views": dataset.num_views,
                        # spatial size so generate/serve rebuild the SAME
                        # grid shape (a 128² face run must not be re-eval'd
                        # on the 64² default)
                        "image_size": int(dataset.image_shape[0]),
                    },
                },
                f, indent=1, default=list,
            )
    model, params, fixed_W, arrays, rng, num_train = _setup(
        dataset, config, vae_params, mesh
    )
    nystrom_idx = None
    if config.object_kernel == "rbf-nystrom":
        nystrom_idx = _select_nystrom_landmarks(params["gp"]["X"], config)
    accum = resolve_grad_accum(config.grad_accum_steps, num_train,
                               config.batch_size)
    opt_vae = make_optimizer(config.lr_vae, config.clip_grad_norm, accum)
    opt_gp = make_optimizer(config.lr_gp, config.clip_grad_norm, accum)
    ov_state = opt_vae.init(params["vae"])
    og_state = opt_gp.init(params["gp"])
    start_epoch = 0
    if config.resume:
        abstract = {
            "params": params, "ov_state": ov_state, "og_state": og_state,
            **({"fixed_W": fixed_W} if fixed_W is not None else {}),
            **({"nystrom_idx": nystrom_idx} if nystrom_idx is not None else {}),
            "epoch": 0,
        }
        # format breaks (v1 log_vs scalar, v2 pre-spike_guard opt states,
        # v3 orbax directories) raise a NAMED CheckpointFormatError with the
        # history — see checkpoint/npz_io.py FORMAT_VERSION
        state = load_train_state(config.resume, abstract)
        params, ov_state, og_state = (
            state["params"], state["ov_state"], state["og_state"]
        )
        if fixed_W is not None:
            fixed_W = state["fixed_W"]
        if nystrom_idx is not None:
            # the run's own landmarks, not a fresh re-selection
            nystrom_idx = state["nystrom_idx"]
        start_epoch = int(state["epoch"])
    loop = _Loop(model, opt_vae, opt_gp, config, num_train, mesh,
                 nystrom_idx=nystrom_idx)

    history: list[dict] = []
    # per-epoch keys are fold_in(rng, epoch) (batching.epoch_keys), so a
    # resumed run replays exactly the uninterrupted stream from start_epoch
    runner = _run_profiled if config.profile_phases else _run_fused
    polish = (
        min(config.polish_epochs, config.epochs)
        if config.polish_epochs > 0 and config.compute_dtype == "bfloat16"
        else 0
    )
    bulk_end = config.epochs - polish
    # a resume landing INSIDE the polish window (start_epoch > bulk_end)
    # carries post-restart optimizer states in its checkpoint — the Adam
    # restart below must fire only when this run actually CROSSES the
    # precision switch, or the resumed trajectory diverges from the
    # uninterrupted one (round-3 VERDICT weak #2 / ADVICE)
    crosses_switch = start_epoch <= bulk_end
    with maybe_trace(config.profile_dir):
        if start_epoch < bulk_end:
            params, ov_state, og_state = runner(
                loop, params, ov_state, og_state, fixed_W, arrays, rng,
                config, model, log, history, start_epoch, stop_epoch=bulk_end,
            )
            start_epoch = bulk_end
        if polish and start_epoch < config.epochs:
            # f32 polish tail: same param tree (dtype is compute-only), same
            # absolute-epoch RNG stream, fresh jit programs. Sub-config and
            # model mirror _setup's construction with the dtype flipped.
            model = VAE(
                zdim=config.zdim, image_shape=model.image_shape,
                enc_features=tuple(config.enc_features),
                dec_features=tuple(config.dec_features),
                dtype=jnp.float32, upsample=config.dec_upsample,
            )
            loop = _Loop(model, opt_vae, opt_gp, config, num_train, mesh,
                         nystrom_idx=nystrom_idx)
            # RESTART both Adams at the precision switch: the bulk phase's
            # second-moment history is calibrated to bf16-noise gradient
            # scales (and can carry spike damage — see make_optimizer), so
            # inheriting it throttles the f32 tail; measured on the 2000-ep
            # soak, the inherited-state polish stays at the 0.025 plateau
            # while the restarted one descends (BASELINE.md round-3 soak).
            # No-op when there was no bulk phase (polish >= epochs), which
            # keeps whole-run polish == plain f32 bit-exact, and when the
            # run RESUMED from mid-polish (the restart already happened
            # before that checkpoint was written).
            if bulk_end > 0 and crosses_switch:
                ov_state = opt_vae.init(params["vae"])
                og_state = opt_gp.init(params["gp"])
            params, ov_state, og_state = runner(
                loop, params, ov_state, og_state, fixed_W, arrays, rng,
                config, model, log, history, start_epoch,
                stop_epoch=config.epochs,
            )

    if config.outdir:
        save_train_state(
            os.path.join(config.outdir, "final_state"),
            {
                "params": params,
                "ov_state": ov_state,
                "og_state": og_state,
                **({"fixed_W": fixed_W} if fixed_W is not None else {}),
                **({"nystrom_idx": nystrom_idx} if nystrom_idx is not None else {}),
                "epoch": config.epochs,
            },
        )
    if own_log:
        log.close()
    return GPPVAETrainResult(
        params=params, fixed_W=fixed_W, config=config, history=history, model=model
    )


def _run_fused(loop, params, ov_state, og_state, fixed_W, arrays, rng, config,
               model, log, history, start_epoch=0, stop_epoch=None):
    a = arrays
    done = start_epoch
    stop = config.epochs if stop_epoch is None else stop_epoch
    fused_cache: dict[int, Any] = {}
    while done < stop:
        e = min(config.epochs_per_dispatch, stop - done)
        if e not in fused_cache:
            fused_cache[e] = loop.make_fused_fn(e)
        keys = epoch_keys(rng, done, e)
        t0 = time.perf_counter()
        params, ov_state, og_state, rows, y_pred = fused_cache[e](
            params, ov_state, og_state, fixed_W, a["images_tr"], a["d_tr"],
            a["q_tr"], a["y_ho"], a["d_ho"], a["q_ho"], keys, a["row_mask"],
        )
        rows = np.asarray(jax.device_get(rows))
        sec = (time.perf_counter() - t0) / e
        for i in range(e):
            rec = {
                "driver": f"train_gppvae[{config.mode}]",
                "epoch": done + i,
                **dict(zip(_METRIC_KEYS, (float(x) for x in rows[i]))),
                "sec_epoch": sec,
            }
            log.log(rec)
            history.append(rec)
        done += e
        if config.outdir:
            _epoch_artifacts(
                model, params, a["images_tr"], y_pred, a["y_ho"], config,
                done - 1, jax.random.fold_in(keys[-1], 2), fixed_W=fixed_W,
                ov_state=ov_state, og_state=og_state,
                nystrom_idx=loop.nystrom_idx, window=e,
            )
    return params, ov_state, og_state


def _run_profiled(loop, params, ov_state, og_state, fixed_W, arrays, rng,
                  config, model, log, history, start_epoch=0, stop_epoch=None):
    a = arrays
    refresh_solve = jax.jit(loop.refresh_and_solve)
    minibatch = jax.jit(loop.minibatch_epoch, donate_argnums=(0, 1, 2))
    oos_fn = jax.jit(loop.oos)
    encode = jax.jit(
        lambda p: _encode_all(loop.model, p["vae"], a["images_tr"], loop.chunk,
                              batch_sharding=loop.batch_sharding)
    )
    timer = PhaseTimer()
    for epoch in range(start_epoch, config.epochs):
        t0 = time.perf_counter()
        epoch_key = jax.random.fold_in(rng, epoch)
        with timer.phase("A_refresh_B_solve"):
            Z0, coeffs = refresh_solve(
                params, fixed_W, a["images_tr"], a["d_tr"], a["q_tr"],
                a["row_mask"],
            )
            coeffs.value.block_until_ready()
        with timer.phase("C_minibatch"):
            params, ov_state, og_state, cm = minibatch(
                params, ov_state, og_state, fixed_W, a["images_tr"], a["d_tr"],
                a["q_tr"], coeffs, epoch_key,
            )
            cm = jax.device_get(cm)
        with timer.phase("eval_oos"):
            Z_eval = encode(params)
            y_pred, oos_mse = oos_fn(
                params, fixed_W, Z_eval, a["d_tr"], a["q_tr"], a["d_ho"],
                a["q_ho"], a["y_ho"], a["row_mask"],
            )
            oos_mse = float(oos_mse)
        sec = time.perf_counter() - t0
        phases = timer.reset()
        rec = {
            "driver": f"train_gppvae[{config.mode}]",
            "epoch": epoch,
            "loss": float(cm[0]),
            "recon_term": float(cm[1]),
            "gp_term": float(cm[2]),
            "pen_term": float(cm[3]),
            "mse": float(cm[4]),
            "gp_nll_full": float(coeffs.value) / loop.num_train,
            "v_sig": float(jnp.exp(params["gp"]["log_vs"][0])),
            "v_noise": float(jnp.exp(params["gp"]["log_vn"])),
            "oos_mse": oos_mse,
            "sec_epoch": sec,
            **{f"sec_{k}": v for k, v in phases.items()},
        }
        log.log(rec)
        history.append(rec)
        if config.outdir:
            _epoch_artifacts(
                model, params, a["images_tr"], y_pred, a["y_ho"], config,
                epoch, epoch_key, fixed_W=fixed_W, ov_state=ov_state,
                og_state=og_state, nystrom_idx=loop.nystrom_idx,
            )
    return params, ov_state, og_state


def _epoch_artifacts(model, params, images_tr, y_pred, y_ho, config, epoch,
                     key, *, fixed_W=None, ov_state=None, og_state=None,
                     nystrom_idx=None, window=1):
    # cadence fires when a multiple of `every` lies in the dispatch window
    # (epoch-window, epoch] — with window=1 this is the plain epoch % every
    # == 0; the fused path passes window=epochs_per_dispatch so cadences
    # misaligned with the dispatch size still fire (ADVICE.md round-1 fix)
    def crossed(every):
        return bool(every) and (epoch // every) > ((epoch - window) // every)

    last = epoch >= config.epochs - 1
    if config.panel_every and (crossed(config.panel_every) or last):
        y = images_tr[:8]
        if y.ndim == 2:  # flat large-N storage
            y = y.reshape(-1, *model.image_shape)
        logits, *_ = model.apply(params["vae"], y, key)
        save_panel(
            os.path.join(config.outdir, f"panel_{epoch:04d}.png"),
            [
                np.asarray(y),
                np.asarray(jax.nn.sigmoid(logits)),
                np.asarray(y_ho[:8]),
                np.asarray(y_pred[:8]),
            ],
        )
    if crossed(config.checkpoint_every) and not last:
        save_train_state(
            os.path.join(config.outdir, f"state_{epoch + 1:04d}"),
            {
                "params": params,
                "ov_state": ov_state,
                "og_state": og_state,
                **({"fixed_W": fixed_W} if fixed_W is not None else {}),
                **({"nystrom_idx": nystrom_idx} if nystrom_idx is not None else {}),
                "epoch": epoch + 1,  # epochs completed — resume from here
            },
        )


def fused_epoch_cost(dataset, config: GPPVAETrainConfig, mesh=None,
                     n_epochs: int | None = None) -> dict:
    """XLA cost analysis (flops, bytes accessed, …) of the compiled fused
    program covering `n_epochs` epochs (default: config.epochs_per_dispatch)
    at this config's true shapes. Returns {} if the backend doesn't expose
    cost analysis.

    CAVEAT: XLA counts each lax.scan body ONCE, so this UNDERCOUNTS the
    looped phases (epoch scan × minibatch scan × encode-chunk scan) by their
    trip counts — roofline/MFU numbers must come from the analytic
    utils/flops.py formulas instead (validated against cost_analysis on
    unscanned subprograms in tests/test_flops.py). This helper remains
    useful for inspecting what ONE pass of each loop body costs."""
    try:
        compiled = _lower_fused(dataset, config, mesh, n_epochs).compile()
        return dict(compiled.cost_analysis() or {})
    except Exception:  # pragma: no cover — backend without cost analysis
        return {}


def _lower_fused(dataset, config: GPPVAETrainConfig, mesh=None,
                 n_epochs: int | None = None):
    """Trace + lower (NOT compile) the fused multi-epoch program at this
    config's true shapes; shared by fused_epoch_cost and
    fused_epoch_program_hash.

    For non-nystrom configs the argument pytree is built ABSTRACTLY — one
    `jax.eval_shape` over the real `_setup` — so NO device op runs and no
    train images are uploaded just to hash the program. rbf-nystrom needs
    the concrete X values for landmark selection, so it keeps the device
    path.
    """
    n = n_epochs or config.epochs_per_dispatch
    nystrom_idx = None
    if config.object_kernel == "rbf-nystrom" or mesh is not None:
        # concrete path: landmark selection needs real X values, and
        # shard_rows does real device_puts onto the mesh
        model, params, fixed_W, arrays, rng, num_train = _setup(
            dataset, config, None, mesh
        )
        if config.object_kernel == "rbf-nystrom":
            nystrom_idx = _select_nystrom_landmarks(
                params["gp"]["X"], config
            )
        keys = epoch_keys(rng, 0, n)
    else:
        aux = {}

        def build():
            model, params, fixed_W, arrays, rng, num_train = _setup(
                dataset, config, None, mesh
            )
            aux["model"], aux["num_train"] = model, num_train
            return params, fixed_W, arrays, epoch_keys(rng, 0, n)

        params, fixed_W, arrays, keys = jax.eval_shape(build)
        model, num_train = aux["model"], aux["num_train"]
    accum = resolve_grad_accum(config.grad_accum_steps, num_train,
                               config.batch_size)
    opt_vae = make_optimizer(config.lr_vae, config.clip_grad_norm, accum)
    opt_gp = make_optimizer(config.lr_gp, config.clip_grad_norm, accum)
    loop = _Loop(model, opt_vae, opt_gp, config, num_train, mesh,
                 nystrom_idx=nystrom_idx)
    a = arrays
    return loop.make_fused_fn(n).lower(
        params, jax.eval_shape(opt_vae.init, params["vae"]),
        jax.eval_shape(opt_gp.init, params["gp"]),
        fixed_W, a["images_tr"], a["d_tr"], a["q_tr"],
        a["y_ho"], a["d_ho"], a["q_ho"], keys,
        a["row_mask"],
    )


def fused_epoch_program_hash(dataset, config: GPPVAETrainConfig, mesh=None,
                             n_epochs: int | None = None) -> str:
    """Stable identity of the fused program: sha1 of the lowered StableHLO
    text (host-side tracing only — no device, no compile). Same hash ⇒
    same program, so wall-clock drift can never masquerade as a program
    change; the bench artifact records it next to the headline
    (round-3 VERDICT weak #6 — the device-trace fingerprint from
    tools/trace_summary.py remains the on-device arbiter)."""
    import hashlib

    text = _lower_fused(dataset, config, mesh, n_epochs).as_text()
    return hashlib.sha1(text.encode()).hexdigest()[:16]


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="GPPVAE training (dis/joint)")
    p.add_argument("--data", default="synthetic",
                   help="synthetic | sklearn | mnist:<dir> | faces[:h5:<path>] | npz:<path>")
    p.add_argument("--outdir", default="./out/gppvae")
    p.add_argument("--mode", default="joint", choices=["joint", "dis"])
    p.add_argument("--vae_weights", default=None,
                   help="pretrained VAE weights from train_vae (handoff artifact)")
    p.add_argument("--resume", default=None,
                   help="full-state checkpoint (final_state / state_NNNN) to resume")
    p.add_argument("--zdim", type=int, default=16)
    p.add_argument("--bs", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4, help="VAE learning rate")
    p.add_argument("--gp_lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma_y", type=float, default=0.1)
    p.add_argument("--xdim", type=int, default=8, help="object feature rank M")
    p.add_argument("--view_freqs", type=int, default=3)
    p.add_argument("--object_kernel", default="linear",
                   choices=["linear", "rbf", "rbf-nystrom"])
    p.add_argument("--rff_features", type=int, default=32,
                   help="RFF rank for the rbf object kernels")
    p.add_argument("--nystrom_rank", type=int, default=16,
                   help="landmark count for object_kernel=rbf-nystrom")
    p.add_argument("--num_objects", type=int, default=400)
    p.add_argument("--num_views", type=int, default=16)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--dec_upsample", default="resize",
                   choices=["resize", "subpixel"])
    p.add_argument("--polish_epochs", type=int, default=0,
                   help="with --dtype bfloat16: run the final K epochs in "
                        "float32 (automatic mixed-precision polish)")
    p.add_argument("--clip_grad_norm", type=float, default=1e5,
                   help="global-norm gradient clip guarding Adam against "
                        "spike poisoning (<=0 disables)")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="one optimizer step per k minibatches (large-N "
                        "trust-region knob; k ~ (N/bs)/45; -1 = auto-apply "
                        "that rule from the dataset's N)")
    p.add_argument("--refresh_every_steps", type=int, default=0,
                   help="re-expand the Taylor surrogate every k minibatch "
                        "steps inside the epoch (0 = once per epoch)")
    p.add_argument("--learn_sigma_y", action="store_true",
                   help="learn the decoder noise std (log-param in the GP group)")
    p.add_argument("--extra_effects", default="",
                   help="comma-separated additional random effects beyond the "
                        "object×view product: object,view")
    p.add_argument("--encode_chunk", type=int, default=1024,
                   help="Phase-A scan chunk size (activation footprint cap)")
    p.add_argument("--scan_unroll", type=int, default=1,
                   help="minibatch-scan unroll factor")
    p.add_argument("--flat_images_threshold", type=int, default=0,
                   help="store train images flat (N, H·W·C) above this N "
                        "(0 = always; huge = never)")
    p.add_argument("--epochs_per_dispatch", type=int, default=1)
    p.add_argument("--profile_phases", action="store_true")
    p.add_argument("--profile_dir", default=None,
                   help="write a jax.profiler trace here (view with xprof)")
    p.add_argument("--panel_every", type=int, default=10)
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="epochs between resumable state_NNNN checkpoints "
                        "(0 = final_state only)")
    p.add_argument("--view_feature_dim", type=int, default=None,
                   help="explicit view-feature rank M_w (odd >= 3 for "
                        "periodic view aux; default 2*view_freqs+1)")
    p.add_argument("--rff_lengthscale", type=float, default=1.0,
                   help="RBF lengthscale for the rbf object kernels")
    p.add_argument("--init_v_sig", type=float, default=1.0)
    p.add_argument("--init_v_noise", type=float, default=0.5)
    p.add_argument("--enc_features", default="32,64,128",
                   help="comma-separated encoder conv channels")
    p.add_argument("--dec_features", default="128,64,32",
                   help="comma-separated decoder conv channels")
    p.add_argument("--image_size", type=int, default=None,
                   help="spatial size for built datasets (default: builder's"
                        " own — 32 digits / 64 faces); e.g. 128 reaches the"
                        " benched face-view shape")
    args = p.parse_args(argv)

    from gppvae_tpu.config.datasets import build_dataset_from_flag

    ds = build_dataset_from_flag(args.data, args.num_objects, args.num_views,
                                 args.seed, image_size=args.image_size)
    config = GPPVAETrainConfig(
        mode=args.mode, zdim=args.zdim, epochs=args.epochs, batch_size=args.bs,
        lr_vae=args.lr, lr_gp=args.gp_lr, seed=args.seed, sigma_y=args.sigma_y,
        obj_feature_dim=args.xdim, view_num_freqs=args.view_freqs,
        object_kernel=args.object_kernel, rff_features=args.rff_features,
        nystrom_rank=args.nystrom_rank,
        compute_dtype=args.dtype, vae_weights=args.vae_weights, dec_upsample=args.dec_upsample,
        polish_epochs=args.polish_epochs,
        clip_grad_norm=args.clip_grad_norm,
        grad_accum_steps=args.grad_accum_steps,
        refresh_every_steps=args.refresh_every_steps,
        learn_sigma_y=args.learn_sigma_y,
        extra_effects=tuple(
            e.strip() for e in args.extra_effects.split(",") if e.strip()
        ),
        encode_chunk=args.encode_chunk,
        scan_unroll=args.scan_unroll,
        flat_images_threshold=args.flat_images_threshold,
        resume=args.resume, data=args.data,
        epochs_per_dispatch=args.epochs_per_dispatch,
        profile_phases=args.profile_phases,
        profile_dir=args.profile_dir,
        outdir=args.outdir, panel_every=args.panel_every,
        checkpoint_every=args.checkpoint_every,
        view_feature_dim=args.view_feature_dim,
        rff_lengthscale=args.rff_lengthscale,
        init_v_sig=args.init_v_sig, init_v_noise=args.init_v_noise,
        enc_features=tuple(int(f) for f in args.enc_features.split(",")),
        dec_features=tuple(int(f) for f in args.dec_features.split(",")),
    )
    train_gppvae(ds, config)


if __name__ == "__main__":
    main()

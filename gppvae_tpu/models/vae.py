"""Convolutional VAE encoder/decoder in plain JAX.

Rebuild of the reference's conv VAE (pysrc/faceplace/vae.py, SURVEY.md
§2.1): stride-2 conv stack → linear heads (z_mu, z_logvar); decoder
mirrors it with resize+conv upsampling. Design notes:

  * channels-last NHWC, 3×3 kernels, stride-2 downsampling.
  * upsampling is nearest-resize + conv rather than transposed conv:
    identical expressiveness, no checkerboard artifacts, and a friendlier
    XLA lowering than conv_transpose.
  * `dtype` sets the activation/compute dtype (bfloat16 for tensor-core
    speed); params stay float32; outputs are cast back to float32.
  * decoder output is a logit image; the trainer applies a sigmoid for the
    [0,1]-normalized datasets.

The modules are frozen dataclasses with a flax-style surface —
`init(key, *example_args) -> {"params": tree}` and
`apply(variables, *args, method=VAE.encode)` — and the flax parameter tree
(`encoder/Conv_0/kernel`, `encoder/head_mu/bias`, …), so checkpoints and
serving artifacts keep their layout. Kernels are LeCun-normal, biases zero.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()


def _dense_init(key, n_in: int, n_out: int) -> dict:
    return {"kernel": _lecun_normal(key, (n_in, n_out), jnp.float32),
            "bias": jnp.zeros((n_out,), jnp.float32)}


def _conv_init(key, c_in: int, c_out: int) -> dict:
    return {"kernel": _lecun_normal(key, (3, 3, c_in, c_out), jnp.float32),
            "bias": jnp.zeros((c_out,), jnp.float32)}


def _dense(p: dict, x: jax.Array, dtype) -> jax.Array:
    return jnp.dot(x.astype(dtype), p["kernel"].astype(dtype)) + p["bias"].astype(dtype)


def _conv(p: dict, x: jax.Array, dtype, stride: int = 1) -> jax.Array:
    """3×3 SAME conv, NHWC/HWIO, computed in `dtype`."""
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype),
        window_strides=(stride, stride), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + p["bias"].astype(dtype)


class _Module:
    """flax-style `apply`: `method` is an unbound method of the class taking
    (self, params, *args); the default is the module's `forward`."""

    def apply(self, variables, *args, method=None):
        return (method or type(self).forward)(self, variables["params"], *args)


def reparameterize(rng: jax.Array, mu: jax.Array, logvar: jax.Array) -> jax.Array:
    """z = μ + exp(½ logvar)·ε, ε ~ N(0, I) (SURVEY.md §3.1 hot loop)."""
    eps = jax.random.normal(rng, mu.shape, mu.dtype)
    return mu + jnp.exp(0.5 * logvar) * eps


def encode_all(
    model,
    params,
    images: jax.Array,
    chunk: int,
    *,
    method=None,
    extra: tuple = (),
    batch_sharding=None,
) -> jax.Array:
    """Grad-free full-dataset encode (latent means) — GPPVAE Phase A.

    Chunked lax.scan caps the conv activation footprint at `chunk` rows
    regardless of N; used by the trainers and the eval CLI alike.

    method: encoder method (defaults to VAE.encode); extra: additional
    per-row arrays passed alongside the images (e.g. the CVAE's view ids);
    batch_sharding: under SPMD, the NamedSharding each scanned chunk keeps
    its rows in (chunk must divide by the data-axis size) — chunking and
    N-row sharding compose, so Phase A stays bounded-memory on a mesh.

    Accepts FLAT (N, H·W·C) image storage too (ndim == 2 — the trainer's
    large-N layout, GPPVAETrainConfig.flat_images_threshold): each chunk is
    reshaped back to the model's image_shape right before the conv.
    """
    method = method or VAE.encode
    n = images.shape[0]

    def unflat(y):
        return y.reshape(y.shape[0], *model.image_shape) if y.ndim == 2 else y

    if chunk >= n:
        mu, _ = model.apply(params, unflat(images), *extra, method=method)
        return mu

    nshards = _row_shard_count(batch_sharding)
    if nshards > 1 and n % nshards == 0 and chunk % nshards == 0:
        return _encode_all_sharded(model, params, images, chunk, method,
                                   extra, batch_sharding, nshards)

    def padchunk(a):
        pad = (-n) % chunk
        padded = jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        return padded.reshape(-1, chunk, *a.shape[1:])

    def enc(_, rows):
        y = rows[0]
        if batch_sharding is not None:
            y = jax.lax.with_sharding_constraint(y, batch_sharding)
        mu, _lv = model.apply(params, unflat(y), *rows[1:], method=method)
        return None, mu

    _, Z = jax.lax.scan(enc, None, tuple(padchunk(a) for a in (images, *extra)))
    return Z.reshape(-1, Z.shape[-1])[:n]


def _row_shard_count(batch_sharding) -> int:
    """Number of mesh shards the row (dim-0) axis of `batch_sharding` splits
    into; 1 when unsharded/None."""
    if batch_sharding is None:
        return 1
    spec = batch_sharding.spec
    if not len(spec) or spec[0] is None:
        return 1
    axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    k = 1
    for ax in axes:
        k *= batch_sharding.mesh.shape[ax]
    return k


def _encode_all_sharded(model, params, images, chunk, method, extra,
                        batch_sharding, D):
    """Shard-LOCAL chunked encode: zero cross-device movement.

    The naive chunking (pad N → multiple of chunk, reshape to
    [nchunks, chunk, …]) cuts the row axis at GLOBAL offsets that never
    align with the mesh's contiguous per-device blocks, so XLA's SPMD
    partitioner re-lays-out the whole N×pixels array with all-to-alls and
    collective-permutes — measured N-sized wire traffic per Phase-A refresh
    (round-5 SPMD audit, tools/spmd_audit.py; it violated the structural
    claim of parallel/mesh.py that only R-sized psums + DP gradient psums
    cross the mesh). Encode is row-independent, so chunk boundaries are
    arbitrary: cut each device's LOCAL block instead. With N = D·local and
    S = chunk//D rows per device per step:

        [N,…] → [D, local, …]        reshard-free (split of the sharded dim
                                     at device boundaries)
        pad local → K·S              pad on an UNSHARDED dim — device-local
        → [D, K, S, …] → [K, D, S, …] transpose moves the named axis only —
                                     metadata, no movement
        scan over K, each step encodes [D·S, …] rows (D-way row-sharded)

    and the inverse transform reassembles Z in the original row order, so
    the result is bit-identical to the global chunking (same per-row conv
    work, rows merely regrouped across scan steps). The scan axis stays K
    (bounded activation footprint of chunk rows/step, as before)."""
    n = images.shape[0]
    local = n // D
    S = chunk // D
    K = -(-local // S)  # ceil

    def to_local_chunks(a):
        a = a.reshape(D, local, *a.shape[1:])
        a = jnp.pad(a, ((0, 0), (0, K * S - local)) + ((0, 0),) * (a.ndim - 2))
        a = a.reshape(D, K, S, *a.shape[2:])
        return jnp.moveaxis(a, 1, 0)  # [K, D, S, …]

    def unflat(y):
        return y.reshape(y.shape[0], *model.image_shape) if y.ndim == 2 else y

    def enc(_, rows):
        y = rows[0].reshape(D * S, *rows[0].shape[2:])
        y = jax.lax.with_sharding_constraint(y, batch_sharding)
        xs = [r.reshape(D * S, *r.shape[2:]) for r in rows[1:]]
        mu, _lv = model.apply(params, unflat(y), *xs, method=method)
        return None, mu.reshape(D, S, mu.shape[-1])

    _, Z = jax.lax.scan(
        enc, None, tuple(to_local_chunks(a) for a in (images, *extra))
    )
    # [K, D, S, L] → [D, K·S, L] → drop local pad → original row order
    Z = jnp.moveaxis(Z, 0, 1).reshape(D, K * S, -1)[:, :local]
    return Z.reshape(n, -1)


@dataclasses.dataclass(frozen=True)
class ConvEncoder(_Module):
    """Stride-2 conv stack → flatten → (z_mu, z_logvar) heads."""

    zdim: int
    features: Sequence[int] = (32, 64, 128)
    dtype: jnp.dtype = jnp.float32

    def init_params(self, key, input_shape) -> dict:
        """Params for NHWC inputs of `input_shape` (batch dim ignored)."""
        _, h, w, c = input_shape
        keys = jax.random.split(key, len(self.features) + 3)
        p = {}
        for i, f in enumerate(self.features):
            p[f"Conv_{i}"] = _conv_init(keys[i], c, f)
            h, w, c = -(-h // 2), -(-w // 2), f
        hidden = 2 * self.zdim * 4
        k = len(self.features)
        p["Dense_0"] = _dense_init(keys[k], h * w * c, hidden)
        p["head_mu"] = _dense_init(keys[k + 1], hidden, self.zdim)
        p["head_logvar"] = _dense_init(keys[k + 2], hidden, self.zdim)
        return p

    def init(self, key, y: jax.Array) -> dict:
        return {"params": self.init_params(key, y.shape)}

    def forward(self, p: dict, y: jax.Array) -> tuple[jax.Array, jax.Array]:
        h = y.astype(self.dtype)
        for i in range(len(self.features)):
            h = jax.nn.elu(_conv(p[f"Conv_{i}"], h, self.dtype, stride=2))
        h = h.reshape(h.shape[0], -1)
        h = jax.nn.elu(_dense(p["Dense_0"], h, self.dtype))
        mu = _dense(p["head_mu"], h, self.dtype)
        logvar = _dense(p["head_logvar"], h, self.dtype)
        return mu.astype(jnp.float32), logvar.astype(jnp.float32)


# Tap-merge matrices for the subpixel rewrite of nearest-resize×2 + 3×3
# conv. With u[j] = x[floor(j/2)] (verified jax nearest convention), the
# 3-tap window over u at output phase d reads only 2 low-res taps:
#   y[2i]   = w0·x[i-1] + (w1+w2)·x[i]        (phase 0, taps {i-1, i})
#   y[2i+1] = (w0+w1)·x[i] + w2·x[i+1]        (phase 1, taps {i, i+1})
# _PHASE_TAPS[d][u, p] maps 3×3 kernel taps p → 2×2 kernel taps u per axis.
_PHASE_TAPS = (
    ((1.0, 0.0, 0.0), (0.0, 1.0, 1.0)),  # phase 0
    ((1.0, 1.0, 0.0), (0.0, 0.0, 1.0)),  # phase 1
)


def _subpixel_upconv(p: dict, x: jax.Array, dtype) -> jax.Array:
    """nearest-resize×2 followed by the 3×3 SAME conv `p`, computed without
    materializing the upsampled tensor — an exact algebraic rewrite (same
    parameters, same math up to fp reassociation): the upsample duplicates
    pixels, so the 3×3 conv's taps that land on the same low-res pixel can
    be pre-summed. The decoder's resize+conv blocks are ~90% of GPPVAE
    epoch FLOPs (utils/flops.py).

    Three equivalent lowerings, selectable via GPPVAE_SUBPIXEL_IMPL:

      'dilated' (DEFAULT): one 4×4 conv with lhs_dilation=2 — the composed
          transposed conv. XLA's backprop-conv machinery splits the phases
          internally and writes the interleaved output directly; no
          depth-to-space pass exists at the HLO level.
      'stack': 2×2 conv with 4f output channels + slice/stack
          depth-to-space; the stack/reshape materializes the phase tensor.
      'padsum': interleave as a sum of interior-padded phases.

    Which is fastest on the GPU is not measured yet.
    """
    x = x.astype(dtype)
    w3 = p["kernel"].astype(dtype)  # (3, 3, cin, f)
    bias = p["bias"].astype(dtype)  # (f,)
    f = w3.shape[-1]
    # read the env ONCE, validated: a typo'd value must not fall through to
    # a default lowering silently
    impl = os.environ.get("GPPVAE_SUBPIXEL_IMPL", "dilated")
    if impl not in ("dilated", "stack", "padsum"):
        raise ValueError(
            f"GPPVAE_SUBPIXEL_IMPL={impl!r} is not one of "
            "'dilated' | 'stack' | 'padsum'"
        )
    if impl == "dilated":
        # transposed-conv formulation: compose nearest-up (2-tap kernel of
        # ones, stride-2 input dilation) with the 3×3 conv into ONE 4×4
        # input-dilated conv. Per-axis tap map T[k,p] = [p - t = k - 1 for
        # t∈{0,1}] (same merge algebra as _PHASE_TAPS). The tap merge stays
        # an einsum so XLA can fuse its transpose into the weight-gradient
        # conv.
        T = jnp.asarray(
            [[1.0, 0, 0], [1, 1, 0], [0, 1, 1], [0, 0, 1]], w3.dtype
        )  # (4, 3)
        K4 = jnp.einsum("up,vq,pqio->uvio", T, T, w3)  # (4, 4, cin, f)
        y = jax.lax.conv_general_dilated(
            x, K4, window_strides=(1, 1), padding=((2, 2), (2, 2)),
            lhs_dilation=(2, 2),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )  # (b, 2h, 2w, f)
        return y + bias
    M = jnp.asarray(_PHASE_TAPS, dtype=w3.dtype)  # (2, 2, 3)
    # phase order (dr, dc) row-major in the output-channel axis
    K = jnp.concatenate(
        [
            jnp.einsum("up,vq,pqio->uvio", M[dr], M[dc], w3)
            for dr in (0, 1)
            for dc in (0, 1)
        ],
        axis=-1,
    )  # (2, 2, cin, 4f)
    o = jax.lax.conv_general_dilated(
        x, K, window_strides=(1, 1), padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )  # (b, h+1, w+1, 4f): window i covers low-res taps {i-1, i}
    hh, ww = x.shape[1], x.shape[2]
    if impl == "padsum":
        zero = jnp.zeros((), o.dtype)
        y = None
        for dr in (0, 1):
            for dc in (0, 1):
                ph = o[:, dr : dr + hh, dc : dc + ww,
                       (2 * dr + dc) * f : (2 * dr + dc + 1) * f]
                t = jax.lax.pad(
                    ph, zero,
                    [(0, 0, 0), (dr, 1 - dr, 1), (dc, 1 - dc, 1), (0, 0, 0)],
                )  # (b, 2h, 2w, f), nonzero only at rows≡dr, cols≡dc mod 2
                y = t if y is None else y + t
        return y + bias
    # phase (dr, dc) lives at window offset (dr, dc): phase 1's taps
    # {i, i+1} are window i+1 of the padded conv
    phases = [
        [
            o[:, dr : dr + hh, dc : dc + ww,
              (2 * dr + dc) * f : (2 * dr + dc + 1) * f]
            for dc in (0, 1)
        ]
        for dr in (0, 1)
    ]
    t = jnp.stack(
        [jnp.stack(row, axis=3) for row in phases], axis=2
    )  # (b, h, 2, w, 2, f): [b, i, dr, j, dc, c]
    y = t.reshape(x.shape[0], 2 * hh, 2 * ww, f)
    return y + bias


@dataclasses.dataclass(frozen=True)
class ConvDecoder(_Module):
    """Dense → reshape → (nearest-resize ×2 + conv) stack → logit image.

    upsample: 'resize' applies the literal nearest-resize + 3×3 conv;
    'subpixel' computes the SAME function (shared params, identical
    checkpoint tree) as a fused low-res conv (see _subpixel_upconv).
    """

    image_shape: tuple[int, int, int]  # (H, W, C)
    features: Sequence[int] = (128, 64, 32)
    dtype: jnp.dtype = jnp.float32
    upsample: str = "resize"

    def _base_hw(self) -> tuple[int, int]:
        H, W, _ = self.image_shape
        depth = len(self.features)
        h0, w0 = H // (2**depth), W // (2**depth)
        if h0 * (2**depth) != H or w0 * (2**depth) != W:
            raise ValueError(
                f"image {H}×{W} not divisible by 2^{depth}; adjust features"
            )
        if self.upsample not in ("resize", "subpixel"):
            raise ValueError(
                f"unknown upsample {self.upsample!r}; want 'resize' or 'subpixel'"
            )
        return h0, w0

    def init_params(self, key, in_dim: int) -> dict:
        h0, w0 = self._base_hw()
        feats = tuple(self.features)
        keys = jax.random.split(key, len(feats) + 2)
        p = {"Dense_0": _dense_init(keys[0], in_dim, h0 * w0 * feats[0])}
        c = feats[0]
        for i, f in enumerate(feats):
            p[f"Conv_{i}"] = _conv_init(keys[i + 1], c, f)
            c = f
        p[f"Conv_{len(feats)}"] = _conv_init(keys[-1], c, self.image_shape[2])
        return p

    def init(self, key, z: jax.Array) -> dict:
        return {"params": self.init_params(key, z.shape[-1])}

    def forward(self, p: dict, z: jax.Array) -> jax.Array:
        h0, w0 = self._base_hw()
        depth = len(self.features)
        h = jax.nn.elu(_dense(p["Dense_0"], z, self.dtype))
        h = h.reshape(h.shape[0], h0, w0, self.features[0])
        for i in range(depth):
            conv = p[f"Conv_{i}"]
            if self.upsample == "subpixel":
                h = jax.nn.elu(_subpixel_upconv(conv, h, self.dtype))
            else:
                b, hh, ww, cc = h.shape
                h = jax.image.resize(h, (b, hh * 2, ww * 2, cc), "nearest")
                h = jax.nn.elu(_conv(conv, h, self.dtype))
        logits = _conv(p[f"Conv_{depth}"], h, self.dtype)
        return logits.astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class VAE(_Module):
    """Encoder+decoder bundle; one params pytree for the --vae_weights handoff."""

    zdim: int
    image_shape: tuple[int, int, int]
    enc_features: Sequence[int] = (32, 64, 128)
    dec_features: Sequence[int] = (128, 64, 32)
    dtype: jnp.dtype = jnp.float32
    upsample: str = "resize"

    @property
    def encoder(self) -> ConvEncoder:
        return ConvEncoder(self.zdim, tuple(self.enc_features), self.dtype)

    @property
    def decoder(self) -> ConvDecoder:
        return ConvDecoder(tuple(self.image_shape), tuple(self.dec_features),
                           self.dtype, self.upsample)

    def init(self, key, y: jax.Array, rng=None) -> dict:
        k_enc, k_dec = jax.random.split(key)
        return {"params": {
            "encoder": self.encoder.init_params(k_enc, y.shape),
            "decoder": self.decoder.init_params(k_dec, self.zdim),
        }}

    def forward(self, p: dict, y: jax.Array, rng: jax.Array):
        mu, logvar = self.encode(p, y)
        z = reparameterize(rng, mu, logvar)
        return self.decode(p, z), mu, logvar, z

    def encode(self, p: dict, y: jax.Array):
        return self.encoder.forward(p["encoder"], y)

    def decode(self, p: dict, z: jax.Array):
        return self.decoder.forward(p["decoder"], z)

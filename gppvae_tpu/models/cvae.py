"""Conditional VAE baseline (the paper's CVAE comparison model).

Casale et al. 2018 compare GPPVAE against a CVAE conditioned on the view:
the encoder sees (image, view) and the latent is meant to capture object
identity; the decoder reconstructs from (z, view). Out-of-sample conditional
generation for a held-out (object d, view q*) averages the object's encoded
latents over its training views and decodes with the target view — no GP.

Conditioning: the view id enters the encoder as Q constant one-hot planes
concatenated to the image channels (conv-friendly), and the decoder as a
one-hot vector concatenated to z.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from gppvae_tpu.models.vae import VAE, reparameterize


@dataclasses.dataclass(frozen=True)
class CVAE(VAE):
    """VAE whose encoder and decoder also see the view id (same parameter
    tree as VAE, wider first layers)."""

    num_views: int = dataclasses.field(kw_only=True)

    def _cond_planes(self, y: jax.Array, q: jax.Array) -> jax.Array:
        onehot = jax.nn.one_hot(q, self.num_views, dtype=y.dtype)
        planes = jnp.broadcast_to(
            onehot[:, None, None, :], (*y.shape[:3], self.num_views)
        )
        return jnp.concatenate([y, planes], axis=-1)

    def init(self, key, y: jax.Array, q: jax.Array, rng=None) -> dict:
        k_enc, k_dec = jax.random.split(key)
        return {"params": {
            "encoder": self.encoder.init_params(
                k_enc, (*y.shape[:3], y.shape[3] + self.num_views)),
            "decoder": self.decoder.init_params(
                k_dec, self.zdim + self.num_views),
        }}

    def encode(self, p: dict, y: jax.Array, q: jax.Array):
        return self.encoder.forward(p["encoder"], self._cond_planes(y, q))

    def decode(self, p: dict, z: jax.Array, q: jax.Array):
        onehot = jax.nn.one_hot(q, self.num_views, dtype=z.dtype)
        return self.decoder.forward(
            p["decoder"], jnp.concatenate([z, onehot], axis=-1))

    def forward(self, p: dict, y: jax.Array, q: jax.Array, rng: jax.Array):
        mu, logvar = self.encode(p, y, q)
        z = reparameterize(rng, mu, logvar)
        return self.decode(p, z, q), mu, logvar, z

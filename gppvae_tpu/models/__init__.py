"""Neural nets: conv Encoder/Decoder stacks and the VAE assembly.

Reference counterpart: pysrc/faceplace/vae.py (SURVEY.md §2.1 "Conv VAE").
Plain-JAX modules; compute dtype is configurable (bfloat16 for the tensor
cores, float32 params; the GP layer always consumes float32 latents).
"""

from gppvae_tpu.models.cvae import CVAE
from gppvae_tpu.models.vae import (
    ConvDecoder,
    ConvEncoder,
    VAE,
    encode_all,
    reparameterize,
)

__all__ = [
    "ConvEncoder",
    "ConvDecoder",
    "CVAE",
    "VAE",
    "encode_all",
    "reparameterize",
]

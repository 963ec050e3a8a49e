"""gppvae_tpu — a Gaussian Process Prior VAE framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
PyTorch implementation of Casale et al. 2018, "Gaussian Process Prior
Variational Autoencoders" (NeurIPS 2018, arXiv:1810.11738); see SURVEY.md at
the repo root for the reference analysis (reference: ahmerb/GPPVAE,
pysrc/faceplace/{vae,gp,train_vae,train_gppvae}.py — mount unavailable, so
parity claims cite SURVEY.md sections instead of file:line).

Layers (bottom → top):
  ops/        the GP linear algebra hot ops (plain jax.numpy / lax)
  gp/         low-rank (Woodbury) GP prior: NLL, Taylor surrogate, predictive
  models/     conv Encoder/Decoder (plain JAX), VAE assembly
  parallel/   device mesh, shardings, SPMD wire audit
  data/       rotated-digits builder, FacePlace loader, splits
  train/      train_vae / train_gppvae drivers (vanilla, dis, joint)
  eval/       out-of-sample GP-predictive generation, MSE, image panels
  config/     typed configs + reference-flag-compatible CLI
  checkpoint/ .npz save/restore, --vae_weights handoff
  utils/      metrics JSONL, timers, rng
"""

__version__ = "0.1.0"


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache at a fixed path.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here. Otherwise the cache lives in `<checkout>/.jax_cache`: the
    directory is part of the cache key, so it must not move between runs."""
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_compilation_cache_dir", os.path.join(root, ".jax_cache"))


_enable_compile_cache()

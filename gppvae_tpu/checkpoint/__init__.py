"""Checkpoint/resume as single numpy `.npz` files (SURVEY.md §5).

The reference torch.saves VAE (and GP) weights each epoch and resumes GPPVAE
from `--vae_weights`; here the full train-state pytree (params, optimizer
states, epoch counter) checkpoints to one file, and the cross-script
`--vae_weights` handoff is preserved as a params-subtree save/load.
"""

from gppvae_tpu.checkpoint.npz_io import (
    CheckpointFormatError,
    FORMAT_VERSION,
    load_pytree,
    load_train_state,
    save_pytree,
    save_train_state,
    load_vae_weights,
    save_vae_weights,
)

__all__ = [
    "CheckpointFormatError", "FORMAT_VERSION",
    "load_pytree", "save_pytree", "load_train_state", "save_train_state",
    "load_vae_weights", "save_vae_weights",
]

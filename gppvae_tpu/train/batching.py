"""Minibatch index plans that cover ALL rows every epoch.

The reference's epoch loop truncates each permutation at nb·bs rows, so the
last N mod bs rows of every epoch receive no gradient (and the documented
"accumulated epoch gradient equals the exact full-data gradient" identity of
the GP Taylor surrogate only holds when bs | N). Here the last batch is
padded by wrap-around and masked with per-row weights instead: every row
appears exactly once with weight 1; padding rows carry weight 0.

Loss convention that goes with it (all drivers follow it): per-sample terms
are summed over *valid* rows and divided by the constant bs, so each sample
contributes exactly 1/bs to the epoch-accumulated gradient regardless of
which batch it lands in — the surrogate identity holds for ANY N
(tested at non-divisible N/bs in tests/test_gp_math.py). For batches with no
padding this equals the old per-batch mean, so divisible-shape trajectories
are bit-identical to round 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def num_batches(num_train: int, bs: int) -> int:
    """ceil(num_train / bs) — every row trains every epoch."""
    return -(-num_train // bs)


def epoch_batches(
    key: jax.Array, idx: int | jax.Array, bs: int
) -> tuple[jax.Array, jax.Array]:
    """Permuted minibatch plan covering all rows.

    idx: int N (plan over positions 0..N-1) or an (N,) index array to
    permute. Returns (batches (nb, bs) int, weights (nb, bs) float32).
    """
    if isinstance(idx, int):
        n = idx
        perm = jax.random.permutation(key, n)
    else:
        n = idx.shape[0]
        perm = jax.random.permutation(key, idx)
    if bs > n:
        raise ValueError(f"batch_size {bs} exceeds train set {n}")
    nb = num_batches(n, bs)
    pad = nb * bs - n
    weights = jnp.ones((n,), jnp.float32)
    if pad:
        perm = jnp.concatenate([perm, perm[:pad]])
        weights = jnp.concatenate([weights, jnp.zeros((pad,), jnp.float32)])
    return perm.reshape(nb, bs), weights.reshape(nb, bs)


from functools import partial


@partial(jax.jit, static_argnums=2)
def _epoch_keys_jit(base: jax.Array, start: jax.Array, n: int) -> jax.Array:
    return jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.arange(n, dtype=jnp.int32) + start
    )


def epoch_keys(base: jax.Array, start: int | jax.Array, n: int) -> jax.Array:
    """Per-epoch RNG keys for epochs [start, start+n): key_e = fold_in(base, e).

    Keyed by ABSOLUTE epoch index, not by draw order, so the stream is
    invariant to dispatch boundaries: a resumed run, a different
    epochs_per_dispatch, and an uninterrupted run all consume identical keys
    per epoch (trajectory-preserving resume; golden-pinned).

    `start` is passed as a traced scalar so successive dispatches reuse ONE
    compiled program — baking it as a constant recompiled every dispatch.
    """
    return _epoch_keys_jit(base, jnp.asarray(start, jnp.int32), n)


def masked_means(weights: jax.Array, *terms: jax.Array) -> tuple[jax.Array, ...]:
    """Weighted per-valid-row means of (bs,) per-sample terms — the metric
    convention (reported numbers describe real rows only)."""
    nvalid = jnp.sum(weights)
    return tuple(jnp.sum(weights * t) / nvalid for t in terms)

"""Measure streaming-conditioning (observe) fold throughput on the chip.

The observe path (gp.extend_posterior_core + encoder forward) is
exactness-tested and drift-bounded (BASELINE round-5), but no sustained
rate was ever recorded — a deployment planning continuous conditioning
needs rows/s, not just correctness. Protocol mirrors bench's sustained
discipline: one jitted fold program (state as a pytree argument, fixed
batch shape), K chained folds inside ONE lax.scan dispatch with a
checksum readback (the chain is sequential by construction — core_{i+1}
depends on core_i — so this measures the true dependent-fold rate, and
the checksum depends on every fold's output, so no fold can be skipped).

    python tools/observe_throughput.py [--out FILE.json]

Prints one JSON line per shape: digits 32² and face 128² models, fold
batch 200, chain 20.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def measure(name, ds_kwargs, model_kwargs, bs=200, chain=20, reps=3):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gppvae_tpu.data import build_faceplace, build_rotated_digits
    from gppvae_tpu.eval.serving import build_server_state, observe
    from gppvae_tpu.models import VAE
    from gppvae_tpu.train import GPPVAETrainConfig, train_gppvae
    from gppvae_tpu.utils.metrics import NullLogger

    if name.startswith("faces"):
        ds = build_faceplace("synthetic", **ds_kwargs)
    else:
        ds = build_rotated_digits("synthetic", **ds_kwargs)
    cfg = GPPVAETrainConfig(epochs=2, batch_size=64, seed=0, **model_kwargs)
    r = train_gppvae(ds, cfg, log=NullLogger())
    model: VAE = r.model
    tr = ds.train_idx
    state = build_server_state(
        model, r.params, r.fixed_W, jnp.asarray(ds.images[tr]),
        jnp.asarray(ds.object_ids[tr]), jnp.asarray(ds.view_ids[tr]),
    )

    # observation stream: training-grid cells with fresh images (values
    # don't matter for throughput; reuse dataset rows tiled to bs)
    idx = np.resize(np.arange(len(tr)), bs)
    imgs = jnp.asarray(ds.images[tr][idx])
    d = jnp.asarray(ds.object_ids[tr][idx])
    q = jnp.asarray(ds.view_ids[tr][idx])
    mask = jnp.ones((bs,), jnp.float32)

    def fold_once(st, _):
        st2 = observe(model, st, imgs, d, q, row_mask=mask,
                      encode_chunk=bs)
        return st2, jnp.sum(st2.core.M)

    @jax.jit
    def burst(st):
        st2, sums = jax.lax.scan(fold_once, st, None, length=chain)
        return st2.core.M, sums

    _ = jax.device_get(burst(state))  # compile/warm outside the timing
    times = []
    for _i in range(reps):
        t0 = time.perf_counter()
        _ = jax.device_get(burst(state))
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {
        "config": name,
        "fold_batch": bs,
        "chain": chain,
        "rank": int(state.core.G.shape[0]),
        "zdim": int(state.core.M.shape[1]),
        "best_s": round(best, 5),
        "folds_per_sec": round(chain / best, 1),
        "rows_per_sec": round(chain * bs / best),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rows = [
        measure("digits32", dict(num_objects=40, num_views=8, seed=0),
                dict(zdim=16)),
        measure("faces128",
                dict(num_people=20, num_poses=8, image_size=128, seed=0),
                dict(zdim=32, obj_feature_dim=8, view_num_freqs=3,
                     compute_dtype="bfloat16", dec_upsample="subpixel")),
    ]
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"observe_throughput": rows}, f, indent=1)


if __name__ == "__main__":
    main()

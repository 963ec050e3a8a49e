"""Pytree checkpoints as one `.npz` file: whole train states and VAE weights.

Each leaf is stored under its key path (`params/vae/encoder/Conv_0/kernel`,
`ov_state/inner/0/mu/...`). A restore with an abstract tree (a matching
pytree of arrays or ShapeDtypeStructs, which every training load site has)
rebuilds that exact structure, optax NamedTuple states included; a restore
without one returns nested dicts.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

# Train-state FORMAT HISTORY:
#   v1 (round-1 interim, never released): gp log_vs was a scalar; became a
#      per-effect vector.
#   v2 (rounds 1-2): optimizer states were plain optax.adam trees; round 3
#      wrapped them in spike_guard ({'inner': …, 'notfinite_count': …},
#      optionally inside optax.MultiSteps for grad_accum_steps>1).
#   v3 (round 3 on): spike-guarded states in an orbax checkpoint directory;
#      version recorded in a `<path>.format.json` sidecar from round 4 on.
#   v4 (CURRENT): the same tree in one numpy `.npz` file at `<path>`.
FORMAT_VERSION = 4

# dtypes numpy cannot store natively (bfloat16, fp8 …) ride as same-width
# unsigned ints; this entry maps key path → dtype name for those leaves
_DTYPES_KEY = "__dtypes__"


class CheckpointFormatError(RuntimeError):
    """A train-state checkpoint was written under an incompatible format."""


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _key_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unsupported pytree key {k!r}")


def _path_str(path) -> str:
    return "/".join(_key_name(k) for k in path)


def _check_not_orbax(path: str) -> None:
    if os.path.isdir(path):
        raise CheckpointFormatError(
            f"checkpoint {path!r} is a directory: an orbax checkpoint (format "
            f"v3 or older). This build reads the v{FORMAT_VERSION} single-file "
            ".npz format and does not depend on orbax; re-train, or convert "
            "it with the build that wrote it."
        )


def save_pytree(path: str, tree) -> None:
    """Save any pytree of arrays (train state, params, …) to the file `path`."""
    path = _abs(path)
    arrays, dtypes = {}, {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = _path_str(kp)
        a = np.asarray(jax.device_get(leaf))
        if a.dtype.type.__module__ != "numpy":  # ml_dtypes: bfloat16, fp8 …
            dtypes[name] = a.dtype.name
            a = a.view(f"u{a.dtype.itemsize}")
        arrays[name] = a
    arrays[_DTYPES_KEY] = np.asarray(json.dumps(dtypes))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # a crash mid-write never leaves a torn file


def _read(path: str) -> dict[str, np.ndarray]:
    _check_not_orbax(path)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    dtypes = json.loads(str(arrays.pop(_DTYPES_KEY, "{}")))
    for name, dt in dtypes.items():
        arrays[name] = arrays[name].view(jnp.dtype(dt))
    return arrays


def load_pytree(path: str, abstract_tree=None):
    """Restore a pytree saved by save_pytree. With `abstract_tree` (a
    matching pytree of arrays/ShapeDtypeStructs) the result has its exact
    structure and dtypes, and a missing, extra or reshaped leaf raises
    ValueError; without it, nested dicts of arrays come back."""
    arrays = _read(_abs(path))
    if abstract_tree is None:
        out: dict = {}
        for name, a in arrays.items():
            *parents, leaf = name.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(a)
        return out
    kps, treedef = jax.tree_util.tree_flatten_with_path(abstract_tree)
    names = [_path_str(kp) for kp, _ in kps]
    if set(names) != set(arrays):
        missing = sorted(set(names) - set(arrays))[:5]
        extra = sorted(set(arrays) - set(names))[:5]
        raise ValueError(
            f"checkpoint tree mismatch: missing {missing}, unexpected {extra}"
        )
    leaves = []
    for name, (_, ref) in zip(names, kps):
        a = arrays[name]
        if hasattr(ref, "shape"):
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint leaf {name!r} has shape {a.shape}, "
                    f"expected {tuple(ref.shape)}"
                )
            leaves.append(jnp.asarray(a, dtype=ref.dtype))
        else:  # python scalar in the abstract tree (e.g. the epoch count)
            leaves.append(a.item())
    return jax.tree_util.tree_unflatten(treedef, leaves)


def save_train_state(path: str, tree) -> None:
    """save_pytree + a `<path>.format.json` sidecar recording FORMAT_VERSION
    (same sidecar convention as the serving artifact's `.meta.json`)."""
    save_pytree(path, tree)
    with open(_abs(path) + ".format.json", "w") as f:
        json.dump({"format_version": FORMAT_VERSION}, f)


def load_train_state(path: str, abstract_tree):
    """Restore a full train state with a NAMED error on format mismatch.

    An orbax-era directory, a sidecar naming another version, an unreadable
    sidecar and a tree that does not match the current one all raise
    CheckpointFormatError explaining the format history."""
    _check_not_orbax(_abs(path))
    sidecar = _abs(path) + ".format.json"
    version = FORMAT_VERSION
    if os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                version = json.load(f).get("format_version")
        except (OSError, json.JSONDecodeError) as e:
            # a truncated sidecar (partial write during a crash) must get
            # the same named-error treatment as a version mismatch, not a
            # raw JSONDecodeError
            raise CheckpointFormatError(
                f"checkpoint {path!r} has an unreadable format sidecar "
                f"{sidecar!r} ({e}); it may be a partial write — delete the "
                "sidecar to attempt a plain restore at the current format "
                f"v{FORMAT_VERSION}."
            ) from e
    if version != FORMAT_VERSION:
        raise CheckpointFormatError(
            f"checkpoint {path!r} records format_version={version}, but this "
            f"build reads v{FORMAT_VERSION}. Format breaks: v1→v2 log_vs "
            "became a per-effect vector (round 1); v2→v3 the optimizer "
            "states gained the spike_guard wrapper (round 3); v3→v4 orbax "
            "directories became single .npz files. Re-train, or re-save the "
            "state with the build that wrote it."
        )
    try:
        return load_pytree(path, abstract_tree)
    except (ValueError, KeyError, TypeError) as e:
        raise CheckpointFormatError(
            f"failed to restore train state {path!r}: its pytree does not "
            f"match the current format v{FORMAT_VERSION}. If it predates "
            "round 3 it carries pre-spike_guard optimizer states (or a "
            f"round-1 scalar log_vs) — interim formats that were never "
            f"released and are not loadable. Underlying error: {e}"
        ) from e


def save_vae_weights(path: str, vae_params) -> None:
    """The --vae_weights handoff artifact: encoder+decoder params only."""
    save_pytree(path, {"vae_params": vae_params})


def load_vae_weights(path: str, abstract_params=None):
    tree = load_pytree(
        path,
        {"vae_params": abstract_params} if abstract_params is not None else None,
    )
    return tree["vae_params"]

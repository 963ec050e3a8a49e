"""Optional dependencies of side paths, imported only when those run."""

from __future__ import annotations

import importlib


def optional_import(module: str, purpose: str):
    """Import `module`, or raise ImportError naming it and what needs it.

    The training and serving paths need only JAX, numpy and optax; plots,
    the FacePlace .h5 reader and the sklearn digits source pull in more."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{purpose} needs the optional package {module.split('.')[0]!r}, "
            f"which is not installed ({e})"
        ) from e

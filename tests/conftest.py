"""Test harness configuration.

The default tier runs on the CPU with a virtual 8-device mesh (the standard
JAX substitute for a fake distributed backend — SURVEY.md §4.5) and float64
enabled so math property tests can compare against dense oracles at tight
tolerance. Tests that need the card carry the `chip` marker and request
the `chip` fixture, which skips them unless JAX's backend is a GPU; run
them on a machine with a card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -q -m chip

The jax.config writes must happen before any backend initializes, hence at
import time.
"""

import os

import jax
import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    # x64 only on the CPU tier (dense-oracle math tests)
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def chip():
    """Skip unless the backend is a GPU (decided here, never at import or
    collection time, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: run with JAX_PLATFORMS=cuda on a machine with a card"
        )
    return jax.devices()[0]

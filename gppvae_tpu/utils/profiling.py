"""Profiling hooks (SURVEY.md §5 tracing/profiling).

Wraps a training run in a jax.profiler trace when a directory is given —
view with TensorBoard/XProf (`tensorboard --logdir <dir>`). A trace that
was asked for and cannot start raises.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield


def annotate(name: str):
    """Named trace span decorator/context for host-side phases."""
    import jax

    return jax.profiler.TraceAnnotation(name)

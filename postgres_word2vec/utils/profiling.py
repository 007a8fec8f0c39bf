"""Profiling — structured traces on top of the TRACK-style Tracker.

The reference's observability is ``clock()`` brackets + ``elog`` notices
(SURVEY §5.1). Here the host-side stage timer lives in utils/tracker.py;
this module adds the device-side view: a context manager around
``jax.profiler`` producing TensorBoard-loadable traces of the device
timeline (kernels, copies, collectives), plus a device memory snapshot helper.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import jax


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """Capture a jax.profiler trace for the enclosed block.

    View with TensorBoard's profile plugin. Works on GPU and CPU backends.
    """
    log_dir = str(log_dir)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats() -> dict:
    """Best-effort live/peak device memory counters (bytes)."""
    try:
        stats = jax.devices()[0].memory_stats() or {}
        return {k: v for k, v in stats.items()
                if isinstance(v, (int, float))}
    except Exception:
        return {}

"""The one decision of which implementation runs, and the device-memory
bounds the scans size themselves by.

On a GPU the compiled Triton kernels (``ops/pallas_kernels.py``) and the
binned approximate top-k run; on any other backend (the CPU the tests run
on) the plain-XLA references run. Every family asks :func:`use_kernels`;
nothing else in the package tests the platform.
"""

from __future__ import annotations

import jax

#: memory assumed where the runtime reports none (the CPU backend)
_FALLBACK_LIMIT = 4 * 2**30


def use_kernels() -> bool:
    """True when the default backend is a GPU."""
    return jax.default_backend() == "gpu"


def kernels_for(impl: str | None) -> bool:
    """A search's ``impl`` argument resolved: None takes
    :func:`use_kernels`, "xla" the plain-XLA reference on any backend."""
    if impl not in (None, "xla"):
        raise ValueError(f"impl must be None or 'xla', got {impl!r}")
    return impl is None and use_kernels()


def memory_limit_bytes() -> int:
    """Bytes the runtime lets this process allocate on the first device."""
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", _FALLBACK_LIMIT))


def scan_chunk(batch: int, n: int, *, bytes_per_row: int = 4,
               share: int = 32, floor: int = 1 << 14) -> int:
    """Rows per chunk of a chunked ``(batch, chunk)`` distance scan: the
    largest power of two whose score block takes at most ``1/share`` of
    the device's memory, at least ``floor`` and at most ``n``."""
    budget = memory_limit_bytes() // share
    rows = max(budget // max(batch * bytes_per_row, 1), 1)
    chunk = max(1 << (rows.bit_length() - 1), floor)
    return max(min(chunk, n), 1)

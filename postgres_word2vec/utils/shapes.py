"""Static shape helpers shared by the chunked device scans."""

from __future__ import annotations


def snap_chunk(n: int, chunk_size: int, *, align: int = 8) -> int:
    """Largest divisor of ``n`` in ``[chunk_size/2, chunk_size]`` that keeps
    ``align``-row alignment, else ``chunk_size`` unchanged.

    When the chunk divides ``n``, a chunked scan needs no tail padding —
    the ``jnp.pad`` fallback otherwise materializes a full copy of the
    table, which at 10M×300 bf16 is a 5.7 GiB HBM spike (observed OOM in
    evaluation/scale_capacity.py before this fix). Pure Python; runs at
    trace time on static shapes."""
    if n % chunk_size == 0 or n <= chunk_size:
        return chunk_size
    best, i = 0, 1
    while i * i <= n:
        if n % i == 0:
            for d in (i, n // i):
                if chunk_size // 2 <= d <= chunk_size and d % align == 0:
                    best = max(best, d)
        i += 1
    return best or chunk_size

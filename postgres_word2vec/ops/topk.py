"""Top-k maintenance.

The reference maintains top-k with a branchy sorted-array insert executed per
candidate (``updateTopK``, index_utils.c:19-33) and a "fast PV" variant that
appends to a buffer and periodically qsorts (ivpq_search_in.c:40-57). Here:

- dense score blocks go through ``jax.lax.top_k``, or a lossless two-stage
  blockwise reduction for wide rows (on the GPU: for a few wide rows);
- ``approx=True`` asks for a partial reduction: one survivor per strided
  bin, then an exact top-k over the survivors (on the GPU; the CPU
  reference stays exact), and
- streaming over N happens as a ``lax.scan`` over fixed-size chunks with a
  running top-k merged by concat + re-top-k — the functional analog of the
  reference's append+qsort trick, with static shapes throughout.

Distances are "smaller is better" everywhere in this module unless a function
says otherwise; internally we negate and use max-k.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from postgres_word2vec.ops import backend

Array = jax.Array


#: Rows at least this wide take the exact two-stage (blockwise) reduction
#: on the CPU, where XLA lowers a wide-row top_k to a sort of the whole row,
#: and on the GPU when there are at most ``_GPU_BLOCKWISE_ROWS`` of them:
#: XLA's GPU top_k works a row at a time, so a few wide rows leave the card
#: idle, while from B=256 up it beats the blockwise rule (H100; PERF.md).
_BLOCKWISE_THRESHOLD = 65536
_GPU_BLOCKWISE_ROWS = 16
_BLOCK = 8192


def _blockwise_top_k_smallest(dists: Array, k: int,
                              block: int = _BLOCK) -> tuple[Array, Array]:
    """Exact top-k via per-block top-k + merge (k ≤ block ⇒ lossless)."""
    *lead, n = dists.shape
    pad = (-n) % block
    if pad:
        dists = jnp.pad(dists, [(0, 0)] * len(lead) + [(0, pad)],
                        constant_values=jnp.inf)
    nb = (n + pad) // block
    dp = dists.reshape(*lead, nb, block)
    kb = min(k, block)
    neg, pos = lax.top_k(-dp, kb)                       # (..., nb, kb)
    base = (jnp.arange(nb, dtype=jnp.int32) * block)[..., :, None]
    idx = (pos + base).reshape(*lead, nb * kb)
    neg = neg.reshape(*lead, nb * kb)
    neg2, pos2 = lax.top_k(neg, k)
    return -neg2, jnp.take_along_axis(idx, pos2, axis=-1)


def approx_bins(k: int, recall_target: float) -> int:
    """Strided bins for an expected recall of ``recall_target``: a top-k
    member is lost only when a better one shares its bin, so the expected
    loss over k members is (k−1)/(2L); L is rounded up to a power of two."""
    need = max(k, int((k - 1) / (2.0 * (1.0 - recall_target))) + 1, 128)
    return 1 << (need - 1).bit_length()


def _binned_top_k_smallest(dists: Array, k: int,
                           recall_target: float) -> tuple[Array, Array]:
    """Approximate top-k: per strided bin (bin j = columns j, j+L, …) keep
    the minimum, then an exact top-k over the L survivors."""
    *lead, n = dists.shape
    nbins = approx_bins(k, recall_target)
    if 2 * nbins >= n:
        return _exact_top_k_smallest(dists, k)
    rows = -(-n // nbins)
    pad = rows * nbins - n
    if pad:
        dists = jnp.pad(dists, [(0, 0)] * len(lead) + [(0, pad)],
                        constant_values=jnp.inf)
    d3 = dists.reshape(*lead, rows, nbins)
    mins = jnp.min(d3, axis=-2)
    arg = jnp.argmin(d3, axis=-2).astype(jnp.int32)
    neg, pos = lax.top_k(-mins, k)
    row = jnp.take_along_axis(arg, pos, axis=-1)
    return -neg, row * nbins + pos.astype(jnp.int32)


def _use_blockwise(rows: int, n: int, k: int, on_gpu: bool) -> bool:
    """Exact-path routing for ``rows`` rows of ``n`` columns: blockwise
    for wide rows, on the GPU only for a few of them."""
    if n < _BLOCKWISE_THRESHOLD or k > _BLOCK:
        return False
    return not on_gpu or rows <= _GPU_BLOCKWISE_ROWS


def _exact_top_k_smallest(dists: Array, k: int) -> tuple[Array, Array]:
    rows = math.prod(dists.shape[:-1])
    if _use_blockwise(rows, dists.shape[-1], k, backend.use_kernels()):
        return _blockwise_top_k_smallest(dists, k)
    neg, idx = lax.top_k(-dists, k)
    return -neg, idx


def top_k_smallest(dists: Array, k: int, *, approx: bool = False,
                   recall_target: float = 0.95) -> tuple[Array, Array]:
    """Top-k smallest values along the last axis → (values, indices).

    ``approx=True`` takes the binned partial reduction on the GPU (expected
    recall ``recall_target`` per query, see :func:`approx_bins`); the CPU
    reference answers exactly. The exact path switches to the lossless
    two-stage blockwise reduction for wide rows (replacing the reference's
    per-candidate sorted-array insert, index_utils.c:19-33).
    """
    if approx and backend.use_kernels():
        return _binned_top_k_smallest(dists, k, recall_target)
    return _exact_top_k_smallest(dists, k)


def top_k_largest(scores: Array, k: int, *, approx: bool = False,
                  recall_target: float = 0.95) -> tuple[Array, Array]:
    """Top-k largest values along the last axis → (values, indices)."""
    neg, idx = top_k_smallest(-scores, k, approx=approx,
                              recall_target=recall_target)
    return -neg, idx


def merge_top_k_smallest(vals_a: Array, idx_a: Array, vals_b: Array,
                         idx_b: Array, k: int) -> tuple[Array, Array]:
    """Merge two (…, ka)/(…, kb) smallest-value top-k sets into top-k."""
    vals = jnp.concatenate([vals_a, vals_b], axis=-1)
    idx = jnp.concatenate([idx_a, idx_b], axis=-1)
    neg, pos = lax.top_k(-vals, k)
    return -neg, jnp.take_along_axis(idx, pos, axis=-1)


def chunked_top_k_smallest(
    score_chunk_fn: Callable[[int], Array],
    num_items: int,
    chunk_size: int,
    k: int,
    batch_shape: tuple[int, ...],
    *,
    approx: bool = False,
) -> tuple[Array, Array]:
    """Streaming top-k-smallest over an item axis computed chunk by chunk.

    ``score_chunk_fn(start)`` must return distances of shape
    ``(*batch_shape, chunk_size)`` for items ``[start, start+chunk_size)``;
    out-of-range tail items must be scored ``+inf`` by the caller (or the
    caller pads ``num_items`` up). Returns global (values, indices) of shape
    ``(*batch_shape, k)``.

    This replaces the reference's per-row ``updateTopK`` scan
    (e.g. freddy.c:117-132) with a fixed-shape scan whose chunk body is one
    dense kernel — candidates never leave the device.
    """
    num_chunks = -(-num_items // chunk_size)
    init_vals = jnp.full((*batch_shape, k), jnp.inf, dtype=jnp.float32)
    init_idx = jnp.full((*batch_shape, k), -1, dtype=jnp.int32)

    def body(carry, c):
        run_vals, run_idx = carry
        start = c * chunk_size
        d = score_chunk_fn(start)
        c_vals, c_pos = top_k_smallest(d, min(k, chunk_size), approx=approx)
        c_vals = c_vals.astype(jnp.float32)
        c_idx = (c_pos + start).astype(jnp.int32)
        run_vals, run_idx = merge_top_k_smallest(run_vals, run_idx, c_vals,
                                                 c_idx, k)
        return (run_vals, run_idx), None

    (vals, idx), _ = lax.scan(body, (init_vals, init_idx),
                              jnp.arange(num_chunks))
    return vals, idx

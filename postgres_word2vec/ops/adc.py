"""Asymmetric distance computation (ADC) — the hot loop of every PQ family.

Parity targets: the per-row ``LUT[pos·k + code]`` accumulation loops in
``pq_search`` (freddy.c:117-132), ``computePQDistanceInt16``
(index_utils.c:1126-1133), and the exact post-verification re-rank
``postverify`` (index_utils.c:477-498).

Codes live packed on the device as an ``(n, m)`` uint8/int16 array (36 MB
for 3M×12 — ~50× fewer bytes than raw float vectors, which is the point of
PQ on a bandwidth-bound device). The scan is chunked over n with a running
top-k; each chunk body is a vectorized LUT gather + sum (or its compiled
Triton twin, ``ops/pallas_kernels.py``) — no per-row control flow, no host
round-trips (the reference instead streams every code row through an SPI
result set per query, freddy.c:96-104).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from postgres_word2vec.ops import backend
from postgres_word2vec.ops import topk as topk_ops

Array = jax.Array


def adc_distances_auto(luts: Array, codes: Array,
                       use_kernel: bool | None = None) -> Array:
    """Dense ADC distances ``(B, m, k) × (n, m) → (B, n)``: the Triton
    scan where :func:`backend.use_kernels` (or ``use_kernel``) says so,
    the XLA gather reference otherwise."""
    if use_kernel is None:
        use_kernel = backend.use_kernels()
    if not use_kernel:
        return adc_distances(luts, codes)
    from postgres_word2vec.ops import pallas_kernels as pk
    return pk.adc_scan(luts, codes)


def adc_distances(luts: Array, codes: Array) -> Array:
    """Dense ADC distances: ``(B, m, k) × (n, m) → (B, n)`` float32.

    ``out[b, i] = Σ_j luts[b, j, codes[i, j]]`` — the ADC sum
    (freddy.c:128: ``distance += querySimilarities[j*k + codes[j]]``).
    Works for normal LUTs with raw codes and for double LUTs with fused codes
    (shapes agree: (B, m/2, k²) × (n, m/2)).
    """
    c = codes.astype(jnp.int32)                       # (n, m)
    # vmap over subspaces: gather each (k, B) column table by that subspace's
    # code column. XLA lowers this to a small-table gather per subspace.
    luts_t = jnp.moveaxis(luts.astype(jnp.float32), 0, -1)   # (m, k, B)
    parts = jax.vmap(lambda t, cj: jnp.take(t, cj, axis=0))(luts_t, c.T)
    return jnp.sum(parts, axis=0).T                   # (m, n, B) → (B, n)


def adc_distances_per_query(luts: Array, codes: Array) -> Array:
    """ADC where every query has its own candidate rows:
    ``(B, m, k) × (B, T, m) → (B, T)`` float32.

    ``out[b, t] = Σ_j luts[b, j, codes[b, t, j]]`` — the per-query gather
    pattern of the probe paths (each query scans different rows). The XLA
    reference for ``ops/pallas_kernels.budget_adc``.
    """
    B, m, k = luts.shape
    lutflat = luts.astype(jnp.float32).reshape(B, m * k)
    idx = (codes.astype(jnp.int32)
           + (jnp.arange(m, dtype=jnp.int32) * k)[None, None, :])
    g = jax.vmap(lambda t, i: jnp.take(t, i, axis=0))(
        lutflat, idx.reshape(B, -1))
    return g.reshape(B, -1, m).sum(-1)


def budget_adc_xla(luts: Array, codes_aligned: Array, rowterm: Array,
                   tiles: Array, *, block_t: int) -> Array:
    """XLA twin of ``pallas_kernels.budget_adc``: budgeted tile-gather
    ADC → ``(B, P·block_t)`` (lut-sum + rowterm; +inf rowterm masks
    padding) over the row-major ``(NA, m)`` aligned codes."""
    B = luts.shape[0]
    lane = jnp.arange(block_t, dtype=jnp.int32)
    pos = (tiles.astype(jnp.int32)[:, :, None] * block_t
           + lane[None, None, :]).reshape(B, -1)          # (B, P·block_t)
    cand = jnp.take(codes_aligned, pos, axis=0)           # (B, PT, m)
    d = adc_distances_per_query(luts, cand)
    return d + jnp.take(rowterm, pos)


def budget_exact_xla(queries: Array, vecs_aligned: Array, rownorm: Array,
                     tiles: Array, *, block_t: int) -> Array:
    """Budgeted tile-gather exact scores → (B, P·block_t) shifted scores
    ``‖v‖² − 2·q·v`` (+inf padding) — the IVPQ join's EXACT_CALC probe
    (the reference fetches raw vectors only for rows of probed cells,
    ivpq_search_in.c:381-395). XLA's gather + batched product beat a
    hand-written Triton probe here (PERF.md)."""
    B, d = queries.shape
    lane = jnp.arange(block_t, dtype=jnp.int32)
    pos = (tiles.astype(jnp.int32)[:, :, None] * block_t
           + lane[None, None, :]).reshape(B, -1)
    cand = jnp.take(vecs_aligned, pos, axis=0).astype(jnp.float32)
    qv = jnp.einsum("bd,btd->bt", queries.astype(jnp.float32), cand,
                    preferred_element_type=jnp.float32)
    return jnp.take(rownorm, pos) - 2.0 * qv


#: most rows per chunk of the XLA gather scan: the chunk it has always
#: had, and so the yardstick the Triton scan is timed against (PERF.md)
_XLA_CHUNK = 1 << 17


@functools.partial(jax.jit, static_argnames=("k", "chunk_size", "approx",
                                             "use_kernel"))
def adc_top_k(luts: Array, codes: Array, k: int, *,
              chunk_size: int | None = None, approx: bool = False,
              use_kernel: bool = False) -> tuple[Array, Array]:
    """Exhaustive ADC top-k over all n code rows: → ``(B, k)`` (dists, ids).

    Chunks of ``chunk_size`` rows (default: sized from device memory,
    :func:`backend.scan_chunk`, and at most ``_XLA_CHUNK`` on the XLA
    path) are scored by :func:`adc_distances_auto` and merged into a
    running top-k. The last chunk is clamped to end at
    row n (rows it shares with the previous chunk are masked), so the
    code table is never padded or copied.

    Parity: ``pq_search`` (freddy.c:26-170) — full-table ADC scan with
    running top-k, batched over queries (the reference is single-query).
    """
    n, m = codes.shape
    B = luts.shape[0]
    if chunk_size:
        chunk = min(chunk_size, n)
    elif use_kernel:
        chunk = backend.scan_chunk(B, n)
    else:
        # the XLA reference materializes an (m, chunk, B) gather first
        chunk = min(backend.scan_chunk(B, n, bytes_per_row=4 * m),
                    _XLA_CHUNK)
    kk = min(k, chunk)
    lane = jnp.arange(chunk, dtype=jnp.int32)

    def body(carry, c):
        run_vals, run_idx = carry
        start = c * chunk
        s0 = jnp.minimum(start, n - chunk)
        rows = lax.dynamic_slice(codes, (s0, 0), (chunk, m))
        d = adc_distances_auto(luts, rows, use_kernel)
        d = jnp.where((lane + s0 >= start)[None, :], d, jnp.inf)
        c_vals, c_pos = topk_ops.top_k_smallest(d, kk, approx=approx)
        return topk_ops.merge_top_k_smallest(
            run_vals, run_idx, c_vals.astype(jnp.float32),
            (c_pos + s0).astype(jnp.int32), k), None

    init = (jnp.full((B, k), jnp.inf, jnp.float32),
            jnp.full((B, k), -1, jnp.int32))
    (vals, ids), _ = lax.scan(body, init, jnp.arange(-(-n // chunk)))
    return vals, jnp.where(jnp.isfinite(vals), ids, -1)


@functools.partial(jax.jit, static_argnames=("k",))
def adc_top_k_in(luts: Array, codes: Array, target_ids: Array,
                 target_mask: Array, k: int) -> tuple[Array, Array]:
    """ADC top-k restricted to a target id set → ``(B, k)`` (dists, ids).

    ``target_ids`` is a padded ``(T,)`` int32 id array with ``target_mask``
    marking real entries; returned ids are global row ids. Padding slots
    score +inf and surface as id −1 only when fewer than k real targets
    exist.

    Parity: ``pq_search_in`` (freddy.c:1026-1174) / ``pq_search_in_batch``
    (freddy.c:412-675) — the reference fetches target code rows with a SQL
    ``WHERE id IN``; here it's one device gather.
    """
    tc = jnp.take(codes, jnp.maximum(target_ids, 0), axis=0)  # (T, m)
    d = adc_distances(luts, tc)                               # (B, T)
    d = jnp.where(target_mask[None, :], d, jnp.inf)
    k_eff = min(k, target_ids.shape[0])
    vals, pos = topk_ops.top_k_smallest(d, k_eff)
    ids = jnp.where(jnp.isfinite(vals),
                    jnp.take(target_ids, pos), -1).astype(jnp.int32)
    if k_eff < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - k_eff)),
                       constant_values=jnp.inf)
        ids = jnp.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return vals, ids


@functools.partial(jax.jit, static_argnames=("k",))
def post_verify(queries: Array, cand_ids: Array, cand_dists: Array,
                vectors: Array, k: int) -> tuple[Array, Array]:
    """Exact re-rank of ADC candidates: → ``(B, k)`` (exact sqdists, ids).

    Gathers the ``(B, C)`` candidate rows' raw vectors and re-scores with
    exact squared L2 — one small batched matmul. Invalid candidates
    (id < 0 or +inf ADC distance) stay +inf.

    Parity: ``postverify`` (index_utils.c:477-498) and the SQL-side re-rank
    wrappers ``k_nearest_neighbour_pq_pv`` (freddy--0.0.1.sql:625-662).
    """
    q = queries.astype(jnp.float32)                       # (B, d)
    safe_ids = jnp.maximum(cand_ids, 0)
    cv = jnp.take(vectors, safe_ids, axis=0).astype(jnp.float32)  # (B, C, d)
    qq = jnp.sum(q * q, axis=-1)[:, None]
    cc = jnp.sum(cv * cv, axis=-1)
    qc = jnp.einsum("bd,bcd->bc", q, cv, preferred_element_type=jnp.float32,
                    precision=lax.Precision.HIGHEST)
    d = jnp.maximum(qq - 2.0 * qc + cc, 0.0)
    valid = (cand_ids >= 0) & jnp.isfinite(cand_dists)
    d = jnp.where(valid, d, jnp.inf)
    vals, pos = topk_ops.top_k_smallest(d, min(k, cand_ids.shape[-1]))
    ids = jnp.take_along_axis(cand_ids, pos, axis=-1)
    ids = jnp.where(jnp.isfinite(vals), ids, -1)
    return vals, ids

"""Exact brute-force k-NN — the ground-truth path and a tensor-core GEMM.

Parity targets: ``k_nearest_neighbour`` (freddy--0.0.1.sql:426-454 — full
table ORDER BY cosine), the 4 ``knn_in_exact`` overloads (sql:991-1084) and
``knn_search_in_batch`` (sql:456-501 — a plpgsql loop over queries).

On the GPU this is one ``(B, d) × (d, N)`` matmul (cuBLAS) with a chunked
running top-k. A 3M×300 bf16 scan is ~1.8 GB of device-memory traffic; the
reference needs 8.79 s for one exact query. Distances are squared L2
(similarity = 1 − d²/2 on normalized vectors, sql:511).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax

from postgres_word2vec.ops import backend
from postgres_word2vec.ops import topk as topk_ops
from postgres_word2vec.utils.shapes import snap_chunk as _snap_chunk

Array = jax.Array


def _sqdist_block(q: Array, v_chunk: Array, compute_dtype) -> Array:
    """Squared L2 ``(B, d) × (C, d) → (B, C)``; matmul in ``compute_dtype``
    with float32 accumulation."""
    qf = q.astype(jnp.float32)
    vf = v_chunk.astype(jnp.float32)
    qq = jnp.sum(qf * qf, axis=-1, keepdims=True)
    vv = jnp.sum(vf * vf, axis=-1)
    # HIGHEST on bf16 operands forces an f32-upcast multi-pass matmul —
    # worst of both worlds once operands were already rounded. Only pin
    # HIGHEST for true float32 compute (mirrors exact_top_k_precast).
    prec = (lax.Precision.HIGHEST if compute_dtype == jnp.float32
            else lax.Precision.DEFAULT)
    qv = jnp.dot(q.astype(compute_dtype), v_chunk.astype(compute_dtype).T,
                 preferred_element_type=jnp.float32, precision=prec)
    return jnp.maximum(qq - 2.0 * qv + vv[None, :], 0.0)


@functools.partial(jax.jit,
                   static_argnames=("k", "chunk_size", "approx", "dtype"))
def exact_top_k(queries: Array, vectors: Array, k: int, *,
                chunk_size: int | None = None, approx: bool = False,
                dtype: str = "float32") -> tuple[Array, Array]:
    """Full-scan exact top-k: → ``(B, k)`` (squared L2 dists, row ids).
    ``chunk_size`` defaults to :func:`backend.scan_chunk`."""
    compute_dtype = jnp.dtype(dtype)
    n, d = vectors.shape
    B = queries.shape[0]
    chunk_size = chunk_size or backend.scan_chunk(B, n)
    if n <= chunk_size:
        dists = _sqdist_block(queries, vectors, compute_dtype)
        return topk_ops.top_k_smallest(dists, min(k, n), approx=approx)
    chunk_size = _snap_chunk(n, chunk_size)
    pad = (-n) % chunk_size
    vp = jnp.pad(vectors, ((0, pad), (0, 0))) if pad else vectors

    def score_chunk(start):
        chunk = lax.dynamic_slice(vp, (start, 0), (chunk_size, d))
        dists = _sqdist_block(queries, chunk, compute_dtype)
        valid = (jnp.arange(chunk_size) + start) < n
        return jnp.where(valid[None, :], dists, jnp.inf)

    return topk_ops.chunked_top_k_smallest(score_chunk, n + pad, chunk_size,
                                           k, (B,), approx=approx)


@functools.partial(jax.jit, static_argnames=("k", "dtype"))
def exact_top_k_in(queries: Array, vectors: Array, target_ids: Array,
                   target_mask: Array, k: int, *,
                   dtype: str = "float32") -> tuple[Array, Array]:
    """Exact top-k restricted to a padded target-id set; ids are global.

    Parity: ``knn_in_exact`` (sql:991-1084) — the SQL ``WHERE id IN``
    becomes one device gather + masked matmul.
    """
    compute_dtype = jnp.dtype(dtype)
    tv = jnp.take(vectors, jnp.maximum(target_ids, 0), axis=0)
    d = _sqdist_block(queries, tv, compute_dtype)
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


@functools.partial(jax.jit,
                   static_argnames=("k", "chunk_size", "approx"))
def exact_top_k_precast(queries: Array, table: Array, norms: Array, k: int,
                        *, chunk_size: int | None = None,
                        approx: bool = True) -> tuple[Array, Array]:
    """Production fast path: pre-cast (e.g. bfloat16) table + precomputed
    float32 row norms — avoids re-casting N·d floats per query batch (the
    dominant memory cost at 3M×300). ``approx`` takes the binned partial
    reduction of ``topk.top_k_smallest``."""
    n, d = table.shape
    chunk_size = chunk_size or backend.scan_chunk(queries.shape[0], n)
    q = queries.astype(table.dtype)
    qf = queries.astype(jnp.float32)
    qq = jnp.sum(qf * qf, axis=-1, keepdims=True)
    # HIGHEST on a bf16 table would force an f32-upcast multi-pass matmul;
    # native-precision bf16 with f32 accumulation is the fast path.
    prec = (lax.Precision.HIGHEST if table.dtype == jnp.float32
            else lax.Precision.DEFAULT)
    if n <= chunk_size:
        qv = jnp.dot(q, table.T, preferred_element_type=jnp.float32,
                     precision=prec)
        dists = jnp.maximum(qq - 2.0 * qv + norms[None, :], 0.0)
        return topk_ops.top_k_smallest(dists, min(k, n), approx=approx)
    chunk_size = _snap_chunk(n, chunk_size)
    pad = (-n) % chunk_size
    tp = jnp.pad(table, ((0, pad), (0, 0))) if pad else table
    np_ = jnp.pad(norms, (0, pad)) if pad else norms

    def score_chunk(start):
        chunk = lax.dynamic_slice(tp, (start, 0), (chunk_size, d))
        nchunk = lax.dynamic_slice(np_, (start,), (chunk_size,))
        qv = jnp.dot(q, chunk.T, preferred_element_type=jnp.float32,
                     precision=prec)
        dists = jnp.maximum(qq - 2.0 * qv + nchunk[None, :], 0.0)
        valid = (jnp.arange(chunk_size) + start) < n
        # (bf16 distances here save ~5% wall time but cost ~4 points of
        # recall@10 on tightly-spaced neighbors — not worth it.)
        return jnp.where(valid[None, :], dists, jnp.inf)

    vals, idx = topk_ops.chunked_top_k_smallest(
        score_chunk, n + pad, chunk_size, k, (queries.shape[0],),
        approx=approx)
    return vals.astype(jnp.float32), idx


def quantize_rows_int8(vectors: Array) -> tuple[Array, Array]:
    """Symmetric per-row int8 quantization → (int8 table, float32 scales).

    300 MB instead of 1.8 GB (bf16) at 3M×300 — the capacity point between
    raw vectors and PQ codes, with near-exact recall (per-element error
    ~scale/2 ≪ typical neighbor gaps). int8×int8 products also run at 2×
    the bf16 tensor-core rate.
    """
    v = vectors.astype(jnp.float32)
    scales = jnp.max(jnp.abs(v), axis=-1) / 127.0
    safe = jnp.maximum(scales, 1e-12)
    q = jnp.clip(jnp.round(v / safe[:, None]), -127, 127).astype(jnp.int8)
    return q, scales


@functools.partial(jax.jit,
                   static_argnames=("k", "chunk_size", "approx"))
def exact_top_k_int8(queries: Array, table_i8: Array, scales: Array,
                     norms: Array, k: int, *, chunk_size: int | None = None,
                     approx: bool = True) -> tuple[Array, Array]:
    """Int8-quantized brute-force top-k → (approx squared dists, ids).

    ``q·v ≈ (q_i8·v_i8)·s_q·s_v``; the ‖v‖² term uses the exact float32
    norms, so the only error source is the cross term's quantization.
    """
    n, d = table_i8.shape
    chunk_size = chunk_size or backend.scan_chunk(queries.shape[0], n)
    qf = queries.astype(jnp.float32)
    qq = jnp.sum(qf * qf, axis=-1, keepdims=True)
    q_scale = jnp.max(jnp.abs(qf), axis=-1) / 127.0
    q_safe = jnp.maximum(q_scale, 1e-12)
    q_i8 = jnp.clip(jnp.round(qf / q_safe[:, None]), -127,
                    127).astype(jnp.int8)

    def block(tab_chunk, scale_chunk, norm_chunk):
        qv_i = jnp.dot(q_i8, tab_chunk.T,
                       preferred_element_type=jnp.int32).astype(jnp.float32)
        qv = qv_i * q_safe[:, None] * scale_chunk[None, :]
        return jnp.maximum(qq - 2.0 * qv + norm_chunk[None, :], 0.0)

    if n <= chunk_size:
        dists = block(table_i8, scales, norms)
        return topk_ops.top_k_smallest(dists, min(k, n), approx=approx)
    chunk_size = _snap_chunk(n, chunk_size)
    pad = (-n) % chunk_size
    tp = jnp.pad(table_i8, ((0, pad), (0, 0))) if pad else table_i8
    sp = jnp.pad(scales, (0, pad)) if pad else scales
    np_ = jnp.pad(norms, (0, pad)) if pad else norms

    def score_chunk(start):
        chunk = lax.dynamic_slice(tp, (start, 0), (chunk_size, d))
        sc = lax.dynamic_slice(sp, (start,), (chunk_size,))
        nc = lax.dynamic_slice(np_, (start,), (chunk_size,))
        dists = block(chunk, sc, nc)
        valid = (jnp.arange(chunk_size) + start) < n
        return jnp.where(valid[None, :], dists, jnp.inf)

    return topk_ops.chunked_top_k_smallest(
        score_chunk, n + pad, chunk_size, k, (queries.shape[0],),
        approx=approx)


@functools.partial(jax.jit, donate_argnums=(0, 1), static_argnames=())
def _write_rows(table: Array, norms: Array, rows: Array, rnorms: Array,
                start: Array) -> tuple[Array, Array]:
    """In-place (donated) row append into capacity buffers — O(batch)
    device writes, the insert path's hot op."""
    table = lax.dynamic_update_slice(table, rows, (start, 0))
    norms = lax.dynamic_update_slice(norms, rnorms, (start,))
    return table, norms


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_scales(scales: Array, rscales: Array, start: Array) -> Array:
    return lax.dynamic_update_slice(scales, rscales, (start,))


@functools.partial(jax.jit, static_argnames=("new_cap",))
def _grow_buffers(table: Array, norms: Array, new_cap: int
                  ) -> tuple[Array, Array]:
    """Amortized capacity doubling: one bandwidth copy into bigger
    buffers. Padding rows are zeros with +inf norms, so every search path
    (dense, chunked, int8, approx) excludes them for free — their distance
    is ``qq − 0 + inf``."""
    pad = new_cap - table.shape[0]
    return (jnp.pad(table, ((0, pad), (0, 0))),
            jnp.pad(norms, (0, pad), constant_values=jnp.inf))


@functools.partial(jax.jit, static_argnames=("new_cap",))
def _grow_scales(scales: Array, new_cap: int) -> Array:
    return jnp.pad(scales, (0, new_cap - scales.shape[0]))


@dataclasses.dataclass
class ExactIndex:
    """Brute-force index over a device-resident ``(N, d)`` table.

    ``compute_dtype``: "float32" for bit-faithful ground truth (tests),
    "bfloat16" for the production fast path (tensor cores with the table
    pre-cast once; float32 accumulation + float32 row norms keep ranking
    error negligible at 300-d). ``approx`` switches search() to the binned
    approximate top-k (expected recall 0.95, ``topk.approx_bins``).

    Online insertion goes through :meth:`extended` — O(batch) device work
    per call (amortized), never a whole-table re-quantize.
    """

    vectors: Array
    compute_dtype: str = "float32"
    approx: bool = False
    #: internal: pre-built device state handed over by :meth:`extended`
    #: (skips the from-scratch __post_init__ build).
    _prebuilt: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self._prebuilt is not None:
            (self._table, self._norms, self._scales,
             self._size) = self._prebuilt
            self._prebuilt = None
            return
        v = self.vectors.astype(jnp.float32)
        self._norms = jnp.sum(v * v, axis=-1)
        self._scales = None
        self._size = int(self.vectors.shape[0])
        if self.compute_dtype == "int8":
            self._table, self._scales = quantize_rows_int8(self.vectors)
        elif self.compute_dtype == "float32":
            self._table = self.vectors
        else:
            self._table = self.vectors.astype(jnp.dtype(self.compute_dtype))

    # ------------------------------------------------------------ mutation
    _GROW_QUANTUM = 4096   # capacity rounds up to this (bounds recompiles)

    def extended(self, full_vectors: Array, new_rows: Array
                 ) -> "ExactIndex":
        """O(batch) successor index after an insert (parity:
        ``insert_batch`` appends rows, freddy.c:1631-1655 /
        index_utils.c:959-1074 — the reference never rebuilds on insert).

        Quantizes/casts ONLY ``new_rows`` and writes them into capacity
        buffers with donated in-place updates; the buffers double
        (one bandwidth copy, amortized O(1) per row) when full. Padding
        rows carry +inf norms so every search path excludes them with no
        masks. ``full_vectors`` is the already-extended store table (used
        by :meth:`search_in` gathers) — aliased, not copied.

        The RECEIVER is consumed: its table/norms buffers are donated to
        the successor index (that is what makes the write in-place), so
        only the returned index may be searched afterwards.
        """
        b = int(new_rows.shape[0])
        n = self._size
        # pad the batch to the growth quantum's divisors (pow2) so the
        # write program compiles once per size class, padding rows inert
        # (+inf norms).
        bp = 1 << max(0, (b - 1)).bit_length()
        nf = new_rows.astype(jnp.float32)
        rnorms = jnp.sum(nf * nf, axis=-1)
        if self.compute_dtype == "int8":
            rows, rscales = quantize_rows_int8(new_rows)
        elif self.compute_dtype == "float32":
            rows, rscales = nf, None
        else:
            rows = new_rows.astype(jnp.dtype(self.compute_dtype))
            rscales = None
        if bp != b:
            rows = jnp.pad(rows, ((0, bp - b), (0, 0)))
            rnorms = jnp.pad(rnorms, (0, bp - b),
                             constant_values=jnp.inf)
            if rscales is not None:
                rscales = jnp.pad(rscales, (0, bp - b))
        table, norms, scales = self._table, self._norms, self._scales
        cap = int(table.shape[0])
        if n + bp > cap:
            q = self._GROW_QUANTUM
            new_cap = max(2 * cap, n + bp)
            new_cap = ((new_cap + q - 1) // q) * q
            table, norms = _grow_buffers(table, norms, new_cap=new_cap)
            if scales is not None:
                scales = _grow_scales(scales, new_cap=new_cap)
        start = jnp.int32(n)
        table, norms = _write_rows(table, norms, rows, rnorms, start)
        if scales is not None:
            scales = _write_scales(scales, rscales, start)
        return ExactIndex(full_vectors, self.compute_dtype,
                          approx=self.approx,
                          _prebuilt=(table, norms, scales, n + b))

    def search(self, queries: Array, k: int, *, approx: bool | None = None
               ) -> tuple[Array, Array]:
        use_approx = self.approx if approx is None else approx
        if self._scales is not None:
            return exact_top_k_int8(queries, self._table, self._scales,
                                    self._norms, k, approx=use_approx)
        return exact_top_k_precast(queries, self._table, self._norms, k,
                                   approx=use_approx)

    def search_in(self, queries: Array, k: int, target_ids: Array,
                  target_mask: Array | None = None) -> tuple[Array, Array]:
        if target_mask is None:
            target_mask = jnp.ones(target_ids.shape, dtype=bool)
        dtype = ("float32" if self.compute_dtype == "int8"
                 else self.compute_dtype)
        return exact_top_k_in(queries, self.vectors, target_ids, target_mask,
                              k, dtype=dtype)

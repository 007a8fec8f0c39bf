"""IVPQ — inverted multi-index PQ for batched kNN-joins.

Parity targets:
- build driver ivpq.py (multi-index coarse quantizer: product quantizer with
  2 positions × k_c=32 centroids over vector halves, cell id
  ``c0 + c1·k_c`` — ``combine_centroids``, ivpq.py:18; fine PQ codebook
  m=30, k=32 over the *raw* vectors; defaults from ivpq_config.json),
- the join kernel ``ivpq_search_in`` (ivpq_search_in.c:21-721) with its
  tuning surface: ``alpha`` (selectivity), ``pvf`` (post-verification
  factor), ``method`` ∈ {0: ADC, 1: exact, 2: ADC+PV}
  (index_utils.h:103), ``confidence``, ``use_targetlists``,
  ``long_codes_threshold`` (fused-pair LUTs),
- statistics-driven adaptive probing
  (``determineCoarseIdsMultiWithStatisticsMulti``, index_utils.c:252-443)
  with the hypergeometric-tail confidence model ``getConfidenceHyp``
  (index_utils.c:673-682),
- ``create_statistics`` (freddy--0.0.1.sql:150-171).

Device shape: the reference walks a Multi-Sequence priority queue per query and
issues one SQL fetch per round. Here each query sorts all k_c² cell
distances (one broadcast add + sort of 1024 floats), the confidence rule
picks a probe prefix via prefix sums — fully vectorized over the query batch
— and cell probing is a boolean mask over the dense target axis, so the
distance phase stays one gather kernel regardless of which cells each
query probes. Alpha escalation (``alpha += alpha`` until every query has k
results, ivpq_search_in.c:639-684) is a host-side loop over fixed-shape
rounds with per-query retirement masks.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from postgres_word2vec.models.pq import PQCodebook, online_codebook_update
from postgres_word2vec.utils.shapes import snap_chunk
from postgres_word2vec.ops import adc, backend, kmeans, lut
from postgres_word2vec.ops import topk as topk_ops

Array = jax.Array


# Distance-phase method flags (parity: index_utils.h:103).
PQ_CALC = 0
EXACT_CALC = 1
PQ_PV_CALC = 2


def confidence_hyp(expect: Array, size: Array, p: Array,
                   stat_size: Array) -> Array:
    """P[#targets in probed cells ≥ expect] — normal approximation of the
    hypergeometric tail (parity: ``getConfidenceHyp``, index_utils.c:673-682,
    including its finite-population correction factor).
    """
    expect = jnp.asarray(expect, jnp.float32)
    size = jnp.asarray(size, jnp.float32)
    p = jnp.asarray(p, jnp.float32)
    stat_size = jnp.asarray(stat_size, jnp.float32)
    mu = size * p
    fpc = (stat_size - size) / jnp.maximum(stat_size - 1.0, 1.0)
    sig = jnp.sqrt(jnp.maximum(size * p * (1.0 - p), 0.0)) * fpc
    num = expect - 0.5 - mu
    z = num / jnp.maximum(sig, 1e-30) / jnp.sqrt(2.0)
    conf = 1.0 - 0.5 * (1.0 + jax.scipy.special.erf(z))
    # Degenerate spread: the tail is a step function at mu.
    conf = jnp.where(sig <= 0.0, jnp.where(num <= 0.0, 1.0, 0.0), conf)
    return jnp.where(expect > size, 0.0, conf)


def confidence_bin(expect: Array, size: Array, p: Array) -> Array:
    """Plain binomial-tail variant without the finite-population correction
    (parity: ``getConfidenceBin``, index_utils.c:667-671)."""
    expect = jnp.asarray(expect, jnp.float32)
    size = jnp.asarray(size, jnp.float32)
    p = jnp.asarray(p, jnp.float32)
    mu = size * p
    sig = jnp.sqrt(jnp.maximum(size * p * (1.0 - p), 0.0))
    num = expect - 0.5 - mu
    z = num / jnp.maximum(sig, 1e-30) / jnp.sqrt(2.0)
    conf = 1.0 - 0.5 * (1.0 + jax.scipy.special.erf(z))
    return jnp.where(sig <= 0.0, jnp.where(num <= 0.0, 1.0, 0.0), conf)


class MultiIndexQuantizer(NamedTuple):
    """2-position product coarse quantizer → k_c² virtual cells
    (parity: ``coarse_quantization_ivpq`` + ``_counts`` tables)."""
    centroids: Array   # (positions, k_c, d/positions) float32
    cell_counts: Array  # (k_c**positions,) int32

    @property
    def num_cells(self) -> int:
        p, kc, _ = self.centroids.shape
        return int(kc) ** int(p)


def assign_cells(vectors: Array, coarse_centroids: Array, *,
                 chunk_size: int = 262144) -> Array:
    """Multi-index coarse assignment: per-position argmin → combined cell id
    ``Σ cᵢ·k_cⁱ`` (parity: ``combine_centroids`` ivpq.py:18 and the C-side
    multi assignment, freddy.c:1590-1609). Chunked over rows so no
    transposed full-table copy is materialized."""
    p, kc, dsub = coarse_centroids.shape
    n, d = vectors.shape
    cb = coarse_centroids.astype(jnp.float32)
    cc = jnp.sum(cb * cb, axis=-1)                 # (p, kc)
    weights = kc ** jnp.arange(p, dtype=jnp.int32)

    def chunk_fn(xc: Array) -> Array:
        # per-position dots (p ≤ 2 small products per chunk).
        xf = xc.astype(jnp.float32)
        cell = jnp.zeros((xc.shape[0],), jnp.int32)
        for i in range(p):
            s = jnp.dot(xf[:, i * dsub:(i + 1) * dsub], cb[i].T,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
            code = jnp.argmin(cc[i][None] - 2.0 * s, axis=-1)
            cell = cell + code.astype(jnp.int32) * weights[i]
        return cell

    if n <= chunk_size:
        return chunk_fn(vectors)
    # fori + dynamic_slice (see ops/kmeans.py encoders: a padded/reshaped
    # lax.map view can double the table in HBM at capacity scale).
    chunk_size = snap_chunk(n, chunk_size)
    pad = (-n) % chunk_size
    xp = jnp.pad(vectors, ((0, pad), (0, 0))) if pad else vectors
    out = jnp.zeros((n + pad,), jnp.int32)

    def body(i, acc):
        start = i * chunk_size
        xc = jax.lax.dynamic_slice(xp, (start, 0), (chunk_size, d))
        return jax.lax.dynamic_update_slice(acc, chunk_fn(xc), (start,))

    out = jax.lax.fori_loop(0, (n + pad) // chunk_size, body, out)
    return out[:n]


def cell_distances(queries: Array, coarse_centroids: Array) -> Array:
    """All-cell squared distances ``(B, d) → (B, k_c**positions)``, with the
    flat index matching :func:`assign_cells`'s combination order.

    Replaces the reference's Multi-Sequence pqueue walk (index_utils.c:322-395,
    "ONLY IMPLEMENTED FOR cbPositions == 2") — at k_c=32 the full 1024-cell
    table is two tiny matmuls and one broadcast add, and generalizes to any
    position count the same way.
    """
    p, kc, dsub = coarse_centroids.shape
    subd = lut.build_luts(queries, coarse_centroids)   # (B, p, kc)
    total = subd[:, 0, :]                              # (B, kc): position 0
    for i in range(1, p):
        # new flat index = old + c_i · kc^i  ⇒  append axis on the left.
        total = (subd[:, i, :, None] + total[:, None, :]).reshape(
            total.shape[0], kc ** (i + 1))
    return total


def build_statistics(cell_assignments: Array, domain_ids: Array,
                     num_cells: int) -> Array:
    """Per-cell relative frequency of a word domain + absolute total.

    Returns ``(num_cells + 1,)``: entries 0..C−1 are the fraction of the
    domain assigned to each cell, entry C is the absolute domain size — the
    exact layout the C kernel reads (``statistics[cqSize]`` as total,
    index_utils.c:632-665; built by SQL ``create_statistics``,
    freddy--0.0.1.sql:150-171).
    """
    cells = jnp.take(cell_assignments, domain_ids)
    counts = jnp.bincount(cells, length=num_cells).astype(jnp.float32)
    total = jnp.maximum(jnp.sum(counts), 1.0)
    return jnp.concatenate([counts / total, total[None]])


def uniform_statistics(cell_counts: Array) -> Array:
    """Fallback statistics from the full-table cell occupancy (used when no
    domain statistics table was created — the reference then probes with the
    global distribution)."""
    c = cell_counts.astype(jnp.float32)
    total = jnp.maximum(jnp.sum(c), 1.0)
    return jnp.concatenate([c / total, total[None]])


def _select_cells(queries: Array, coarse_centroids: Array,
                  statistics: Array, cell_counts: Array, t_real: Array,
                  k: int, alpha: int, confidence: Array
                  ) -> tuple[Array, Array, Array, Array, Array]:
    """Statistics-driven adaptive cell selection, vectorized over queries
    (replaces the Multi-Sequence pqueue walk + confidence accumulation,
    index_utils.c:252-443).

    Returns (order (B, C) cells by distance, n_sel (B,) probe prefix
    length, exhausted (B,), predicted (B,) statistics-model target count,
    retrieved_sel (B,) TRUE target rows in the selected cells).
    """
    num_cells = statistics.shape[0] - 1
    cd = cell_distances(queries, coarse_centroids)          # (B, C)
    order = jnp.argsort(cd, axis=-1)                        # (B, C)
    probs = statistics[:num_cells]
    stat_total = statistics[num_cells]
    p_sorted = jnp.take(probs, order)                       # (B, C)
    cum_p = jnp.cumsum(p_sorted, axis=-1)
    conf = confidence_hyp(float(k * alpha), t_real, cum_p, stat_total)
    satisfied = conf >= confidence
    any_sat = jnp.any(satisfied, axis=-1)
    first = jnp.argmax(satisfied, axis=-1) + 1              # κ = index + 1
    n_sel = jnp.where(any_sat, first, num_cells)            # (B,)
    # Coverage floor: the reference re-runs with doubled alpha until every
    # query has k results (ivpq_search_in.c:639-684) because it only has
    # *estimated* per-cell frequencies. We know the actual per-cell target
    # counts, so extend each query's prefix until it provably covers ≥ k
    # real targets — same semantics, one round instead of an escalation
    # ladder in the common case.
    counts_sorted = jnp.take(cell_counts, order)            # (B, C)
    cum_counts = jnp.cumsum(counts_sorted, axis=-1)
    need = jnp.minimum(float(k), t_real.astype(jnp.float32))
    covered = cum_counts >= need
    k_first = jnp.argmax(covered, axis=-1) + 1
    n_sel_k = jnp.where(jnp.any(covered, axis=-1), k_first, num_cells)
    n_sel = jnp.maximum(n_sel, n_sel_k)
    exhausted = n_sel >= num_cells
    # statistics-model prediction of how many targets the probed cells hold
    # (the reference's "TRACK target_count" metric, index_utils.c:412-414).
    predicted = jnp.take_along_axis(
        cum_p, (n_sel - 1)[:, None], axis=-1)[:, 0] * t_real.astype(
            jnp.float32)
    retrieved_sel = jnp.take_along_axis(
        cum_counts, (n_sel - 1)[:, None], axis=-1)[:, 0]
    return order, n_sel, exhausted, predicted, retrieved_sel


@functools.partial(
    jax.jit,
    static_argnames=("k", "alpha", "pvf", "method", "use_double",
                     "use_kernel"))
def _ivpq_round(queries: Array, coarse_centroids: Array, codebook_cent: Array,
                target_codes: Array, target_cells: Array, target_ids: Array,
                target_mask: Array, statistics: Array, raw_target_vectors,
                k: int, alpha: int, pvf: int, method: int,
                confidence: Array, use_double: bool,
                use_kernel: bool = False,
                t_real_override: Array | None = None,
                cell_counts_override: Array | None = None
                ) -> tuple[Array, Array, Array, Array, Array]:
    """One fixed-shape probe round at a given alpha.

    Returns (sqdists (B,k), global ids (B,k), retrieved (B,), exhausted
    (B,), predicted (B,)) where ``retrieved`` counts real candidates seen
    (the reference's retirement signal), ``exhausted`` marks queries that
    probed every cell (the reference's ``lastIteration``), and ``predicted``
    is the statistics model's expected target count (``TRACK
    target_count``).
    """
    B = queries.shape[0]
    num_cells = statistics.shape[0] - 1
    # Under target-axis sharding each shard sees a partial mask; the cell
    # selection must use the GLOBAL target count to replicate across shards.
    t_real = (jnp.sum(target_mask.astype(jnp.int32))
              if t_real_override is None else t_real_override)

    # --- adaptive cell selection (index_utils.c:252-443, vectorized) ------
    cell_counts = (jax.ops.segment_sum(
        target_mask.astype(jnp.float32), target_cells.astype(jnp.int32),
        num_segments=num_cells)
        if cell_counts_override is None else cell_counts_override)  # (C,)
    order, n_sel, exhausted, predicted, _ = _select_cells(
        queries, coarse_centroids, statistics, cell_counts, t_real, k,
        alpha, confidence)

    # rank of each cell in each query's distance order → selection mask.
    ranks = jnp.argsort(order, axis=-1)                     # inverse perm
    sel_cell = ranks < n_sel[:, None]                       # (B, C)

    # --- candidate mask over the dense target axis ------------------------
    T = target_cells.shape[0]
    probe = jnp.take_along_axis(
        sel_cell, jnp.broadcast_to(target_cells[None, :], (B, T)), axis=-1)
    cand = probe & target_mask[None, :]                     # (B, T)
    retrieved = jnp.sum(cand.astype(jnp.int32), axis=-1)

    # --- distance phase (ivpq_search_in.c:459-543) ------------------------
    if method == EXACT_CALC:
        qf = queries.astype(jnp.float32)
        tv = raw_target_vectors.astype(jnp.float32)
        qq = jnp.sum(qf * qf, axis=-1, keepdims=True)
        tt = jnp.sum(tv * tv, axis=-1)
        qt = jnp.dot(qf, tv.T, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
        dists = jnp.maximum(qq - 2.0 * qt + tt[None, :], 0.0)
    else:
        luts = lut.build_luts(queries, codebook_cent)
        if use_double:
            # "short codes": fused-pair LUTs (ivpq_search_in.c:262-291).
            kcb = codebook_cent.shape[1]
            dl = lut.build_double_luts(luts)
            fc = lut.fuse_codes(target_codes, kcb)
            dists = adc.adc_distances_auto(dl, fc, use_kernel)
        else:
            dists = adc.adc_distances_auto(luts, target_codes, use_kernel)

    dists = jnp.where(cand, dists, jnp.inf)

    if method == PQ_PV_CALC:
        kk = min(k * pvf, dists.shape[1])
        cvals, cpos = topk_ops.top_k_smallest(dists, kk)
        cids = jnp.where(jnp.isfinite(cvals),
                         jnp.take(target_ids, cpos), -1).astype(jnp.int32)
        # callers pass target-LOCAL ids for method 2 (see _run_round), so
        # post_verify gathers within the (T, d) target block.
        vals, ids = adc.post_verify(queries, cids, cvals,
                                    raw_target_vectors, k)
        return vals, ids, retrieved, exhausted, predicted

    k_eff = min(k, dists.shape[1])
    vals, pos = topk_ops.top_k_smallest(dists, k_eff)
    ids = jnp.where(jnp.isfinite(vals),
                    jnp.take(target_ids, pos), -1).astype(jnp.int32)
    if k_eff < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - k_eff)),
                       constant_values=jnp.inf)
        ids = jnp.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return vals, ids, retrieved, exhausted, predicted


class JoinTiles(NamedTuple):
    """Per-call cell-aligned tiling of a kNN-join's TARGET set.

    Built once per ``search_join`` call (one device sort + scatter over the
    T targets); every probe round then DMAs only the tiles of each query's
    selected cells, so distance-phase cost scales with alpha/confidence —
    the fetched-rows-only semantics of ``ivpq_search_in``'s SPI query
    (ivpq_search_in.c:355-401, 459-543), which the round-1 dense layout
    lost (it ADC'd all T targets and masked).
    """
    block_t: int
    codes: Array        # (NA, m) aligned codes (storage dtype)
    rowterm: Array      # (NA,) f32: 0 on real rows, +inf padding
    local_ids: Array    # (NA,) int32 target-local row ids, -1 padding
    tile_start: Array   # (C,) int32
    tile_cnt: Array     # (C,) int32
    tile_rows: Array    # (NT,) int32 real rows per tile
    cell_sizes: Array   # (C,) f32 target rows per cell
    t_real: Array       # () int32 number of real targets
    vecs: Array         # (NA, d) bf16 aligned raw vectors (zeros if unused)
    rownorm: Array      # (NA,) f32 ‖v‖² (+inf padding; zeros-d if unused)
    inf_tile: int


@functools.partial(jax.jit,
                   static_argnames=("block_t", "num_cells", "with_vecs"))
def build_join_tiles(target_codes: Array, target_cells: Array,
                     target_mask: Array, target_vecs: Array, *,
                     block_t: int, num_cells: int,
                     with_vecs: bool) -> JoinTiles:
    """Sort targets by coarse cell and lay them out cell-aligned in whole
    ``block_t`` tiles (one trailing inf tile). NA is static:
    ``roundup(T) + (C+1)·block_t`` upper-bounds the per-cell padding."""
    T, m = target_codes.shape
    bt = block_t
    na = ((T + bt - 1) // bt) * bt + (num_cells + 1) * bt
    nt = na // bt
    inf_tile = nt - 1

    cells_s = jnp.where(target_mask, target_cells.astype(jnp.int32),
                        num_cells)
    order = jnp.argsort(cells_s, stable=True)
    sorted_cells = jnp.take(cells_s, order)
    counts = jnp.bincount(cells_s, length=num_cells + 1)
    sizes = counts[:num_cells]
    tile_cnt = (sizes + bt - 1) // bt
    tile_start = jnp.concatenate(
        [jnp.zeros((1,), tile_cnt.dtype), jnp.cumsum(tile_cnt)[:-1]])
    offsets = jnp.concatenate(
        [jnp.zeros((1,), sizes.dtype), jnp.cumsum(counts)[:-1]])  # (C+1,)
    rank = jnp.arange(T, dtype=jnp.int32) - jnp.take(offsets, sorted_cells)
    valid_s = sorted_cells < num_cells
    apos = jnp.where(
        valid_s,
        jnp.take(tile_start,
                 jnp.minimum(sorted_cells, num_cells - 1)) * bt + rank,
        na - 1)

    codes_sorted = jnp.take(target_codes, order, axis=0)
    # keep the storage dtype (uint8/int16): the kernels read codes narrow.
    codes_al = jnp.zeros((na, m), target_codes.dtype).at[apos].set(
        codes_sorted)
    rowterm = jnp.full((na,), jnp.inf, jnp.float32).at[apos].set(
        jnp.where(valid_s, 0.0, jnp.inf))
    lids = jnp.full((na,), -1, jnp.int32).at[apos].set(
        jnp.where(valid_s, order.astype(jnp.int32), -1))
    tile_rows = jnp.zeros((nt,), jnp.int32).at[
        jnp.where(valid_s, apos // bt, nt - 1)].add(
            valid_s.astype(jnp.int32))

    if with_vecs:
        d = target_vecs.shape[1]
        vf = jnp.take(target_vecs, order, axis=0).astype(jnp.float32)
        vecs_al = jnp.zeros((na, d), jnp.bfloat16).at[apos].set(
            vf.astype(jnp.bfloat16))
        rownorm = jnp.full((na,), jnp.inf, jnp.float32).at[apos].set(
            jnp.where(valid_s, jnp.sum(vf * vf, axis=-1), jnp.inf))
    else:
        vecs_al = jnp.zeros((na, 1), jnp.bfloat16)
        rownorm = jnp.full((na,), jnp.inf, jnp.float32)

    return JoinTiles(
        block_t=bt, codes=codes_al, rowterm=rowterm, local_ids=lids,
        tile_start=tile_start.astype(jnp.int32),
        tile_cnt=tile_cnt.astype(jnp.int32), tile_rows=tile_rows,
        cell_sizes=sizes.astype(jnp.float32),
        t_real=jnp.sum(target_mask.astype(jnp.int32)),
        vecs=vecs_al, rownorm=rownorm, inf_tile=inf_tile)


@functools.partial(
    jax.jit,
    static_argnames=("k", "alpha", "pvf", "method", "use_double",
                     "p_budget", "block_t", "use_kernel"))
def _ivpq_round_budget(queries: Array, coarse_centroids: Array,
                       codebook_cent: Array, jt: JoinTiles,
                       target_vecs: Array, statistics: Array, k: int,
                       alpha: int, pvf: int, method: int, confidence: Array,
                       use_double: bool, p_budget: int, block_t: int,
                       use_kernel: bool,
                       t_real_override: Array | None = None,
                       cell_counts_override: Array | None = None
                       ) -> tuple[Array, Array, Array, Array, Array]:
    """One selectivity-proportional probe round: scans only the tiles of
    each query's selected cells (budget ``p_budget`` tiles/query).

    Same return contract as ``_ivpq_round`` but ids are TARGET-LOCAL;
    ``retrieved`` counts rows actually scanned so truncated queries are
    never wrongly retired. The overrides replicate cell selection across
    target shards (each shard's tiles cover a partial target set, but the
    probe-prefix decision must use GLOBAL counts — see
    ``parallel.sharding.sharded_ivpq_join_round_budget``).
    """
    from postgres_word2vec.models.ivfadc import plan_probe_tiles

    B = queries.shape[0]
    num_cells = statistics.shape[0] - 1
    sel_counts = (jt.cell_sizes if cell_counts_override is None
                  else cell_counts_override)
    sel_t_real = jt.t_real if t_real_override is None else t_real_override
    order, n_sel, exhausted, predicted, retrieved_sel = _select_cells(
        queries, coarse_centroids, statistics, sel_counts, sel_t_real,
        k, alpha, confidence)

    rank_lt = (jnp.arange(num_cells, dtype=jnp.int32)[None, :]
               < n_sel[:, None])
    cnt = jnp.where(rank_lt, jnp.take(jt.tile_cnt, order), 0)   # (B, C)
    start = jnp.take(jt.tile_start, order)
    tiles, _ = plan_probe_tiles(p_budget, start, cnt, jt.inf_tile)

    if method == EXACT_CALC:
        qf = queries.astype(jnp.float32)
        qq = jnp.sum(qf * qf, axis=-1, keepdims=True)
        d = adc.budget_exact_xla(queries, jt.vecs, jt.rownorm, tiles,
                                 block_t=block_t)
        dists = jnp.maximum(d + qq, 0.0)
    else:
        luts = lut.build_luts(queries, codebook_cent)
        codes = jt.codes
        if use_double:
            # fused-pair layout directly on the aligned codes.
            kcb = codebook_cent.shape[1]
            luts = lut.build_double_luts(luts)
            # widen before fusing: pair codes reach kcb²−1, which overflows
            # the narrow (uint8) storage dtype.
            codes = (codes[:, 0::2].astype(jnp.int32) * kcb
                     + codes[:, 1::2])
        if use_kernel:
            from postgres_word2vec.ops import pallas_kernels as pk
            dists = pk.budget_adc(luts, codes, jt.rowterm, tiles,
                                  block_t=block_t)
        else:
            dists = adc.budget_adc_xla(luts, codes, jt.rowterm, tiles,
                                       block_t=block_t)

    found = jnp.sum(jnp.take(jt.tile_rows, tiles), axis=1)
    exhausted = exhausted & (found.astype(jnp.float32) >= retrieved_sel)

    lane = jnp.arange(block_t, dtype=jnp.int32)
    gpos_all = (tiles[:, :, None] * block_t
                + lane[None, None, :]).reshape(B, -1)

    if method == PQ_PV_CALC:
        kk = min(k * pvf, dists.shape[1])
        cvals, cpos = topk_ops.top_k_smallest(dists, kk)
        csel = jnp.take_along_axis(gpos_all, cpos, axis=-1)
        cids = jnp.where(jnp.isfinite(cvals),
                         jnp.take(jt.local_ids, csel), -1).astype(jnp.int32)
        vals, ids = adc.post_verify(queries, cids, cvals, target_vecs, k)
        return vals, ids, found, exhausted, predicted

    k_eff = min(k, dists.shape[1])
    vals, pos = topk_ops.top_k_smallest(dists, k_eff)
    sel = jnp.take_along_axis(gpos_all, pos, axis=-1)
    ids = jnp.where(jnp.isfinite(vals),
                    jnp.take(jt.local_ids, sel), -1).astype(jnp.int32)
    if k_eff < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - k_eff)),
                       constant_values=jnp.inf)
        ids = jnp.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return vals, ids, found, exhausted, predicted


#: queries per device-side block inside one budget-round program. Large
#: query batches run as a lax.map over ≤this many queries INSIDE the
#: compiled program (zero extra host dispatches), which bounds the
#: ``(block, P·block_t)`` score intermediates.
_BUDGET_SCAN_BLOCK = 512


@functools.partial(
    jax.jit,
    static_argnames=("k", "alpha", "pvf", "method", "use_double",
                     "p_budget", "block_t", "use_kernel"))
def _budget_round_program(queries: Array, coarse_centroids: Array,
                          codebook_cent: Array, jt: JoinTiles,
                          target_vecs: Array, target_ids: Array,
                          statistics: Array, k: int, alpha: int, pvf: int,
                          method: int, confidence: Array, use_double: bool,
                          p_budget: int, block_t: int, use_kernel: bool):
    """One COMPLETE budget probe round — distance phase + local→global id
    map + retirement status — as ONE compiled program, one dispatch.
    Batches beyond :data:`_BUDGET_SCAN_BLOCK` stream through a device-side
    ``lax.map`` over query blocks."""
    B = queries.shape[0]

    def one(qb):
        vals, lids, retrieved, exhausted, predicted = _ivpq_round_budget(
            qb, coarse_centroids, codebook_cent, jt, target_vecs,
            statistics, k, alpha, pvf, method, confidence, use_double,
            p_budget=p_budget, block_t=block_t, use_kernel=use_kernel)
        ids = jnp.where(lids >= 0,
                        jnp.take(target_ids, jnp.maximum(lids, 0)),
                        -1).astype(jnp.int32)
        return vals, ids, retrieved, exhausted, predicted

    sb = _BUDGET_SCAN_BLOCK
    if B > sb:
        pad = (-B) % sb
        qp = jnp.pad(queries, ((0, pad), (0, 0))) if pad else queries
        qs = qp.reshape((B + pad) // sb, sb, queries.shape[1])
        outs = jax.lax.map(one, qs)
        vals, ids, retrieved, exhausted, predicted = (
            o.reshape(B + pad, *o.shape[2:])[:B] for o in outs)
    else:
        vals, ids, retrieved, exhausted, predicted = one(queries)
    resolved = retrieved >= k
    return (vals, ids, retrieved, exhausted, predicted, resolved,
            jnp.all(resolved | exhausted))


@functools.partial(
    jax.jit,
    static_argnames=("k", "alpha", "pvf", "method", "use_double",
                     "use_kernel"))
def _dense_round_program(queries: Array, coarse_centroids: Array,
                         codebook_cent: Array, target_codes: Array,
                         target_cells: Array, target_ids: Array,
                         target_mask: Array, statistics: Array,
                         raw_target_vectors, k: int, alpha: int, pvf: int,
                         method: int, confidence: Array, use_double: bool,
                         use_kernel: bool):
    """Dense-path twin of :func:`_budget_round_program`: full-T masked ADC
    round + id mapping + retirement status in one compiled program."""
    if method == PQ_PV_CALC:
        # run with local ids 0..T-1 so post_verify gathers the (T, d)
        # target block, then map back to global ids — inside the program.
        local_ids = jnp.arange(target_ids.shape[0], dtype=jnp.int32)
        vals, lids, retrieved, exhausted, predicted = _ivpq_round(
            queries, coarse_centroids, codebook_cent, target_codes,
            target_cells, local_ids, target_mask, statistics,
            raw_target_vectors, k, alpha, pvf, method, confidence,
            use_double, use_kernel)
        ids = jnp.where(lids >= 0,
                        jnp.take(target_ids, jnp.maximum(lids, 0)),
                        -1).astype(jnp.int32)
    else:
        vals, ids, retrieved, exhausted, predicted = _ivpq_round(
            queries, coarse_centroids, codebook_cent, target_codes,
            target_cells, target_ids, target_mask, statistics,
            raw_target_vectors, k, alpha, pvf, method, confidence,
            use_double, use_kernel)
    resolved = retrieved >= k
    return (vals, ids, retrieved, exhausted, predicted, resolved,
            jnp.all(resolved | exhausted))


@jax.jit
def _stack_done(dones: list) -> Array:
    """Fold many chunks' done scalars into one — a single device read
    instead of one blocking bool() round trip per chunk."""
    return jnp.all(jnp.stack(dones))


@functools.partial(jax.jit, static_argnames=("with_vecs",))
def _gather_targets(codes: Array, cell_of: Array, vectors, target_ids: Array,
                    with_vecs: bool):
    """Gather a join call's target codes/cells(/raw rows) in ONE compiled
    program: three eager ``jnp.take``s would be three dispatches on every
    ``search_join`` call, even when the tile layout is cached."""
    t_ids = jnp.maximum(target_ids, 0)
    tc = jnp.take(codes, t_ids, axis=0)
    cells = jnp.take(cell_of, t_ids)
    tv = (jnp.take(vectors, t_ids, axis=0).astype(jnp.float32)
          if with_vecs else None)
    return tc, cells, tv


@dataclasses.dataclass
class PreparedJoin:
    """Reusable TARGET-SET handle for repeated kNN-joins.

    The reference's serving pattern is many join calls against the same
    restricted domain (the statistics-table use case,
    freddy--0.0.1.sql:150-171); its per-call cost is one SPI fetch of the
    probed cells. Round 4's ``search_join`` re-paid per call: three eager
    target gathers, a content hash over T ids, and (on cache miss) the
    tile sort+scatter. ``IVPQIndex.prepare_join`` hoists ALL of it into
    this handle; a prepared ``search_join`` then issues exactly one fused
    device program per query chunk.

    ``tiles(with_vecs)`` lazily builds/caches the cell-aligned tiling per
    layout (with_vecs=True only for method 1 exact distances).
    """

    target_ids: Array           # (T,) int32
    target_mask: Array          # (T,) bool
    target_codes: Array         # (T, m) storage dtype
    target_cells: Array         # (T,) int32
    target_vecs: Array | None   # (T, d) f32 raw rows (methods 1/2) or None
    num_cells: int
    block_t: int
    build_s: float              # data-retrieval time paid at prepare time
    _tiles: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return int(self.target_ids.shape[0])

    def tiles(self, with_vecs: bool) -> JoinTiles:
        jt = self._tiles.get(bool(with_vecs))
        if jt is None:
            if with_vecs and self.target_vecs is None:
                raise ValueError(
                    "prepare_join was called without vectors — method=1 "
                    "(exact distances) needs raw target rows")
            tv = (self.target_vecs if self.target_vecs is not None else
                  jnp.zeros((self.size, 1), jnp.float32))
            jt = build_join_tiles(self.target_codes, self.target_cells,
                                  self.target_mask, tv,
                                  block_t=self.block_t,
                                  num_cells=self.num_cells,
                                  with_vecs=bool(with_vecs))
            jt = jt._replace(
                block_t=self.block_t,
                inf_tile=int(jt.codes.shape[0]) // self.block_t - 1)
            self._tiles[bool(with_vecs)] = jt
        return jt


@functools.partial(jax.jit, static_argnames=("k",))
def _merge_round(best_vals, best_ids, best_retrieved, best_predicted,
                 vals, ids, retrieved, predicted, resolved, exhausted,
                 k: int):
    """Fold an escalation round into the running best (queries already
    resolved keep their earlier results — ivpq_search_in.c:639-684
    retirement semantics), returning the updated resolved mask and the
    loop-termination scalar in the same dispatch."""
    upd = ~resolved
    bv = jnp.where(upd[:, None], vals, best_vals)
    bi = jnp.where(upd[:, None], ids, best_ids)
    br = jnp.where(upd, retrieved, best_retrieved)
    bp = jnp.where(upd, predicted, best_predicted)
    new_resolved = resolved | (retrieved >= k)
    return bv, bi, br, bp, new_resolved, jnp.all(new_resolved | exhausted)


@dataclasses.dataclass
class IVPQIndex:
    """Multi-index PQ join index, all HBM-resident."""

    coarse: MultiIndexQuantizer
    codebook: PQCodebook        # (m, k, dsub) over raw vectors
    codes: Array                # (n, m) uint8 — original row order
    cell_of: Array              # (n,) int32 coarse cell per row

    #: JoinTiles memo keyed on (target-set fingerprint, block_t, with_vecs,
    #: vectors identity) — serving workloads hit the same target set
    #: repeatedly (the reference's statistics-table use case) and must not
    #: re-pay the per-call sort + scatter. ``add()`` returns a NEW index, so
    #: the cache invalidates naturally on insert.
    _join_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)
    _JOIN_CACHE_CAP = 4

    @property
    def size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def num_cells(self) -> int:
        return self.coarse.num_cells

    # ------------------------------------------------------------ building
    @classmethod
    def build(cls, key: Array, vectors: Array, *, m: int = 30, k: int = 32,
              k_coarse: int = 32, coarse_positions: int = 2,
              train_size: int | None = 100_000, iters: int = 10,
              restarts: int = 1, init: str = "sample") -> "IVPQIndex":
        """Multi-index coarse + raw-vector PQ codebook + codes
        (``create_index_data`` parity, ivpq.py; config ivpq_config.json:
        m=30, k=32, k_coarse=32)."""
        n = vectors.shape[0]
        ck, fk, sk = jax.random.split(key, 3)
        if train_size is not None and train_size < n:
            idx = jax.random.choice(sk, n, shape=(train_size,),
                                    replace=False)
            train = jnp.take(vectors, idx, axis=0)
        else:
            train = vectors
        csub = kmeans.split_subspaces(train, coarse_positions)
        cres = kmeans.kmeans_subspaces(ck, csub, k=k_coarse, iters=iters,
                                       restarts=restarts, init=init)
        cell_of = assign_cells(vectors, cres.centroids)
        cell_counts = jnp.bincount(
            cell_of, length=k_coarse ** coarse_positions).astype(jnp.int32)

        fsub = kmeans.split_subspaces(train, m)
        fres = kmeans.kmeans_subspaces(fk, fsub, k=k, iters=iters,
                                       restarts=restarts, init=init)
        codes = kmeans.encode_subspaces(vectors, fres.centroids)
        return cls(MultiIndexQuantizer(cres.centroids, cell_counts),
                   PQCodebook(fres.centroids, fres.counts), codes, cell_of)

    # ------------------------------------------------------------- search
    def prepare_join(self, target_ids: Array, *,
                     target_mask: Array | None = None,
                     vectors: Array | None = None,
                     block_t: int | None = None,
                     with_tiles: bool = True,
                     vecs_pregathered: bool = False) -> PreparedJoin:
        """Build a reusable :class:`PreparedJoin` handle for a target set.

        Pays the join's entire per-target-set cost ONCE — the code/cell
        (/raw-row) gathers and the cell-aligned tile layout (the SPI-fetch
        analog, ivpq_search_in.c:355-405) — so every subsequent
        ``search_join(..., prepared=handle)`` issues exactly one fused
        device program per query chunk. Pass ``vectors`` (the store table)
        if you will run methods 1/2 (exact / ADC+post-verify).

        ``vecs_pregathered=True`` declares that ``vectors`` is ALREADY the
        (T, d) target-row matrix aligned with ``target_ids`` (e.g. the
        whole store when the target set is every row in order) — the
        handle aliases it instead of materializing a gathered copy, which
        at capacity scale (3M×300 f32 = 3.6 GB) would double the table's
        HBM footprint.
        """
        target_ids = jnp.asarray(target_ids, jnp.int32)
        if target_mask is None:
            target_mask = jnp.ones(target_ids.shape, dtype=bool)
        t = int(target_ids.shape[0])
        bt = block_t if block_t is not None else (256 if t >= 50_000
                                                  else 128)
        t0 = time.perf_counter()
        if vecs_pregathered:
            if vectors is None or int(vectors.shape[0]) != t:
                raise ValueError(
                    "vecs_pregathered=True needs vectors with one row per "
                    "target id")
            tc, cells, _ = _gather_targets(self.codes, self.cell_of,
                                           self.cell_of, target_ids,
                                           with_vecs=False)
            tv = vectors
        else:
            tc, cells, tv = _gather_targets(self.codes, self.cell_of,
                                            self.cell_of if vectors is None
                                            else vectors,
                                            target_ids,
                                            with_vecs=vectors is not None)
        ph = PreparedJoin(target_ids=target_ids, target_mask=target_mask,
                          target_codes=tc, target_cells=cells,
                          target_vecs=tv, num_cells=self.num_cells,
                          block_t=bt, build_s=0.0)
        if with_tiles:
            # default layout (methods 0/2); method-1 tiles build lazily.
            jt = ph.tiles(with_vecs=False)
            np.asarray(jt.t_real)  # materialize (CLAUDE.md timing rule)
        ph.build_s = time.perf_counter() - t0
        return ph

    def search_join(self, queries: Array, k: int,
                    target_ids: Array | None = None, *,
                    prepared: PreparedJoin | None = None,
                    target_mask: Array | None = None,
                    vectors: Array | None = None,
                    statistics: Array | None = None,
                    alpha: int = 3, pvf: int = 20, method: int = PQ_CALC,
                    confidence: float = 0.8,
                    long_codes_threshold: float = 1e7,
                    use_targetlists: bool = True,
                    max_rounds: int = 8,
                    query_chunk: int | None = None,
                    impl: str | None = None,
                    budget_tiles: int | None = None,
                    return_info: bool = False):
        """Batched kNN-join (``ivpq_search_in`` parity) → (sqdists, ids).

        ``prepared``: a :meth:`prepare_join` handle — the repeated-target-
        set fast path (one fused device program per query chunk; no
        per-call gathers, hashing, or tile builds). When given,
        ``target_ids``/``target_mask``/``vectors`` are taken from the
        handle.

        ``impl``: "budget" (selectivity-proportional tiled probe — cost
        scales with alpha/confidence; default on the GPU), "dense" (full-T ADC
        + mask — the XLA reference path, default on CPU), or None for
        auto. ``use_targetlists`` maps to the budget layout: the per-call
        cell-sorted tiling IS the reference's per-query target-list
        buffering (ivpq_search_in.c:462-479) reorganized target-major;
        ``use_targetlists=False`` forces the dense path.

        ``query_chunk``: queries per compiled host chunk; None
        auto-selects (8192 on the budget path — the round program streams
        ≥512-query blocks through a device-side lax.map, so one dispatch
        covers the whole batch and intermediates stay
        block×budget-rows — and 1024 on the dense path, whose
        intermediates are B×T).

        ``return_info`` adds the resolved ``impl`` to the per-query info.
        """
        if prepared is not None:
            target_ids = prepared.target_ids
            target_mask = prepared.target_mask
        elif target_ids is None:
            raise ValueError("search_join needs target_ids or prepared=")
        if target_mask is None:
            target_mask = jnp.ones(target_ids.shape, dtype=bool)
        if statistics is None:
            statistics = uniform_statistics(self.coarse.cell_counts)
        have_vecs = (vectors is not None or
                     (prepared is not None and
                      prepared.target_vecs is not None))
        if method in (EXACT_CALC, PQ_PV_CALC) and not have_vecs:
            raise ValueError("methods 1/2 need raw vectors for exact "
                             "distances")
        impl = self.join_impl(impl, use_targetlists)
        if query_chunk is None:
            query_chunk = 8192 if impl == "budget" else 1024

        if prepared is not None:
            target_codes = prepared.target_codes
            target_cells = prepared.target_cells
            target_vecs = prepared.target_vecs
        else:
            target_codes, target_cells, target_vecs = _gather_targets(
                self.codes, self.cell_of,
                self.cell_of if vectors is None else vectors,
                target_ids, with_vecs=vectors is not None)
        if target_vecs is None:
            # methods that never touch raw rows (0) still pass the arg;
            # a host-side placeholder adds no device program.
            target_vecs = np.zeros((1, 1), np.float32)

        jt = None
        data_retrieval_s = 0.0
        if impl == "budget" and prepared is not None:
            jt = prepared.tiles(with_vecs=method == EXACT_CALC)
        elif impl == "budget":
            t = target_ids.shape[0]
            block_t = 256 if t >= 50_000 else 128
            with_vecs = method == EXACT_CALC
            ck = self._join_tiles_key(target_ids, target_mask, block_t,
                                      with_vecs, vectors)
            # Cache entries PIN the vectors object ((jt, vectors) pairs):
            # the key uses id(vectors), and CPython recycles ids after GC
            # — holding the reference makes the id stable for the entry's
            # lifetime, so a new same-id table can never hit a stale
            # tiling with the old table's rows baked in.
            hit = self._join_cache.get(ck)
            jt = hit[0] if hit is not None else None
            if hit is not None:
                # LRU, not FIFO: re-insert on hit so a hot target set (the
                # statistics-table serving pattern) is never the first
                # evicted just because it was inserted first.
                self._join_cache.pop(ck)
                self._join_cache[ck] = hit
            if jt is None:
                # The tiling build is this framework's "data retrieval"
                # stage: moving the target rows into scan layout — the SPI
                # fetch analog (TRACK data_retrieval_time,
                # ivpq_search_in.c:400-405). Timed by materializing a
                # scalar leaf.
                t0 = time.perf_counter()
                jt = build_join_tiles(
                    target_codes, target_cells, target_mask, target_vecs
                    if with_vecs else jnp.zeros((target_ids.shape[0], 1),
                                                jnp.float32),
                    block_t=block_t, num_cells=self.num_cells,
                    with_vecs=with_vecs)
                np.asarray(jt.t_real)
                data_retrieval_s = time.perf_counter() - t0
                # jit converts the int leaves to arrays; restore static ints.
                jt = jt._replace(
                    block_t=block_t,
                    inf_tile=int(jt.codes.shape[0]) // block_t - 1)
                if len(self._join_cache) >= self._JOIN_CACHE_CAP:
                    self._join_cache.pop(next(iter(self._join_cache)))
                self._join_cache[ck] = (jt, vectors if with_vecs else None)

        B = queries.shape[0]
        # Chunk on HOST: an eager device slice queries[s:s+c] builds a NEW
        # jaxpr per distinct start, which made the first full-size join
        # several times slower than steady state
        # (evaluation/join_method_diag.py pins it).
        q_host = np.asarray(queries) if B > query_chunk else queries
        shared = (target_codes, target_cells, target_ids, target_mask,
                  target_vecs, statistics)
        # Phase 1: dispatch round 1 for EVERY chunk before any host sync —
        # the escalation decision needs a blocking bool() per chunk, and
        # taking it inside the chunk loop would serialize the chunks behind
        # each other's host syncs. Dispatched back-to-back, the waits
        # overlap.
        chunks = []
        for start in range(0, B, query_chunk):
            qc = q_host[start:start + query_chunk]
            pad_q = 0
            if start > 0 and qc.shape[0] < query_chunk:
                # pad the ragged final chunk to the compiled shape — a
                # second program per (B % query_chunk) shape costs a full
                # XLA compile and defeats warmup (round-1 weak spot #9).
                pad_q = query_chunk - qc.shape[0]
                qc = np.pad(qc, ((0, pad_q), (0, 0)))
            state = self._join_round1(
                qc, *shared, k, alpha, pvf, method, confidence,
                long_codes_threshold, jt=jt, budget_tiles=budget_tiles)
            chunks.append((pad_q, qc, state))
        # Phase 2: resolve each chunk. Multi-chunk calls first read ONE
        # combined all-chunks-done scalar (one device round trip instead
        # of one blocking bool() per chunk); only when some chunk isn't
        # done does the per-chunk escalation path pay its own read.
        all_done = None
        if len(chunks) > 1:
            all_done = bool(np.asarray(_stack_done(
                [st["done"] for (_p, _q, st) in chunks])))
        out_vals, out_ids, infos = [], [], []
        for pad_q, qc, state in chunks:
            vals, ids, info = self._join_escalate(
                qc, state, *shared, k, alpha, pvf, method, confidence,
                long_codes_threshold, max_rounds, jt=jt,
                budget_tiles=budget_tiles,
                done_hint=True if all_done else None)
            out_vals.append(vals)
            out_ids.append(ids)
            infos.append((pad_q, info))
        if len(out_vals) == 1 and not infos[0][0]:
            # single-chunk fast path: stay on device, no transfer.
            vals, ids = out_vals[0], out_ids[0]
            if return_info:
                merged = dict(infos[0][1], data_retrieval_s=data_retrieval_s,
                              impl=impl)
                return vals, ids, merged
            return vals, ids
        # Merge on HOST after ONE batched transfer: eager jnp.concatenate /
        # pad-slices here would trace+compile on first call. The chunk
        # dispatches above stay fully pipelined; outputs are
        # (chunk, k)-small.
        out_vals, out_ids = jax.device_get((out_vals, out_ids))
        last_pad = infos[-1][0]
        if last_pad:
            out_vals[-1] = out_vals[-1][:-last_pad]
            out_ids[-1] = out_ids[-1][:-last_pad]
        vals = np.concatenate(out_vals, 0)
        ids = np.concatenate(out_ids, 0)
        if return_info:
            merged = {}
            raw = [jax.device_get(i) for (_p, i) in infos]
            for key in raw[0]:
                if hasattr(raw[0][key], "shape") and raw[0][key].ndim > 0:
                    parts = [r[key] for r in raw]
                    if last_pad:
                        parts[-1] = parts[-1][:-last_pad]
                    merged[key] = np.concatenate(parts, 0)
                else:
                    merged[key] = max(r[key] for r in raw)
            merged["data_retrieval_s"] = data_retrieval_s
            merged["impl"] = impl
            return vals, ids, merged
        return vals, ids

    @staticmethod
    def _join_tiles_key(target_ids, target_mask, block_t: int,
                        with_vecs: bool, vectors) -> tuple:
        """Cache key: content fingerprint of the target set (one small host
        transfer of T int32 + T bool) + layout params. ``vectors`` enters by
        object identity only — with_vecs tilings bake the gathered raw rows
        in, and recomputing a content hash of the full table would cost more
        than the tiling (a *mutated-in-place* table aliasing an old id is
        not a pattern jax arrays allow)."""
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        h.update(np.asarray(target_ids).tobytes())
        h.update(np.asarray(target_mask).tobytes())
        return (h.hexdigest(), block_t, with_vecs,
                id(vectors) if with_vecs else None)

    def _join_round1(self, queries, target_codes, target_cells, target_ids,
                     target_mask, target_vecs, statistics, k, alpha, pvf,
                     method, confidence, long_codes_threshold,
                     jt=None, budget_tiles=None):
        """First probe round of the alpha-escalation loop — dispatch only,
        NO host sync, so callers can pipeline many chunks' round 1 before
        paying the first blocking status read."""
        conf_arr = jnp.float32(confidence)
        # Fused-pair LUT trigger: alpha·k > threshold where k is the
        # requested neighbor count (parity: ivpq_search_in.c:262
        # "alpha * k > double_threshold").
        use_double = alpha * k > long_codes_threshold
        (vals, ids, retrieved, exhausted, predicted, resolved,
         done) = self._run_round(
            queries, target_codes, target_cells, target_ids, target_mask,
            target_vecs, statistics, k, int(alpha), pvf, method, conf_arr,
            use_double, jt, budget_tiles)
        return dict(vals=vals, ids=ids, retrieved=retrieved,
                    exhausted=exhausted, predicted=predicted,
                    resolved=resolved, done=done)

    def _join_escalate(self, queries, state, target_codes, target_cells,
                       target_ids, target_mask, target_vecs, statistics, k,
                       alpha, pvf, method, confidence, long_codes_threshold,
                       max_rounds, jt=None, budget_tiles=None,
                       done_hint: bool | None = None):
        """Alpha-escalation loop over fixed-shape rounds
        (ivpq_search_in.c:639-684), continuing from a ``_join_round1``
        state. ``done_hint=True`` means the caller already read a combined
        all-chunks-done scalar (one device read for the whole batch), so
        the per-chunk blocking bool() is skipped."""
        conf_arr = jnp.float32(confidence)
        cur_alpha = int(alpha)
        best_vals, best_ids = state["vals"], state["ids"]
        best_retrieved, best_predicted = state["retrieved"], state["predicted"]
        resolved, done = state["resolved"], state["done"]
        rounds = 1
        for _ in range(max_rounds - 1):
            if done_hint if done_hint is not None else bool(done):
                break
            done_hint = None    # only valid for the round-1 state
            cur_alpha += cur_alpha  # alpha += alpha (ivpq_search_in.c:682)
            use_double = cur_alpha * k > long_codes_threshold
            (vals, ids, retrieved, exhausted, predicted, _resolved,
             _done) = self._run_round(
                queries, target_codes, target_cells, target_ids, target_mask,
                target_vecs, statistics, k, cur_alpha, pvf, method, conf_arr,
                use_double, jt, budget_tiles)
            (best_vals, best_ids, best_retrieved, best_predicted, resolved,
             done) = _merge_round(best_vals, best_ids, best_retrieved,
                                  best_predicted, vals, ids, retrieved,
                                  predicted, resolved, exhausted, k=k)
            rounds += 1
        info = {"retrieved": best_retrieved, "target_count": best_predicted,
                "rounds": rounds, "final_alpha": cur_alpha}
        return best_vals, best_ids, info

    @staticmethod
    def join_impl(impl: str | None = None,
                  use_targetlists: bool = True) -> str:
        """Resolve the join's distance phase: "budget" (the tiled probe,
        Triton kernels) on the GPU, "dense" (full-T ADC + mask, the XLA
        reference) elsewhere or when target lists are off."""
        if impl not in (None, "budget", "dense"):
            raise ValueError(f"impl must be budget|dense, got {impl!r}")
        if not use_targetlists:
            return "dense"
        if impl is None:
            return "budget" if backend.use_kernels() else "dense"
        return impl

    def _budget_for(self, jt, k, alpha, budget_tiles):
        """Tile budget for one round: sized to the expected k·alpha
        candidate rows (pow2 so escalation reuses compiled programs)."""
        cap = max(int(jt.codes.shape[0]) // jt.block_t - 1, 1)
        if budget_tiles is not None:
            return max(1, min(budget_tiles, cap))
        want = max(8, (2 * k * alpha) // jt.block_t + 4)
        return min(1 << int(np.ceil(np.log2(want))), cap)

    def _run_round(self, queries, target_codes, target_cells, target_ids,
                   target_mask, target_vecs, statistics, k, alpha, pvf,
                   method, confidence, use_double, jt=None,
                   budget_tiles=None):
        """One probe round as ONE fused device program (distance phase +
        id map + retirement status) → 7-tuple
        (vals, gids, retrieved, exhausted, predicted, resolved, done)."""
        if jt is not None:
            p = self._budget_for(jt, k, alpha, budget_tiles)
            return _budget_round_program(
                queries, self.coarse.centroids, self.codebook.centroids,
                jt, target_vecs, target_ids, statistics, k, alpha, pvf,
                method, confidence, use_double, p_budget=p,
                block_t=jt.block_t, use_kernel=backend.use_kernels())
        return _dense_round_program(
            queries, self.coarse.centroids, self.codebook.centroids,
            target_codes, target_cells, target_ids, target_mask, statistics,
            target_vecs, k, alpha, pvf, method, confidence, use_double,
            backend.use_kernels())

    # ------------------------------------------------------------ mutation
    def add(self, new_vectors: Array) -> "IVPQIndex":
        """Online insert (``insert_batch``'s IVPQ leg, freddy.c:1590-1609):
        multi-index assignment + running-mean fine-codebook update."""
        new_cells = assign_cells(new_vectors, self.coarse.centroids)
        cb, new_codes = online_codebook_update(self.codebook, new_vectors)
        cell_counts = self.coarse.cell_counts + jnp.bincount(
            new_cells, length=self.num_cells).astype(jnp.int32)
        return IVPQIndex(
            MultiIndexQuantizer(self.coarse.centroids, cell_counts), cb,
            jnp.concatenate([self.codes,
                             new_codes.astype(self.codes.dtype)], 0),
            jnp.concatenate([self.cell_of, new_cells.astype(jnp.int32)], 0))

    # --------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            path,
            coarse_centroids=np.asarray(self.coarse.centroids),
            cell_counts=np.asarray(self.coarse.cell_counts),
            centroids=np.asarray(self.codebook.centroids),
            counts=np.asarray(self.codebook.counts),
            codes=np.asarray(self.codes),
            cell_of=np.asarray(self.cell_of))

    @classmethod
    def load(cls, path: str | Path) -> "IVPQIndex":
        with np.load(path) as f:
            return cls(
                MultiIndexQuantizer(jnp.asarray(f["coarse_centroids"]),
                                    jnp.asarray(f["cell_counts"])),
                PQCodebook(jnp.asarray(f["centroids"]),
                           jnp.asarray(f["counts"])),
                jnp.asarray(f["codes"]), jnp.asarray(f["cell_of"]))

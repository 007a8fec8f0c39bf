"""IVFADC — inverted file with asymmetric distance on PQ-coded residuals.

Parity targets:
- build driver ivfadc.py (coarse k-means + residual codebook + per-vector
  codes → ``coarse_quantization`` / ``fine_quantization`` /
  ``residual_codebook`` tables; defaults from ivfadc_config.json: m=12,
  k=256, k_coarse=1000, train 100k),
- search kernels ``ivfadc_search`` (freddy.c:172-410) and
  ``ivfadc_batch_search`` (freddy.c:677-1024),
- post-verified wrapper ``k_nearest_neighbour_ivfadc_pv`` (sql:556-591).

Device layout: the SQL ``WHERE coarse_id IN (…)`` becomes a CSR inverted file —
codes sorted by coarse cell with prefix offsets, so probing a cell is a
contiguous gather window (DMA-friendly), padded to a static per-index cap.
The reference's data-dependent "widen until ≥k found" loop (freddy.c:262-378,
blacklist + next-best cells) is reproduced as a host-side nprobe-doubling
escalation over a fixed ladder — recall semantics preserved, loop structure
compiler-friendly (SURVEY §7 "hard parts").
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from postgres_word2vec.models.pq import PQCodebook, online_codebook_update
from postgres_word2vec.ops import adc, backend, kmeans, lut
from postgres_word2vec.ops import topk as topk_ops

Array = jax.Array


class CoarseQuantizer(NamedTuple):
    """Flat coarse quantizer (parity: ``coarse_quantization`` table +
    ``getCoarseQuantizer``, index_utils.c:531-575)."""
    centroids: Array  # (C, d) float32
    counts: Array     # (C,) int32


def grouped_adc_distances(luts: Array, codes: Array) -> Array:
    """ADC with per-group LUTs: ``(..., m, k) × (..., L, m) → (..., L)``.

    Each leading-dim group (query × probed cell) has its own LUT — the
    residual-ADC pattern of ``ivfadc_search`` (freddy.c:347-373).

    Formulated as a vmapped 1-D gather into each group's flattened
    ``(m·k,)`` table (a broadcast-then-take_along_axis formulation makes
    XLA materialize a (groups, L, m, k) intermediate and explodes compile
    time at probe sizes).
    """
    m, k = luts.shape[-2:]
    lead = codes.shape[:-2]
    L = codes.shape[-2]
    flat_luts = luts.astype(jnp.float32).reshape(-1, m * k)
    idx = (codes.astype(jnp.int32)
           + (jnp.arange(m, dtype=jnp.int32) * k)[None, :])
    idx = idx.reshape(-1, L * m)
    gathered = jax.vmap(lambda t, i: jnp.take(t, i, axis=0))(flat_luts, idx)
    return gathered.reshape(*lead, L, m).sum(-1)


class TiledIVF(NamedTuple):
    """Cell-aligned tiled inverted file — the device probe layout.

    Every cell's rows are padded to whole tiles of ``block_t`` rows, so a
    probe is a set of tile DMAs whose count tracks the cell's true size
    (replacing the ``w × max_cell`` padding of the row-1 probe, which made
    every query pay for the largest cell). One trailing all-padding "inf
    tile" absorbs unused budget slots. ``rowterm`` carries the
    query-independent part of the IVFADC distance decomposition

        ‖q − c − r‖² = ‖q − r‖²(LUT) + 2·c·r(rowterm) + ‖q − c‖² − ‖q‖²

    so LUTs become cell-independent — one per query instead of one per
    (query, probed cell) (the reference rebuilds the LUT per probed cell,
    freddy.c:306-314).
    """
    block_t: int
    codes_rows: Array  # (NA, m) storage dtype, cell-aligned
    rowterm: Array     # (NA,) f32; +inf on padding rows
    row_ids: Array     # (NA,) int32; -1 on padding rows
    tile_start: Array  # (C,) int32 first tile of each cell
    tile_cnt: Array    # (C,) int32 tiles per cell
    tile_rows: Array   # (NT,) int32 real rows per tile (inf tile = 0)
    cell_sizes: Array  # (C,) int32 real rows per cell
    inf_tile: int
    max_tile_cnt: int
    avg_tile_cnt: float


def _compute_rowterm(coarse_centroids: Array, codebooks: Array,
                     cells: Array, codes: Array, *,
                     chunk_size: int = 1_048_576) -> Array:
    """rowterm[r] = 2·Σ_j coarse[cell_r]_j · cb_j[code_rj] → (n,) f32."""
    C, d = coarse_centroids.shape
    m, k, dsub = codebooks.shape
    percell = 2.0 * jnp.einsum(
        "cmd,mkd->cmk",
        coarse_centroids.astype(jnp.float32).reshape(C, m, dsub),
        codebooks.astype(jnp.float32),
        preferred_element_type=jnp.float32).reshape(-1)
    j_off = (jnp.arange(m, dtype=jnp.int32) * k)[None, :]

    def chunk_fn(args):
        cc, co = args
        idx = (cc.astype(jnp.int32)[:, None] * (m * k)
               + j_off + co.astype(jnp.int32))
        return jnp.sum(jnp.take(percell, idx), axis=-1)

    n = codes.shape[0]
    if n <= chunk_size:
        return chunk_fn((cells, codes))
    pad = (-n) % chunk_size
    cp = jnp.pad(cells, (0, pad)).reshape(-1, chunk_size)
    op = jnp.pad(codes, ((0, pad), (0, 0))).reshape(-1, chunk_size,
                                                    codes.shape[1])
    out = lax.map(chunk_fn, (cp, op))
    return out.reshape(-1)[:n]


def plan_probe_tiles(p_budget: int, start: Array, cnt: Array,
                     inf_tile) -> tuple[Array, Array]:
    """Flatten each query's selected cells into ``p_budget`` tile slots.

    ``start``/``cnt`` are ``(B, W)`` per-query first-tile ids and tile
    counts of the cells to probe, in probe order (set ``cnt`` to 0 for
    cells beyond a query's adaptive selection). Returns ``(tiles (B, P)
    int32, slot_cell (B, P) int32)`` where ``slot_cell`` is the index into
    the W probe slots each tile belongs to (W for unused slots, which
    point at the inf tile).
    """
    B, w = cnt.shape
    cum = jnp.cumsum(cnt, axis=1)                            # (B, w)
    p_iota = jnp.arange(p_budget, dtype=jnp.int32)
    # slot of budget position p = first cell whose cumulative tile count
    # exceeds p (searchsorted-right skips zero-count cells correctly).
    s = jax.vmap(lambda c: jnp.searchsorted(c, p_iota, side="right"))(
        cum).astype(jnp.int32)                               # (B, P) ∈ [0,w]
    valid = s < w
    sc = jnp.minimum(s, w - 1)
    prev = jnp.take_along_axis(
        jnp.pad(cum, ((0, 0), (1, 0))), sc, axis=1)          # cum before sc
    within = p_iota[None, :] - prev
    tiles = jnp.where(valid,
                      jnp.take_along_axis(start, sc, axis=1) + within,
                      inf_tile).astype(jnp.int32)
    return tiles, jnp.where(valid, sc, w).astype(jnp.int32)


#: batches of at least this many queries probe through the XLA twin even
#: where the kernel runs: on IVFADC's 1,024-row tiles the Triton probe won
#: at B=256 and lost from B=512 up (0.58 vs 0.48 ms at B=1024, H100;
#: PERF.md)
_PROBE_KERNEL_MAX_B = 512


@functools.partial(jax.jit, static_argnames=(
    "w_lo", "w_hi", "k", "p_budget", "block_t", "use_kernel"))
def _ivfadc_probe_budget(queries: Array, coarse: Array, centroids: Array,
                         tiled: TiledIVF, w_lo: int, w_hi: int, k: int,
                         p_budget: int, block_t: int, use_kernel: bool
                         ) -> tuple[Array, Array, Array, Array]:
    """Budgeted probe of cells ranked [w_lo, w_hi) per query.

    ``w_lo > 0`` skips already-probed cells — the blacklist of the
    reference's widening loop (freddy.c:262-378) as a rank window. Returns
    (sqdists (B,k), ids (B,k), found rows scanned (B,), needed rows of all
    selected cells (B,)).
    """
    B = queries.shape[0]
    cd = kmeans.pairwise_sqdist(queries, coarse)             # (B, C)
    cdv, cells = topk_ops.top_k_smallest(cd, w_hi)
    cdv, cells = cdv[:, w_lo:], cells[:, w_lo:]              # (B, w)

    tiles, slot_cell = plan_probe_tiles(
        p_budget, jnp.take(tiled.tile_start, cells),
        jnp.take(tiled.tile_cnt, cells), tiled.inf_tile)
    luts = lut.build_luts(queries, centroids)                # (B, m, k)
    if use_kernel and B < _PROBE_KERNEL_MAX_B:
        from postgres_word2vec.ops import pallas_kernels as pk
        d = pk.budget_adc(luts, tiled.codes_rows, tiled.rowterm, tiles,
                          block_t=block_t)
    else:
        d = adc.budget_adc_xla(luts, tiled.codes_rows, tiled.rowterm, tiles,
                               block_t=block_t)
    # add the cell-level constant: ‖q−c‖² − ‖q‖² per slot.
    qq = jnp.sum(queries.astype(jnp.float32) ** 2, axis=-1)  # (B,)
    cd_slot = jnp.take_along_axis(
        jnp.pad(cdv, ((0, 0), (0, 1))), slot_cell, axis=1)   # (B, P)
    d = d.reshape(B, p_budget, block_t) + (cd_slot - qq[:, None])[:, :, None]
    d = jnp.maximum(d, 0.0).reshape(B, p_budget * block_t)
    d = jnp.where(jnp.isnan(d), jnp.inf, d)  # inf + finite stays inf; guard

    k_eff = min(k, p_budget * block_t)
    vals, pos = topk_ops.top_k_smallest(d, k_eff)
    slot = pos // block_t
    lane = pos % block_t
    gpos = jnp.take_along_axis(tiles, slot, axis=1) * block_t + lane
    ids = jnp.where(jnp.isfinite(vals),
                    jnp.take(tiled.row_ids, gpos), -1).astype(jnp.int32)
    if k_eff < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - k_eff)),
                       constant_values=jnp.inf)
        ids = jnp.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
    found = jnp.sum(jnp.take(tiled.tile_rows, tiles), axis=1)
    needed = jnp.sum(jnp.take(tiled.cell_sizes, cells), axis=1)
    return vals, ids, found, needed


@functools.partial(jax.jit, static_argnames=("w_lo", "w_hi", "k"))
def _tail_scan(queries: Array, coarse: Array, centroids: Array,
               tail_codes: Array, tail_cells: Array, tail_ids: Array,
               tail_rowterm: Array, tail_count: Array, w_lo: int, w_hi: int,
               k: int) -> tuple[Array, Array, Array]:
    """Scan the LSM insert tail against each query's probed-cell window
    [w_lo, w_hi): dense residual ADC over the (small) slab, masked to rows
    whose cell the query probes. Returns (vals, ids, rows_seen).

    ``tail_rowterm`` is refreshed against the current codebook by ``add()``
    (recomputing the (C, m, k) einsum per search call was the dominant tail
    cost; per-add refresh keeps it consistent with the LUT basis)."""
    cap = tail_codes.shape[0]
    cd = kmeans.pairwise_sqdist(queries, coarse)
    _, cells = topk_ops.top_k_smallest(cd, w_hi)
    cells = cells[:, w_lo:]
    luts = lut.build_luts(queries, centroids)
    d = adc.adc_distances(luts, tail_codes)                  # (B, cap)
    qq = jnp.sum(queries.astype(jnp.float32) ** 2, axis=-1)
    dist = (d + tail_rowterm[None, :] + jnp.take(cd, tail_cells, axis=1)
            - qq[:, None])
    probed = jnp.any(tail_cells[None, :, None] == cells[:, None, :],
                     axis=-1)
    valid = (jnp.arange(cap) < tail_count)[None, :] & probed
    dist = jnp.where(valid, jnp.maximum(dist, 0.0), jnp.inf)
    vals, pos = topk_ops.top_k_smallest(dist, min(k, cap))
    ids = jnp.where(jnp.isfinite(vals),
                    jnp.take(tail_ids, pos), -1).astype(jnp.int32)
    return vals, ids, jnp.sum(valid.astype(jnp.int32), axis=-1)


@functools.partial(jax.jit, static_argnames=("w", "k", "list_cap"))
def _ivfadc_probe(queries: Array, coarse: Array, centroids: Array,
                  cell_offsets: Array, codes_sorted: Array, row_ids: Array,
                  w: int, k: int, list_cap: int) -> tuple[Array, Array, Array]:
    """Probe the w nearest cells per query, ADC-scan their lists, top-k.

    Returns (sqdists, global ids, found) where ``found[b]`` is the number of
    real (non-padding) candidates seen — the signal for escalation, mirroring
    the reference's ``foundInstances`` counter (freddy.c:262).
    """
    B, d = queries.shape
    m = codes_sorted.shape[1]

    # 1. coarse assignment: one matmul + top-w (freddy.c:272-283's scan).
    cd = kmeans.pairwise_sqdist(queries, coarse)            # (B, C)
    _, cells = topk_ops.top_k_smallest(cd, w)               # (B, w)

    # 2. residuals + per-(query, cell) LUTs (freddy.c:296-314).
    resid = queries[:, None, :] - jnp.take(coarse, cells, axis=0)  # (B, w, d)
    luts = lut.build_luts(resid.reshape(B * w, d), centroids)
    luts = luts.reshape(B, w, *luts.shape[1:])              # (B, w, m, k)

    # 3. contiguous gather windows per probed cell.
    starts = jnp.take(cell_offsets, cells)                  # (B, w)
    ends = jnp.take(cell_offsets, cells + 1)                # (B, w)
    lane = jnp.arange(list_cap)
    pos = starts[..., None] + lane                          # (B, w, L)
    valid = pos < ends[..., None]
    pos_c = jnp.minimum(pos, codes_sorted.shape[0] - 1)
    cand_codes = jnp.take(codes_sorted, pos_c, axis=0)      # (B, w, L, m)

    # 4. ADC + masked top-k over all probed candidates.
    dists = grouped_adc_distances(luts, cand_codes)         # (B, w, L)
    dists = jnp.where(valid, dists, jnp.inf)
    flat = dists.reshape(B, w * list_cap)
    vals, flat_pos = topk_ops.top_k_smallest(flat, min(k, w * list_cap))
    gpos = jnp.take_along_axis(pos_c.reshape(B, w * list_cap), flat_pos,
                               axis=-1)
    ids = jnp.where(jnp.isfinite(vals), jnp.take(row_ids, gpos), -1)
    found = jnp.sum(valid.reshape(B, -1), axis=-1)
    return vals, ids.astype(jnp.int32), found


@dataclasses.dataclass
class IVFADCIndex:
    """CSR inverted file over PQ-coded residuals, all HBM-resident."""

    coarse: CoarseQuantizer
    codebook: PQCodebook          # residual codebook (m, k, dsub)
    cell_offsets: Array           # (C+1,) int32 prefix offsets into sorted
    codes_sorted: Array           # (n, m) codes sorted by coarse cell
    row_ids: Array                # (n,) sorted position → original row id
    assignments: Array            # (n,) original row id → coarse cell
    list_cap: int                 # static max cell length (gather window)

    # LSM-style insert tail: fixed-capacity unsorted slab of freshly
    # inserted rows (searched by a small dense ADC scan merged into every
    # probe), flushed into the CSR when full — so inserts are O(batch)
    # fixed-shape device writes, not an O(n) table rebuild.
    tail_codes: Array | None = None   # (TAIL_CAP, m)
    tail_cells: Array | None = None   # (TAIL_CAP,)
    tail_ids: Array | None = None     # (TAIL_CAP,)
    tail_rowterm: Array | None = None  # (TAIL_CAP,) f32, kept by add()
    tail_count: int = 0

    _tiled: TiledIVF | None = dataclasses.field(default=None, repr=False,
                                                compare=False)

    TAIL_CAP = 8192

    @property
    def size(self) -> int:
        return int(self.codes_sorted.shape[0]) + int(self.tail_count)

    @property
    def num_cells(self) -> int:
        return int(self.coarse.centroids.shape[0])

    # ------------------------------------------------------------ building
    @classmethod
    def build(cls, key: Array, vectors: Array, *, m: int = 12, k: int = 256,
              k_coarse: int = 1000, train_size: int | None = 100_000,
              iters: int = 10, restarts: int = 1,
              init: str = "sample") -> "IVFADCIndex":
        """Coarse k-means → residuals → residual codebook → CSR lists
        (``create_index_data`` parity, ivfadc.py:36-96)."""
        n = vectors.shape[0]
        ck, rk, sk = jax.random.split(key, 3)
        if train_size is not None and train_size < n:
            idx = jax.random.choice(sk, n, shape=(train_size,), replace=False)
            train = jnp.take(vectors, idx, axis=0)
        else:
            train = vectors
        coarse_res = kmeans.kmeans(ck, train, k=k_coarse, iters=iters,
                                   restarts=restarts, init=init)
        assign = kmeans.assign(vectors, coarse_res.centroids)
        # residual codebook trains on the sample only; the full residual
        # table is never materialized (fused subtract+encode below).
        train_assign = kmeans.assign(train, coarse_res.centroids)
        train_resid = train - jnp.take(coarse_res.centroids, train_assign,
                                       axis=0)
        sub = kmeans.split_subspaces(train_resid, m)
        cb_res = kmeans.kmeans_subspaces(rk, sub, k=k, iters=iters,
                                         restarts=restarts, init=init)
        codes = kmeans.encode_residual_subspaces(
            vectors, coarse_res.centroids, assign, cb_res.centroids)

        return cls._assemble(
            CoarseQuantizer(coarse_res.centroids,
                            jnp.bincount(assign, length=k_coarse
                                         ).astype(jnp.int32)),
            PQCodebook(cb_res.centroids, cb_res.counts), codes, assign)

    @classmethod
    def _assemble(cls, coarse: CoarseQuantizer, codebook: PQCodebook,
                  codes: Array, assign: Array) -> "IVFADCIndex":
        k_coarse = coarse.centroids.shape[0]
        assign_np = np.asarray(assign)
        order = np.argsort(assign_np, kind="stable")
        sizes = np.bincount(assign_np, minlength=k_coarse)
        offsets = np.zeros(k_coarse + 1, np.int32)
        np.cumsum(sizes, out=offsets[1:])
        list_cap = int(sizes.max()) if sizes.size and sizes.max() > 0 else 1
        return cls(
            coarse=coarse, codebook=codebook,
            cell_offsets=jnp.asarray(offsets),
            codes_sorted=jnp.asarray(np.asarray(codes)[order]),
            row_ids=jnp.asarray(order.astype(np.int32)),
            assignments=jnp.asarray(assign_np.astype(np.int32)),
            list_cap=list_cap)

    # ----------------------------------------------------------- tiled IVF
    def tiled(self, block_t: int | None = None) -> TiledIVF:
        """Build (and cache) the cell-aligned tiled probe layout."""
        if self._tiled is not None and (block_t is None
                                        or self._tiled.block_t == block_t):
            return self._tiled
        bt = block_t or (1024 if self.size >= 500_000 else 128)
        offsets = np.asarray(self.cell_offsets).astype(np.int64)
        sizes = np.diff(offsets)
        n, m = self.codes_sorted.shape
        tile_cnt = -(-sizes // bt)                      # ceil; empty cell→0
        tile_start = np.zeros_like(tile_cnt)
        np.cumsum(tile_cnt[:-1], out=tile_start[1:])
        nt = int(tile_cnt.sum())
        inf_tile = nt
        na = (nt + 1) * bt

        # aligned position of each sorted row (vectorized scatter).
        cells_sorted = np.repeat(np.arange(sizes.size), sizes)
        within = np.arange(n, dtype=np.int64) - offsets[cells_sorted]
        apos = tile_start[cells_sorted] * bt + within

        codes_np = np.asarray(self.codes_sorted)
        rows_aligned = np.zeros((na, m), codes_np.dtype)
        rows_aligned[apos] = codes_np
        rid_aligned = np.full((na,), -1, np.int32)
        rid_aligned[apos] = np.asarray(self.row_ids)
        rowterm = np.full((na,), np.inf, np.float32)
        rowterm[apos] = np.asarray(_compute_rowterm(
            self.coarse.centroids, self.codebook.centroids,
            jnp.asarray(cells_sorted.astype(np.int32)), self.codes_sorted))

        tile_of_row = tile_start[cells_sorted] + within // bt
        tile_rows = np.bincount(tile_of_row, minlength=nt + 1).astype(
            np.int32)

        tiled = TiledIVF(
            block_t=bt,
            codes_rows=jnp.asarray(rows_aligned),
            rowterm=jnp.asarray(rowterm),
            row_ids=jnp.asarray(rid_aligned),
            tile_start=jnp.asarray(tile_start.astype(np.int32)),
            tile_cnt=jnp.asarray(tile_cnt.astype(np.int32)),
            tile_rows=jnp.asarray(tile_rows),
            cell_sizes=jnp.asarray(sizes.astype(np.int32)),
            inf_tile=inf_tile,
            max_tile_cnt=int(tile_cnt.max()) if tile_cnt.size else 1,
            avg_tile_cnt=float(tile_cnt.mean()) if tile_cnt.size else 1.0)
        object.__setattr__(self, "_tiled", tiled)
        return tiled

    def _auto_budget(self, w: int, budget_tiles: int | None,
                     full: bool) -> int:
        t = self.tiled()
        exact = max(w * t.max_tile_cnt, 1)
        if budget_tiles is not None:
            return max(1, min(budget_tiles, exact))
        if full:
            return exact
        # round to a power of two so escalation reuses compiled programs.
        want = max(1, int(np.ceil(1.5 * w * t.avg_tile_cnt)))
        return min(1 << int(np.ceil(np.log2(want))), exact)

    # ------------------------------------------------------------- search
    def search(self, queries: Array, k: int, *, w: int = 3,
               budget_tiles: int | None = None,
               return_info: bool = False, impl: str | None = None):
        """Fixed-nprobe batched IVFADC (``ivfadc_search`` with PARAM_W
        default 3, sql:189; batch parity: ``ivfadc_batch_search``).

        Default semantics match the reference: the w probed cells are
        scanned in full (budget = w × max tiles — but unlike row-1's
        padded gather, cost tracks each cell's TRUE size because unused
        tile slots land on one shared inf tile). ``budget_tiles`` caps the
        per-query scan for latency-bound callers; coverage is reported via
        ``return_info`` (found = rows actually scanned, needed = rows in
        all selected cells). ``impl="xla"`` takes the plain-XLA probe on
        any backend.

        Reference delta, documented: the
        reference's batch mode assigns each query to exactly ONE
        unblacklisted cell per round and groups queries per cell
        (freddy.c:893-912) — its cheapest published operating point
        (0.01 s @ 0.35 recall, BASELINE.md) scans one cell per query.
        This path always probes ``w`` cells per query (a strictly better
        recall/cost envelope on a GPU, where the tiled probe amortizes over
        the batch); ``w=1`` is the near-equivalent of the reference's
        cheapest point and is benchmarked as ``ivfadc_batch_w1``.
        """
        w_eff = min(w, self.num_cells)
        t = self.tiled()
        p = self._auto_budget(w_eff, budget_tiles, full=budget_tiles is None)
        vals, ids, found, needed = _ivfadc_probe_budget(
            queries, self.coarse.centroids, self.codebook.centroids, t,
            w_lo=0, w_hi=w_eff, k=k, p_budget=p, block_t=t.block_t,
            use_kernel=backend.kernels_for(impl))
        if self.tail_count:
            tv, ti, tf = _tail_scan(
                queries, self.coarse.centroids, self.codebook.centroids,
                self.tail_codes, self.tail_cells, self.tail_ids,
                self.tail_rowterm, jnp.int32(self.tail_count), w_lo=0, w_hi=w_eff, k=k)
            vals, ids = topk_ops.merge_top_k_smallest(vals, ids, tv, ti, k)
            found = found + tf
            needed = needed + tf
        if return_info:
            return vals, ids, {"found": found, "needed": needed,
                               "budget_tiles": p}
        return vals, ids

    def search_adaptive(self, queries: Array, k: int, *, w: int = 3,
                        max_rounds: int = 4,
                        budget_tiles: int | None = None,
                        impl: str | None = None) -> tuple[Array, Array]:
        """Reproduces the reference's widening semantics (freddy.c:262-378):
        probe the w best cells; while some query saw fewer than k rows,
        blacklist the probed cells and probe the NEXT w·(2^r −… ) ranks.
        Each round scans only cells not yet probed (rank window), and
        per-round top-k results merge across rounds — the reference's
        Blacklist + re-scan, without rescanning."""
        t = self.tiled()
        use_kernel = backend.kernels_for(impl)
        w_lo = 0
        w_hi = min(w, self.num_cells)
        p = self._auto_budget(w_hi, budget_tiles,
                              full=budget_tiles is None)
        vals, ids, found, _ = _ivfadc_probe_budget(
            queries, self.coarse.centroids, self.codebook.centroids, t,
            w_lo=w_lo, w_hi=w_hi, k=k, p_budget=p, block_t=t.block_t,
            use_kernel=use_kernel)
        total_found = found
        if self.tail_count:
            tv, ti, tf = _tail_scan(
                queries, self.coarse.centroids, self.codebook.centroids,
                self.tail_codes, self.tail_cells, self.tail_ids,
                self.tail_rowterm, jnp.int32(self.tail_count), w_lo=0, w_hi=w_hi, k=k)
            vals, ids = topk_ops.merge_top_k_smallest(vals, ids, tv, ti, k)
            total_found = total_found + tf
        for _ in range(max_rounds - 1):
            if bool(jnp.all(total_found >= k)) or w_hi >= self.num_cells:
                break
            w_lo, w_hi = w_hi, min(w_hi * 2, self.num_cells)
            p = self._auto_budget(w_hi - w_lo, budget_tiles,
                                  full=budget_tiles is None)
            v2, i2, found, _ = _ivfadc_probe_budget(
                queries, self.coarse.centroids, self.codebook.centroids, t,
                w_lo=w_lo, w_hi=w_hi, k=k, p_budget=p, block_t=t.block_t,
                use_kernel=use_kernel)
            vals, ids = topk_ops.merge_top_k_smallest(vals, ids, v2, i2, k)
            total_found = total_found + found
            if self.tail_count:
                tv, ti, tf = _tail_scan(
                    queries, self.coarse.centroids, self.codebook.centroids,
                    self.tail_codes, self.tail_cells, self.tail_ids,
                    self.tail_rowterm, jnp.int32(self.tail_count), w_lo=w_lo, w_hi=w_hi, k=k)
                vals, ids = topk_ops.merge_top_k_smallest(vals, ids, tv, ti,
                                                          k)
                total_found = total_found + tf
        return vals, ids

    def search_pv(self, queries: Array, k: int, pvf: int, vectors: Array, *,
                  w: int = 3, impl: str | None = None
                  ) -> tuple[Array, Array]:
        """IVFADC shortlist + exact re-rank
        (``k_nearest_neighbour_ivfadc_pv`` parity, sql:556-591)."""
        cd, ci = self.search(queries, k * pvf, w=w, impl=impl)
        return adc.post_verify(queries, ci, cd, vectors, k)

    # ------------------------------------------------------------ mutation
    def add(self, new_vectors: Array) -> "IVFADCIndex":
        """Online insert (``insert_batch``'s IVFADC leg, freddy.c:1573-1587):
        flat coarse assignment, residual encode with running-mean residual
        codebook update, LSM-style tail append.

        New rows land in a fixed-capacity unsorted tail slab (one
        fixed-shape device write — compiles once per batch size, runs in
        ms); every search scans the tail with a small dense residual-ADC
        pass restricted to each query's probed cells and merges it with the
        main probe. When the tail fills, it splices into the CSR in one
        O(n) device pass (no O(n log n) re-sort — round-1 weak spot #6).

        Codebook drift note: like the reference, existing codes are not
        re-encoded after the running-mean codebook update; the cached tiled
        rowterm likewise keeps the pre-update codebook until the next flush
        (error O(‖δcentroid‖) = O(1/count) per insert).
        """
        assign_new = kmeans.assign(new_vectors, self.coarse.centroids)
        resid = new_vectors - jnp.take(self.coarse.centroids, assign_new,
                                       axis=0)
        cb, new_codes = online_codebook_update(self.codebook, resid)
        a_new = assign_new.astype(jnp.int32)
        m_new = int(a_new.shape[0])
        new_codes = new_codes.astype(self.codes_sorted.dtype)
        new_ids = jnp.arange(m_new, dtype=jnp.int32) + self.size
        counts = self.coarse.counts + jnp.bincount(
            a_new, length=self.num_cells).astype(jnp.int32)
        coarse2 = CoarseQuantizer(self.coarse.centroids, counts)

        if self.tail_count + m_new > self.TAIL_CAP:
            # flush: splice tail + new rows into the CSR in one pass.
            tc = self.tail_count
            if tc:
                codes_m = jnp.concatenate(
                    [self.tail_codes[:tc], new_codes], axis=0)
                cells_m = jnp.concatenate([self.tail_cells[:tc], a_new])
                ids_m = jnp.concatenate([self.tail_ids[:tc], new_ids])
            else:
                codes_m, cells_m, ids_m = new_codes, a_new, new_ids
            return self._splice(coarse2, cb, codes_m, cells_m, ids_m)

        m = self.codes_sorted.shape[1]
        t_codes = (self.tail_codes if self.tail_codes is not None
                   else jnp.zeros((self.TAIL_CAP, m),
                                  self.codes_sorted.dtype))
        t_cells = (self.tail_cells if self.tail_cells is not None
                   else jnp.zeros((self.TAIL_CAP,), jnp.int32))
        t_ids = (self.tail_ids if self.tail_ids is not None
                 else jnp.full((self.TAIL_CAP,), -1, jnp.int32))
        t_rt = (self.tail_rowterm if self.tail_rowterm is not None
                else jnp.zeros((self.TAIL_CAP,), jnp.float32))
        t_codes = lax.dynamic_update_slice(t_codes, new_codes,
                                           (self.tail_count, 0))
        t_cells = lax.dynamic_update_slice(t_cells, a_new,
                                           (self.tail_count,))
        t_ids = lax.dynamic_update_slice(t_ids, new_ids, (self.tail_count,))
        # Recompute the ENTIRE tail rowterm against the just-updated
        # codebook: _tail_scan builds LUTs from the current codebook, so a
        # cross-term cached at an older codebook drifts on long-lived tails
        # (advisor round 2). The slab is capped at TAIL_CAP — one small
        # einsum, and rows past tail_count are masked by search anyway.
        del t_rt
        t_rt = _compute_rowterm(self.coarse.centroids, cb.centroids,
                                t_cells, t_codes)
        return IVFADCIndex(
            coarse=coarse2, codebook=cb, cell_offsets=self.cell_offsets,
            codes_sorted=self.codes_sorted, row_ids=self.row_ids,
            assignments=self.assignments, list_cap=self.list_cap,
            tail_codes=t_codes, tail_cells=t_cells, tail_ids=t_ids,
            tail_rowterm=t_rt, tail_count=self.tail_count + m_new,
            _tiled=self._tiled)

    def flush(self) -> "IVFADCIndex":
        """Merge the insert tail into the CSR (no-op when empty)."""
        if not self.tail_count:
            return self
        tc = self.tail_count
        return self._splice(self.coarse, self.codebook,
                            self.tail_codes[:tc], self.tail_cells[:tc],
                            self.tail_ids[:tc])

    def _splice(self, coarse2: CoarseQuantizer, cb: PQCodebook,
                new_codes: Array, a_new: Array,
                new_ids: Array) -> "IVFADCIndex":
        """Device-side CSR splice: new rows sort by cell among themselves
        and append to each cell's region; old rows shift without a global
        re-sort. Nothing leaves HBM."""
        c_count = self.num_cells
        n_old = int(self.codes_sorted.shape[0])
        m_new = int(a_new.shape[0])
        order_new = jnp.argsort(a_new, stable=True)
        cells_ns = jnp.take(a_new, order_new)
        codes_ns = jnp.take(new_codes, order_new, axis=0).astype(
            self.codes_sorted.dtype)
        rid_ns = jnp.take(new_ids.astype(jnp.int32), order_new)

        counts_new = jnp.bincount(a_new, length=c_count)
        old_off = self.cell_offsets.astype(jnp.int32)
        old_sizes = jnp.diff(old_off)
        shift = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                 jnp.cumsum(counts_new).astype(jnp.int32)])
        new_off = old_off + shift

        # old rows keep their order, shifted by the new rows of earlier cells
        cells_old = jnp.repeat(jnp.arange(c_count, dtype=jnp.int32),
                               old_sizes, total_repeat_length=n_old)
        dest_old = jnp.arange(n_old, dtype=jnp.int32) + jnp.take(shift,
                                                                 cells_old)
        # new rows append after their cell's old rows
        rank_new = (jnp.arange(m_new, dtype=jnp.int32)
                    - jnp.take(shift, cells_ns))
        dest_new = (jnp.take(old_off, cells_ns + 1)
                    + jnp.take(shift, cells_ns) + rank_new)

        n_tot = n_old + m_new
        codes_out = jnp.zeros((n_tot, self.codes_sorted.shape[1]),
                              self.codes_sorted.dtype)
        codes_out = codes_out.at[dest_old].set(self.codes_sorted)
        codes_out = codes_out.at[dest_new].set(codes_ns)
        rids_out = jnp.zeros((n_tot,), jnp.int32)
        rids_out = rids_out.at[dest_old].set(self.row_ids.astype(jnp.int32))
        rids_out = rids_out.at[dest_new].set(rid_ns)

        # coarse2 already carries the updated per-cell counts (add()
        # maintains them eagerly, including for tail rows).
        return IVFADCIndex(
            coarse=coarse2,
            codebook=cb,
            cell_offsets=new_off,
            codes_sorted=codes_out,
            row_ids=rids_out,
            assignments=jnp.concatenate([self.assignments, a_new]),
            list_cap=int(jnp.max(jnp.diff(new_off))) if c_count else 1)

    # --------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        if self.tail_count:           # persist in canonical CSR form
            self.flush().save(path)
            return
        np.savez_compressed(
            path,
            coarse_centroids=np.asarray(self.coarse.centroids),
            coarse_counts=np.asarray(self.coarse.counts),
            centroids=np.asarray(self.codebook.centroids),
            counts=np.asarray(self.codebook.counts),
            cell_offsets=np.asarray(self.cell_offsets),
            codes_sorted=np.asarray(self.codes_sorted),
            row_ids=np.asarray(self.row_ids),
            assignments=np.asarray(self.assignments),
            list_cap=np.asarray(self.list_cap))

    @classmethod
    def load(cls, path: str | Path) -> "IVFADCIndex":
        with np.load(path) as f:
            return cls(
                CoarseQuantizer(jnp.asarray(f["coarse_centroids"]),
                                jnp.asarray(f["coarse_counts"])),
                PQCodebook(jnp.asarray(f["centroids"]),
                           jnp.asarray(f["counts"])),
                jnp.asarray(f["cell_offsets"]),
                jnp.asarray(f["codes_sorted"]),
                jnp.asarray(f["row_ids"]),
                jnp.asarray(f["assignments"]),
                int(f["list_cap"]))

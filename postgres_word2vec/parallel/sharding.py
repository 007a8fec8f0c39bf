"""Multi-chip sharding — the framework's scale-out axis.

The reference is single-node/single-process (SURVEY §2.5: no NCCL/MPI/
anything; its de-facto interconnect is per-query SQL). This build scales
the two axes that exist in this workload:

- the **N axis** (database rows): vector/code tables are sharded across
  devices with ``NamedSharding`` on a ``"rows"`` mesh axis; every search
  computes a per-shard top-k and merges with one ``all_gather`` of k rows
  per device — plain collectives (NCCL over NVLink on a GPU host),
  candidate row data never moves.
- the **Q axis** (query batches): sharded on a ``"q"`` mesh axis; queries
  are embarrassingly parallel, so this axis needs no communication at all.

Codebook training (the framework's "training step") is data-parallel
k-means: each device assigns its rows and the centroid update reduces
per-cluster sums/counts with ``psum``.

Everything is ``shard_map`` over a ``Mesh`` + jax collectives; every device
reaches every other at the same rate, so the mesh follows the algorithm.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from postgres_word2vec.models import exact as exact_mod
from postgres_word2vec.ops import adc as adc_mod
from postgres_word2vec.ops import backend
from postgres_word2vec.ops import topk as topk_ops

Array = jax.Array

ROWS_AXIS = "rows"
Q_AXIS = "q"


def make_mesh(devices=None, *, rows: int | None = None,
              q: int = 1) -> Mesh:
    """Build a 2-D ``(rows, q)`` device mesh.

    ``rows`` shards the database axis (communication-bearing), ``q`` shards
    the query batch (communication-free). Defaults to all devices on the
    rows axis.
    """
    devices = jax.devices() if devices is None else list(devices)
    n = len(devices)
    if rows is None:
        rows = n // q
    if rows * q != n:
        raise ValueError(f"{rows}×{q} mesh ≠ {n} devices")
    dev_array = np.asarray(devices).reshape(rows, q)
    return Mesh(dev_array, (ROWS_AXIS, Q_AXIS))


def shard_rows(x: Array, mesh: Mesh) -> Array:
    """Place a row-major table with its leading axis sharded over "rows"."""
    return jax.device_put(x, NamedSharding(mesh, P(ROWS_AXIS)))


def replicate(x: Array, mesh: Mesh) -> Array:
    return jax.device_put(x, NamedSharding(mesh, P()))


def _merge_global(local_vals: Array, local_idx: Array, k: int,
                  shard_size: int) -> tuple[Array, Array]:
    """Inside shard_map: globalize local top-k ids, all-gather over the rows
    axis, re-merge. Returns replicated (vals, ids) of shape (B, k)."""
    offset = lax.axis_index(ROWS_AXIS) * shard_size
    gidx = local_idx + offset
    all_vals = lax.all_gather(local_vals, ROWS_AXIS, axis=1, tiled=True)
    all_idx = lax.all_gather(gidx, ROWS_AXIS, axis=1, tiled=True)
    neg, pos = lax.top_k(-all_vals, k)
    return -neg, jnp.take_along_axis(all_idx, pos, axis=-1)


def sharded_exact_top_k(mesh: Mesh, queries: Array, vectors: Array, k: int,
                        *, dtype: str = "float32",
                        valid_rows: int | None = None
                        ) -> tuple[Array, Array]:
    """Exact top-k over a rows-sharded ``(N, d)`` table.

    ``queries`` is sharded over the q axis; output is (B, k) with global row
    ids, sharded the same way. ``valid_rows`` masks padding rows appended to
    make N divisible by the mesh (their distances become +inf).
    """
    n = vectors.shape[0]
    n_valid = n if valid_rows is None else valid_rows
    n_rows_shards = mesh.shape[ROWS_AXIS]
    if n % n_rows_shards != 0:
        raise ValueError(f"N={n} not divisible by rows={n_rows_shards}; "
                         "pad first (see pad_rows)")
    shard_size = n // n_rows_shards

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(Q_AXIS), P(ROWS_AXIS)),
        out_specs=(P(Q_AXIS), P(Q_AXIS)), check_vma=False)
    def run(q, v_shard):
        d, i = exact_mod.exact_top_k(q, v_shard, min(k, shard_size),
                                     dtype=dtype)
        offset = lax.axis_index(ROWS_AXIS) * shard_size
        d = jnp.where(i + offset < n_valid, d, jnp.inf)
        return _merge_global(d, i, k, shard_size)

    return run(queries, vectors)


def _kernel_default(use_kernel: bool | None) -> bool:
    return backend.use_kernels() if use_kernel is None else use_kernel


def sharded_adc_top_k(mesh: Mesh, luts: Array, codes: Array, k: int, *,
                      valid_rows: int | None = None,
                      use_kernel: bool | None = None) -> tuple[Array, Array]:
    """Exhaustive PQ ADC top-k over a rows-sharded ``(N, m)`` code table
    (the multi-chip ``pq_search``). LUTs are per-query and replicated over
    rows; the 36 MB/3M code shard stays put, only k ids/device move.

    ``use_kernel`` (None = :func:`backend.use_kernels`) scores each shard
    with the Triton ADC scan (chunked, exact top-k), else the XLA gather
    twin."""
    n = codes.shape[0]
    n_valid = n if valid_rows is None else valid_rows
    n_rows_shards = mesh.shape[ROWS_AXIS]
    if n % n_rows_shards != 0:
        raise ValueError(f"N={n} not divisible by rows={n_rows_shards}")
    shard_size = n // n_rows_shards
    use_k = _kernel_default(use_kernel)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(Q_AXIS), P(ROWS_AXIS)),
        out_specs=(P(Q_AXIS), P(Q_AXIS)), check_vma=False)
    def run(l, c_shard):
        d, i = adc_mod.adc_top_k(l, c_shard, min(k, shard_size),
                                 use_kernel=use_k)
        offset = lax.axis_index(ROWS_AXIS) * shard_size
        d = jnp.where(i + offset < n_valid, d, jnp.inf)
        return _merge_global(d, i, k, shard_size)

    return run(luts, codes)


def _sharded_in_topk(mesh: Mesh, q_like: Array, table: Array,
                     target_ids: Array, target_mask: Array, k: int,
                     dist_fn) -> tuple[Array, Array]:
    """Owner-partitioned in-set top-k skeleton shared by the exact and ADC
    variants: each device gathers only the target rows it OWNS from the
    rows-sharded ``table`` (owner = id // shard_size), scores them with
    ``dist_fn(q_like_shard, gathered_rows) -> (B, T)``, masks non-owned
    columns +inf, local top-k, one all_gather merge.

    The distance computation runs over the full (B, T) mask per device —
    wasted columns are masked out. T is the restricted target set (≪ N),
    so the redundancy is noise next to keeping the table sharded.
    """
    n = table.shape[0]
    n_rows = mesh.shape[ROWS_AXIS]
    if n % n_rows != 0:
        raise ValueError(f"N={n} not divisible by rows={n_rows}")
    shard_size = n // n_rows
    t = target_ids.shape[0]
    k_eff = min(k, t)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(Q_AXIS), P(ROWS_AXIS), P(), P()),
        out_specs=(P(Q_AXIS), P(Q_AXIS)), check_vma=False)
    def run(q, tab_shard, t_ids, t_m):
        me = lax.axis_index(ROWS_AXIS)
        safe = jnp.maximum(t_ids, 0)
        owned = t_m & (safe // shard_size == me)
        rows = jnp.take(tab_shard, jnp.where(owned, safe % shard_size, 0),
                        axis=0)                                 # (T, …)
        d = dist_fn(q, rows)
        d = jnp.where(owned[None, :], d, jnp.inf)
        vals, pos = topk_ops.top_k_smallest(d, k_eff)
        ids = jnp.where(jnp.isfinite(vals), jnp.take(t_ids, pos),
                        -1).astype(jnp.int32)
        all_vals = lax.all_gather(vals, ROWS_AXIS, axis=1, tiled=True)
        all_ids = lax.all_gather(ids, ROWS_AXIS, axis=1, tiled=True)
        neg, sel = lax.top_k(-all_vals, k_eff)
        return -neg, jnp.take_along_axis(all_ids, sel, axis=-1)

    vals, ids = run(q_like, table, target_ids, target_mask)
    if k_eff < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - k_eff)),
                       constant_values=jnp.inf)
        ids = jnp.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return vals, ids


def sharded_exact_in(mesh: Mesh, queries: Array, vectors: Array,
                     target_ids: Array, target_mask: Array, k: int
                     ) -> tuple[Array, Array]:
    """Exact in-set top-k over a rows-sharded table (multi-chip
    ``knn_in_exact`` / ``knn_search_in_batch``) — the "shard the target
    gather" layout via :func:`_sharded_in_topk`."""
    def dist(q, rows):
        rows = rows.astype(jnp.float32)
        qf = q.astype(jnp.float32)
        return jnp.maximum(
            jnp.sum(qf * qf, -1)[:, None]
            - 2.0 * jnp.dot(qf, rows.T,
                            preferred_element_type=jnp.float32,
                            precision=lax.Precision.HIGHEST)
            + jnp.sum(rows * rows, -1)[None, :], 0.0)

    return _sharded_in_topk(mesh, queries, vectors, target_ids,
                            target_mask, k, dist)


def sharded_adc_in(mesh: Mesh, luts: Array, codes: Array,
                   target_ids: Array, target_mask: Array, k: int, *,
                   use_kernel: bool | None = None) -> tuple[Array, Array]:
    """PQ ADC in-set top-k over a rows-sharded code table (multi-chip
    ``pq_search_in`` / ``pq_search_in_batch``): same owner-partitioned
    layout as :func:`sharded_exact_in`; the gathered target codes are
    scored with the Triton ADC scan (``use_kernel`` auto) or the XLA
    gather twin."""
    use_k = _kernel_default(use_kernel)

    def dist(l, rows):
        return adc_mod.adc_distances_auto(l, rows, use_k)

    return _sharded_in_topk(mesh, luts, codes, target_ids, target_mask, k,
                            dist)


def sharded_post_verify(mesh: Mesh, queries: Array, cand_dists: Array,
                        cand_ids: Array, vectors: Array, k: int
                        ) -> tuple[Array, Array]:
    """Multi-chip exact re-rank (``postverify``, index_utils.c:477-498):
    candidate raw vectors assemble from the rows-sharded table by
    owner-gather + ``psum`` (each device contributes the rows it owns; the
    (B, C, d) block crosses the interconnect once), then every rows-device
    re-ranks its
    q-shard identically. Completes the PV families on mesh (VERDICT r2
    item 7)."""
    n = vectors.shape[0]
    n_rows = mesh.shape[ROWS_AXIS]
    if n % n_rows != 0:
        raise ValueError(f"N={n} not divisible by rows={n_rows}")
    shard_size = n // n_rows

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(Q_AXIS), P(Q_AXIS), P(Q_AXIS), P(ROWS_AXIS)),
        out_specs=(P(Q_AXIS), P(Q_AXIS)), check_vma=False)
    def run(q, cd, ci, v_shard):
        me = lax.axis_index(ROWS_AXIS)
        safe = jnp.maximum(ci, 0)
        owned = (ci >= 0) & (safe // shard_size == me)
        rows = jnp.take(v_shard,
                        jnp.where(owned, safe % shard_size, 0),
                        axis=0).astype(jnp.float32)      # (B, C, d)
        cand = lax.psum(jnp.where(owned[..., None], rows, 0.0), ROWS_AXIS)
        qf = q.astype(jnp.float32)
        qq = jnp.sum(qf * qf, axis=-1)[:, None]
        cc = jnp.sum(cand * cand, axis=-1)
        qc = jnp.einsum("bd,bcd->bc", qf, cand,
                        preferred_element_type=jnp.float32,
                        precision=lax.Precision.HIGHEST)
        d = jnp.maximum(qq - 2.0 * qc + cc, 0.0)
        valid = (ci >= 0) & jnp.isfinite(cd)
        d = jnp.where(valid, d, jnp.inf)
        vals, pos = topk_ops.top_k_smallest(d, min(k, ci.shape[-1]))
        ids = jnp.take_along_axis(ci, pos, axis=-1)
        return vals, jnp.where(jnp.isfinite(vals), ids, -1)

    return run(queries, cand_dists, cand_ids, vectors)


def sharded_ivfadc_adaptive(mesh: Mesh, queries: Array, bundle: dict, *,
                            k: int, w: int, max_rounds: int = 3
                            ) -> tuple[Array, Array]:
    """Multi-chip IVFADC with widening semantics: probe ``w`` cells via
    :func:`sharded_ivfadc_probe`; queries that found < k real candidates
    re-probe with doubled w (host-side escalation — the fixed-shape analog
    of the reference's blacklist-and-widen loop, freddy.c:262-378, same
    strategy as the single-device ``search_adaptive``).

    Escalation rounds re-probe ONLY the unresolved queries, gathered
    host-side into a power-of-two padded sub-batch (bounded program
    count) — re-running the whole batch at 2w multiplied full-table probe
    cost by the escalation count. All bookkeeping is host numpy."""
    vals, ids = sharded_ivfadc_probe(mesh, queries, bundle, w=w, k=k)
    cur_w = w
    n_cells = int(bundle["coarse"].shape[0])
    vals_np = ids_np = q_np = None
    for _ in range(max_rounds - 1):
        if ids_np is None:
            # np.array (not asarray): np.asarray of a jax array returns a
            # READ-ONLY view — the escalation round writes in place below.
            vals_np, ids_np = np.array(vals), np.array(ids)
        unresolved = np.flatnonzero((ids_np >= 0).sum(axis=-1) < k)
        if unresolved.size == 0 or cur_w >= n_cells:
            break
        cur_w = min(cur_w * 2, n_cells)
        if q_np is None:
            q_np = np.asarray(queries)
        u = int(unresolved.size)
        # pow2, rounded up to a q-axis multiple (shard_map requires the
        # batch divisible by the mesh's q extent)
        qx = mesh.shape[Q_AXIS]
        up = -(-(1 << (u - 1).bit_length()) // qx) * qx
        sel = np.concatenate(
            [unresolved, np.full(up - u, unresolved[0], np.int64)])
        v2, i2 = sharded_ivfadc_probe(mesh, jnp.asarray(q_np[sel]), bundle,
                                      w=cur_w, k=k)
        vals_np[unresolved] = np.asarray(v2)[:u]
        ids_np[unresolved] = np.asarray(i2)[:u]
    if ids_np is not None:
        return jnp.asarray(vals_np), jnp.asarray(ids_np)
    return vals, ids


def sharded_kmeans_step(mesh: Mesh, x: Array, centroids: Array
                        ) -> tuple[Array, Array]:
    """One data-parallel Lloyd iteration — the framework's training step.

    ``x`` is rows-sharded; centroids are replicated. Per-device assignment
    (local matmul+argmin) then a ``psum`` of per-cluster sums and counts —
    the canonical data-parallel all-reduce shape.
    """
    k = centroids.shape[0]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(ROWS_AXIS), P()),
        out_specs=(P(), P()), check_vma=False)
    def step(x_shard, c):
        a = jnp.argmin(
            jnp.sum(c * c, -1)[None, :]
            - 2.0 * jnp.dot(x_shard, c.T,
                            preferred_element_type=jnp.float32,
                            precision=lax.Precision.HIGHEST), axis=-1)
        sums = jax.ops.segment_sum(x_shard, a, num_segments=k)
        counts = jax.ops.segment_sum(jnp.ones(x_shard.shape[:1],
                                              jnp.float32), a,
                                     num_segments=k)
        sums = lax.psum(sums, ROWS_AXIS)
        counts = lax.psum(counts, ROWS_AXIS)
        new_c = jnp.where(counts[:, None] > 0,
                          sums / jnp.maximum(counts[:, None], 1.0), c)
        return new_c, counts.astype(jnp.int32)

    return step(x, centroids)


def sharded_kmeans(mesh: Mesh, key: Array, x: Array, k: int,
                   iters: int = 10) -> tuple[Array, Array]:
    """Full data-parallel k-means over a rows-sharded table (multi-chip
    ``create_quantizer``). Initialization samples k rows host-side."""
    n = x.shape[0]
    init_idx = jax.random.choice(key, n, shape=(k,), replace=False)
    centroids = replicate(jnp.take(x, init_idx, axis=0).astype(jnp.float32),
                          mesh)
    counts = jnp.zeros((k,), jnp.int32)
    for _ in range(iters):
        centroids, counts = sharded_kmeans_step(mesh, x, centroids)
    return centroids, counts


def pad_rows(x: Array, multiple: int) -> tuple[Array, int]:
    """Pad the leading axis to a multiple (returns padded array and the
    original row count for masking)."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1)), n


def sharded_ivpq_join_round(mesh: Mesh, queries: Array, coarse_cent: Array,
                            codebook_cent: Array, target_codes: Array,
                            target_cells: Array, target_ids: Array,
                            target_mask: Array, statistics: Array,
                            target_vecs: Array, *, k: int, alpha: int,
                            pvf: int = 20, method: int = 0,
                            confidence: float = 0.8
                            ) -> tuple[Array, Array, Array]:
    """Multi-chip IVPQ kNN-join round: targets sharded over "rows", queries
    sharded over "q".

    Each device runs the full fixed-shape join round
    (:func:`postgres_word2vec.models.ivpq._ivpq_round`) against its
    target shard — cell selection is per-query and replicates, the distance
    phase and top-k are local — then k candidates/device merge with one
    ``all_gather`` and the retirement counter reduces with ``psum``.
    Target arrays must be pre-padded to a multiple of the rows axis (pad
    entries masked false). Returns (dists, global ids, retrieved).
    """
    from postgres_word2vec.models import ivpq as ivpq_mod

    t = target_ids.shape[0]
    n_rows = mesh.shape[ROWS_AXIS]
    use_kernel = backend.use_kernels()
    if t % n_rows != 0:
        raise ValueError(f"targets ({t}) not divisible by rows ({n_rows}); "
                         "pad first (see pad_rows)")

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(Q_AXIS), P(), P(), P(ROWS_AXIS), P(ROWS_AXIS),
                  P(ROWS_AXIS), P(ROWS_AXIS), P(), P(ROWS_AXIS)),
        out_specs=(P(Q_AXIS), P(Q_AXIS), P(Q_AXIS)), check_vma=False)
    def run(q, cc, cb, t_codes, t_cells, t_ids, t_mask, stats, t_vecs):
        t_real = lax.psum(jnp.sum(t_mask.astype(jnp.int32)), ROWS_AXIS)
        num_cells = stats.shape[0] - 1
        local_counts = jax.ops.segment_sum(
            t_mask.astype(jnp.float32), t_cells.astype(jnp.int32),
            num_segments=num_cells)
        global_counts = lax.psum(local_counts, ROWS_AXIS)
        # Run the round with shard-LOCAL ids so method 2's post_verify
        # gathers the shard-local (T/shard, d) target block correctly, then
        # map back to global ids (mirrors IVPQIndex._run_round; with global
        # ids jnp.take clamps out-of-range and re-ranks the wrong vectors).
        local_ids = jnp.arange(t_ids.shape[0], dtype=jnp.int32)
        vals, lids, retrieved, _, _ = ivpq_mod._ivpq_round(
            q, cc, cb, t_codes, t_cells, local_ids, t_mask, stats, t_vecs,
            k=k, alpha=alpha, pvf=pvf, method=method,
            confidence=jnp.float32(confidence), use_double=False,
            use_kernel=use_kernel, t_real_override=t_real,
            cell_counts_override=global_counts)
        ids = jnp.where(lids >= 0,
                        jnp.take(t_ids, jnp.maximum(lids, 0)),
                        -1).astype(jnp.int32)
        all_vals = lax.all_gather(vals, ROWS_AXIS, axis=1, tiled=True)
        all_ids = lax.all_gather(ids, ROWS_AXIS, axis=1, tiled=True)
        neg, pos = lax.top_k(-all_vals, k)
        merged_ids = jnp.take_along_axis(all_ids, pos, axis=-1)
        retrieved = lax.psum(retrieved, ROWS_AXIS)
        return -neg, merged_ids, retrieved

    return run(queries, coarse_cent, codebook_cent, target_codes,
               target_cells, target_ids, target_mask, statistics,
               target_vecs)


def sharded_ivpq_join(mesh: Mesh, index, queries: Array, k: int,
                      target_ids: Array, *,
                      target_mask: Array | None = None,
                      vectors: Array | None = None,
                      statistics: Array | None = None,
                      alpha: int = 3, pvf: int = 20, method: int = 0,
                      confidence: float = 0.8,
                      max_rounds: int = 4,
                      impl: str = "dense") -> tuple[Array, Array]:
    """Multi-chip multi-round IVPQ kNN-join: targets sharded over "rows",
    alpha-doubling escalation across rounds (the single-device
    ``IVPQIndex._join_escalate`` loop, ivpq_search_in.c:639-684, over
    :func:`sharded_ivpq_join_round`).

    ``impl="budget"`` probes with the selectivity-proportional tiled layout
    (:func:`sharded_ivpq_join_round_budget`) — per-shard cost tracks each
    query's probed rows; ``"dense"`` scans every shard's full slice and
    masks."""
    from postgres_word2vec.models import ivpq as ivpq_mod

    if target_mask is None:
        target_mask = jnp.ones(target_ids.shape, dtype=bool)
    if statistics is None:
        statistics = ivpq_mod.uniform_statistics(index.coarse.cell_counts)

    if impl == "budget":
        t_vecs = (jnp.take(vectors, jnp.maximum(target_ids, 0), axis=0)
                  if vectors is not None
                  else jnp.zeros((target_ids.shape[0], queries.shape[1]),
                                 jnp.float32))
        bundle = shard_join_tiles(index, target_ids, target_mask, t_vecs,
                                  mesh, with_vecs=method == 1)
        cc = replicate(index.coarse.centroids, mesh)
        cb = replicate(index.codebook.centroids, mesh)
        stats = replicate(statistics, mesh)
        cur_alpha = int(alpha)
        vals, ids, retrieved = sharded_ivpq_join_round_budget(
            mesh, queries, cc, cb, bundle, stats, k=k, alpha=cur_alpha,
            pvf=pvf, method=method, confidence=confidence)
        resolved = retrieved >= k
        for _ in range(max_rounds - 1):
            if bool(jnp.all(resolved)):
                break
            cur_alpha += cur_alpha
            v2, i2, retrieved = sharded_ivpq_join_round_budget(
                mesh, queries, cc, cb, bundle, stats, k=k, alpha=cur_alpha,
                pvf=pvf, method=method, confidence=confidence)
            upd = ~resolved
            vals = jnp.where(upd[:, None], v2, vals)
            ids = jnp.where(upd[:, None], i2, ids)
            resolved = resolved | (retrieved >= k)
        return vals, ids

    rows = mesh.shape[ROWS_AXIS]
    t_safe = jnp.maximum(target_ids, 0)
    t_codes = jnp.take(index.codes, t_safe, axis=0)
    t_cells = jnp.take(index.cell_of, t_safe)
    t_vecs = (jnp.take(vectors, t_safe, axis=0) if vectors is not None
              else jnp.zeros((target_ids.shape[0], queries.shape[1]),
                             jnp.float32))
    pad = (-target_ids.shape[0]) % rows
    if pad:
        target_ids = jnp.pad(target_ids, (0, pad))
        target_mask = jnp.pad(target_mask, (0, pad))
        t_codes = jnp.pad(t_codes, ((0, pad), (0, 0)))
        t_cells = jnp.pad(t_cells, (0, pad))
        t_vecs = jnp.pad(t_vecs, ((0, pad), (0, 0)))
    args = [shard_rows(x, mesh) for x in
            (t_codes, t_cells, target_ids, target_mask, t_vecs)]
    cc = replicate(index.coarse.centroids, mesh)
    cb = replicate(index.codebook.centroids, mesh)
    stats = replicate(statistics, mesh)

    cur_alpha = int(alpha)
    vals, ids, retrieved = sharded_ivpq_join_round(
        mesh, queries, cc, cb, args[0], args[1], args[2], args[3], stats,
        args[4], k=k, alpha=cur_alpha, pvf=pvf, method=method,
        confidence=confidence)
    resolved = retrieved >= k
    for _ in range(max_rounds - 1):
        if bool(jnp.all(resolved)):
            break
        cur_alpha += cur_alpha
        v2, i2, retrieved = sharded_ivpq_join_round(
            mesh, queries, cc, cb, args[0], args[1], args[2], args[3],
            stats, args[4], k=k, alpha=cur_alpha, pvf=pvf, method=method,
            confidence=confidence)
        upd = ~resolved
        vals = jnp.where(upd[:, None], v2, vals)
        ids = jnp.where(upd[:, None], i2, ids)
        resolved = resolved | (retrieved >= k)
    return vals, ids


def shard_join_tiles(index, target_ids: Array, target_mask: Array,
                     target_vecs: Array, mesh: Mesh, *,
                     block_t: int = 128, with_vecs: bool = False) -> dict:
    """Build per-shard cell-aligned join tiles for the budget IVPQ join.

    Targets split into ``rows`` equal contiguous slices (padded, pad rows
    masked); each slice gets its own :class:`models.ivpq.JoinTiles` layout
    (equal static shapes across shards since the slices are equal), and the
    leaves stack on a leading shard axis sharded over "rows" — the join-time
    analog of :func:`shard_ivfadc`'s host-side repack.
    """
    from postgres_word2vec.models import ivpq as ivpq_mod

    n_shards = mesh.shape[ROWS_AXIS]
    t = target_ids.shape[0]
    pad = (-t) % n_shards
    t_safe = jnp.maximum(target_ids, 0)
    t_codes = jnp.take(index.codes, t_safe, axis=0)
    t_cells = jnp.take(index.cell_of, t_safe)
    if pad:
        target_ids = jnp.pad(target_ids, (0, pad))
        target_mask = jnp.pad(target_mask, (0, pad))
        t_codes = jnp.pad(t_codes, ((0, pad), (0, 0)))
        t_cells = jnp.pad(t_cells, (0, pad))
        target_vecs = jnp.pad(target_vecs, ((0, pad), (0, 0)))
    per = (t + pad) // n_shards

    leaves: list = []
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        jt = ivpq_mod.build_join_tiles(
            t_codes[sl], t_cells[sl], target_mask[sl], target_vecs[sl],
            block_t=block_t, num_cells=index.num_cells, with_vecs=with_vecs)
        leaves.append(jt)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *leaves)

    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P(ROWS_AXIS)))

    na = int(leaves[0].codes.shape[0])
    return {
        "jt": jax.tree.map(put, stacked),
        "t_ids": put(target_ids.reshape(n_shards, per)),
        "t_vecs": put(target_vecs.reshape(n_shards, per, -1)),
        "block_t": block_t,
        "inf_tile": na // block_t - 1,
        "n_tiles": na // block_t,
        "per_shard": per,
    }


def sharded_ivpq_join_round_budget(mesh: Mesh, queries: Array,
                                   coarse_cent: Array, codebook_cent: Array,
                                   bundle: dict, statistics: Array, *,
                                   k: int, alpha: int, pvf: int = 20,
                                   method: int = 0, confidence: float = 0.8,
                                   p_budget: int | None = None
                                   ) -> tuple[Array, Array, Array]:
    """Selectivity-proportional multi-chip IVPQ join round: each shard
    probes only the tiles of each query's selected cells within its target
    slice (``models.ivpq._ivpq_round_budget``), with the probe-prefix
    decision replicated via ``psum``'d GLOBAL cell counts; k candidates per
    shard merge with one all_gather. Cost per shard tracks the shard's
    share of the probed rows instead of its full dense slice
    (:func:`sharded_ivpq_join_round`'s layout).
    """
    from postgres_word2vec.models import ivpq as ivpq_mod

    block_t = bundle["block_t"]
    n_rows = mesh.shape[ROWS_AXIS]
    if p_budget is None:
        want = max(8, (2 * k * alpha) // (block_t * n_rows) + 4)
        p_budget = min(1 << int(np.ceil(np.log2(want))),
                       max(bundle["n_tiles"] - 1, 1))
    use_kernel = backend.use_kernels()

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(Q_AXIS), P(), P(),
                  jax.tree.map(lambda _: P(ROWS_AXIS), bundle["jt"]),
                  P(ROWS_AXIS), P(ROWS_AXIS), P()),
        out_specs=(P(Q_AXIS), P(Q_AXIS), P(Q_AXIS)), check_vma=False)
    def run(q, cc, cb, jt_stack, t_ids, t_vecs, stats):
        jt = jax.tree.map(lambda x: x[0], jt_stack)
        # restore the static ints the stacking turned into arrays
        jt = jt._replace(block_t=block_t, inf_tile=bundle["inf_tile"])
        t_real = lax.psum(jt.t_real, ROWS_AXIS)
        global_counts = lax.psum(jt.cell_sizes, ROWS_AXIS)
        vals, lids, found, _, _ = ivpq_mod._ivpq_round_budget(
            q, cc, cb, jt, t_vecs[0], stats, k, alpha, pvf, method,
            jnp.float32(confidence), use_double=False, p_budget=p_budget,
            block_t=block_t, use_kernel=use_kernel,
            t_real_override=t_real, cell_counts_override=global_counts)
        ids = jnp.where(lids >= 0,
                        jnp.take(t_ids[0], jnp.maximum(lids, 0)),
                        -1).astype(jnp.int32)
        all_vals = lax.all_gather(vals, ROWS_AXIS, axis=1, tiled=True)
        all_ids = lax.all_gather(ids, ROWS_AXIS, axis=1, tiled=True)
        neg, pos = lax.top_k(-all_vals, k)
        merged_ids = jnp.take_along_axis(all_ids, pos, axis=-1)
        return -neg, merged_ids, lax.psum(found, ROWS_AXIS)

    return run(queries, coarse_cent, codebook_cent, bundle["jt"],
               bundle["t_ids"], bundle["t_vecs"], statistics)


def shard_ivfadc(index, mesh: Mesh):
    """Partition an IVFADCIndex's inverted lists across the rows axis.

    Cells are split into ``rows`` contiguous ranges with roughly equal row
    counts; each shard's code rows are repacked locally (padded to the
    largest shard) while row ids stay global. Returns the array bundle for
    :func:`sharded_ivfadc_probe`.
    """
    index = index.flush()  # fold any pending insert tail into the CSR
    n_shards = mesh.shape[ROWS_AXIS]
    offsets = np.asarray(index.cell_offsets)
    n_cells = index.num_cells
    total = offsets[-1]
    # greedy contiguous split at ~equal row counts
    bounds = [0]
    for s in range(1, n_shards):
        target = total * s // n_shards
        bounds.append(int(np.searchsorted(offsets, target)))
    bounds.append(n_cells)
    starts = np.asarray(bounds[:-1], np.int32)
    ends = np.asarray(bounds[1:], np.int32)

    row_lo = offsets[starts]
    row_hi = offsets[ends]
    max_rows = int((row_hi - row_lo).max()) if n_shards else 0
    max_rows = max(max_rows, 1)

    codes = np.asarray(index.codes_sorted)
    rids = np.asarray(index.row_ids)
    m = codes.shape[1]
    codes_sh = np.zeros((n_shards, max_rows, m), codes.dtype)
    rids_sh = np.full((n_shards, max_rows), -1, np.int32)
    offs_sh = np.zeros((n_shards, n_cells + 1), np.int32)
    for s in range(n_shards):
        lo, hi = row_lo[s], row_hi[s]
        codes_sh[s, :hi - lo] = codes[lo:hi]
        rids_sh[s, :hi - lo] = rids[lo:hi]
        # local offsets valid for owned cells; clamp others to the shard
        offs_sh[s] = np.clip(offsets - lo, 0, hi - lo)

    return {
        "codes": shard_rows(jnp.asarray(codes_sh), mesh),
        "row_ids": shard_rows(jnp.asarray(rids_sh), mesh),
        "offsets": shard_rows(jnp.asarray(offs_sh), mesh),
        "cell_start": shard_rows(jnp.asarray(starts.reshape(-1, 1)), mesh),
        "cell_end": shard_rows(jnp.asarray(ends.reshape(-1, 1)), mesh),
        "coarse": replicate(index.coarse.centroids, mesh),
        "codebook": replicate(index.codebook.centroids, mesh),
        "list_cap": int(np.diff(offsets).max() or 1),
    }


def sharded_ivfadc_probe(mesh: Mesh, queries: Array, bundle: dict, *,
                         w: int, k: int,
                         list_cap: int | None = None
                         ) -> tuple[Array, Array]:
    """Multi-chip IVFADC probe: inverted lists sharded over "rows", queries
    over "q". Every device scores all coarse cells (replicated centroids),
    gathers windows only for the probed cells it owns, ADC-scans them, and
    the per-shard top-k merges with one all_gather.
    """
    from postgres_word2vec.models.ivfadc import grouped_adc_distances
    from postgres_word2vec.ops import kmeans as km
    from postgres_word2vec.ops import lut as lut_mod

    cap = bundle["list_cap"] if list_cap is None else list_cap

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(Q_AXIS), P(ROWS_AXIS), P(ROWS_AXIS), P(ROWS_AXIS),
                  P(ROWS_AXIS), P(ROWS_AXIS), P(), P()),
        out_specs=(P(Q_AXIS), P(Q_AXIS)), check_vma=False)
    def run(q, codes_sh, rids_sh, offs_sh, c_start, c_end, coarse, cbook):
        codes_loc = codes_sh[0]                     # (max_rows, m)
        rids_loc = rids_sh[0]
        offs_loc = offs_sh[0]                       # (C+1,)
        start, end = c_start[0, 0], c_end[0, 0]
        B, d = q.shape

        cd = km.pairwise_sqdist(q, coarse)
        _, cells = topk_ops.top_k_smallest(cd, w)   # (B, w) global cells
        owned = (cells >= start) & (cells < end)

        resid = q[:, None, :] - jnp.take(coarse, cells, axis=0)
        luts = lut_mod.build_luts(resid.reshape(B * w, d), cbook)
        luts = luts.reshape(B, w, *luts.shape[1:])

        starts_ = jnp.take(offs_loc, cells)
        ends_ = jnp.take(offs_loc, cells + 1)
        lane = jnp.arange(cap)
        pos = starts_[..., None] + lane
        valid = (pos < ends_[..., None]) & owned[..., None]
        pos_c = jnp.minimum(pos, codes_loc.shape[0] - 1)
        cand = jnp.take(codes_loc, pos_c, axis=0)

        dists = grouped_adc_distances(luts, cand)
        dists = jnp.where(valid, dists, jnp.inf)
        flat = dists.reshape(B, w * cap)
        vals, fpos = topk_ops.top_k_smallest(flat, min(k, w * cap))
        gpos = jnp.take_along_axis(pos_c.reshape(B, w * cap), fpos, axis=-1)
        ids = jnp.where(jnp.isfinite(vals), jnp.take(rids_loc, gpos), -1)

        all_vals = lax.all_gather(vals, ROWS_AXIS, axis=1, tiled=True)
        all_ids = lax.all_gather(ids.astype(jnp.int32), ROWS_AXIS, axis=1,
                                 tiled=True)
        neg, sel = lax.top_k(-all_vals, k)
        return -neg, jnp.take_along_axis(all_ids, sel, axis=-1)

    return run(queries, bundle["codes"], bundle["row_ids"],
               bundle["offsets"], bundle["cell_start"], bundle["cell_end"],
               bundle["coarse"], bundle["codebook"])

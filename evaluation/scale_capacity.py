#!/usr/bin/env python3
"""Single-card capacity experiment: 10M x 300-d on one GPU.

The reference's headline dataset is 3M x 300 (GoogleNews,
/root/reference/README.md:151-156), bounded by Postgres shared buffers and
per-query SPI streaming. This experiment shows this build's headroom on
ONE card: a 10.24M-row corpus fully device-resident (bf16 table 6.1 GiB +
uint8 PQ codes 0.12 GiB), exact and PQ search measured at production batch
sizes.

Memory design (HBM is the binding constraint):
- vectors are generated in f32 CHUNKS (independent `generate_wordlike`
  shards), norms taken in f32, then cast to bf16 — no full-size f32 table
  ever exists on device;
- `ExactIndex` is bypassed (its constructor materializes an f32 copy for
  norms); `exact_top_k_precast` consumes the pre-cast table directly;
- PQ scans take the binned Triton scan (per-bin minima only) unless
  ``--exact-scan`` asks for the chunked exact top-k.

Usage: python evaluation/scale_capacity.py [--n 10240000] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np



from postgres_word2vec.evaluation.benchutil import (
    host_exact_topk, log, log_mem, recall_at_k, timeit)


def _build_quality_from_host(host_parts, n, chunk, m=60, kk=16):
    """OPQ × 4-bit quality build with NO resident table: train on a host
    subset, encode 320k-row device transients, codes stay host-side, and
    only the subspace-major scan copy (586 MiB) lands on the device.
    Numerically identical to ``PQIndex.build(m=60, k=16, opq_iters=10,
    iters=25, init='kmeans++', train_size=100_000)`` modulo the training
    sample (first 100k rows instead of a uniform draw — the synthetic
    chunks are i.i.d. by construction, PRNGKey per chunk)."""
    import jax
    import jax.numpy as jnp

    from postgres_word2vec.models.pq import (PQCodebook, PQIndex,
                                                 train_opq_rotation)
    from postgres_word2vec.ops import kmeans

    train = jnp.asarray(host_parts[0][:100_000].astype(np.float32))
    rot, cb = train_opq_rotation(jax.random.PRNGKey(7), train, m, kk,
                                 opq_iters=10, kmeans_iters=6)
    del train
    codes_host = np.empty((n, m), np.uint8)
    pos = 0
    sub = 320_000
    for hp in host_parts:
        for s in range(0, hp.shape[0], sub):
            piece = jnp.asarray(hp[s:s + sub].astype(np.float32))
            c = kmeans.encode_subspaces(piece, cb.centroids, rotation=rot)
            codes_host[pos:pos + piece.shape[0]] = np.asarray(c)
            pos += int(piece.shape[0])
            del piece, c
    counts = np.stack([np.bincount(codes_host[:, j], minlength=kk)
                       for j in range(m)]).astype(np.int32)
    return PQIndex(PQCodebook(cb.centroids, jnp.asarray(counts)),
                   jnp.asarray(codes_host), rotation=rot)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_240_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=1_280_000)
    ap.add_argument("--eval-q", type=int, default=256)
    ap.add_argument("--pq", default="reference",
                    choices=("reference", "quality"),
                    help="PQ regime: reference=12x256 uint8; quality="
                         "OPQ x 4-bit 60x16 (the best measured operating "
                         "point at 3M)")
    ap.add_argument("--pvf", default="20",
                    help="comma-separated pvf sweep for the PV point")
    ap.add_argument("--exact-scan", action="store_true",
                    help="exact chunked PQ top-k instead of the binned "
                         "scan")
    ap.add_argument("--skip-exact", action="store_true",
                    help="skip the exact batch scan (regime-independent; "
                         "required for --pq quality, whose 586 MiB codes "
                         "leave no HBM headroom for the scan transient)")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "reports",
        "scale_10M.json"))
    args = ap.parse_args()

    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()

    from postgres_word2vec.evaluation import synth
    from postgres_word2vec.models.exact import exact_top_k_precast
    from postgres_word2vec.models.pq import PQIndex

    N, D = args.n, args.d
    log(f"scale_capacity: N={N} D={D} devices={jax.devices()}")
    results = {"n": N, "d": D}

    # ---------------------------------------------- chunked generation
    # Table assembly is a DONATED dynamic_update_slice per chunk, not a
    # jnp.concatenate of all chunks: concatenate holds every chunk AND the
    # result simultaneously (11.4 GiB transient at 10M bf16), and the
    # fragmentation it leaves behind made even a (1024, 300) device_put
    # RESOURCE_EXHAUST later in the quality regime (OPQ x 4-bit, 586 MiB
    # codes; /tmp/bl7_scale10m.log r4). Donation caps the peak at
    # table + one chunk.
    import functools as _functools
    from jax import lax as _lax

    @_functools.partial(jax.jit, donate_argnums=(0,))
    def _write_chunk(tbl, chunk, start):
        return _lax.dynamic_update_slice(tbl, chunk, (start, 0))

    # The QUALITY regime (60×16, 586 MiB codes vs the reference regime's
    # 117 MiB) does not fit this chip with the table allocated first:
    # four runs RESOURCE_EXHAUSTED at whichever allocation followed
    # table+codes residency — the exact-scan transient, the on-device
    # transpose, a whole-array device_get, even a 60 MB slice
    # (/tmp/scale10M_quality.log history). So the quality path inverts
    # the order: generate to HOST, train+encode chunkwise with no table
    # resident, keep row-major codes host-side (the scan/PV phases read
    # only the subspace-major copy), and assemble the 5.72 GiB table
    # LAST as one block into a near-empty allocator.
    assemble_now = args.pq == "reference"
    t0 = time.perf_counter()
    n_chunks = -(-N // args.chunk)
    table = jnp.zeros((N, D), jnp.bfloat16) if assemble_now else None
    norm_parts, host_parts = [], []
    for i in range(n_chunks):
        rows = min(args.chunk, N - i * args.chunk)
        vf = synth.generate_wordlike(jax.random.PRNGKey(1000 + i), rows, D)
        norm_parts.append(
            np.asarray(jnp.sum(vf.astype(jnp.float32) ** 2, axis=-1)))
        vb = vf.astype(jnp.bfloat16)
        # one host pull per chunk: the ground-truth pass runs on HOST
        # numpy (below), so GT takes no device memory next to the
        # resident set.
        host_parts.append(np.asarray(vb))
        if assemble_now:
            table = _write_chunk(table, vb,
                                 jnp.int32(i * args.chunk))
        del vf, vb
    norms = jnp.asarray(np.concatenate(norm_parts))
    del norm_parts
    jax.block_until_ready(norms)
    log(f"generated in {time.perf_counter() - t0:.1f}s "
        f"(table {'assembled' if assemble_now else 'deferred'})")
    log_mem("table")

    queries_eval = jnp.asarray(
        host_parts[0][:args.eval_q].astype(np.float32))
    # device timing batches transfer NOW, while the allocator is clean.
    qb_1024 = jnp.asarray(host_parts[0][:1024].astype(np.float32))
    qb_64 = qb_1024[:64]
    jax.block_until_ready(qb_64)

    # PQ builds BEFORE the ground-truth pass.
    t0 = time.perf_counter()
    results["pq_regime"] = args.pq
    if args.pq == "reference":
        pq = PQIndex.build(jax.random.PRNGKey(7), table,
                           train_size=100_000, iters=25, init="kmeans++",
                           m=12, k=256)
    else:
        pq = _build_quality_from_host(host_parts, N, args.chunk)
    log(f"PQ built in {time.perf_counter() - t0:.1f}s "
        f"(codes {pq.codes.nbytes / 2**20:.0f} MiB {pq.codes.dtype})")
    log_mem("pq")

    if table is None:
        t0 = time.perf_counter()
        table = jnp.zeros((N, D), jnp.bfloat16)
        for i, hp in enumerate(host_parts):
            table = _write_chunk(table, jnp.asarray(hp),
                                 jnp.int32(i * args.chunk))
        jax.block_until_ready(table)
        log(f"table assembled in {time.perf_counter() - t0:.1f}s "
            f"({table.nbytes / 2**30:.2f} GiB bf16)")
        log_mem("table_late")

    # -------------------------------------- exact ground truth, ON HOST
    # numpy f32 gemm over the bf16-rounded chunks (identical rounding to
    # the device table; f32 accumulation matches the device matmul).
    # 256 q x 10.24M x 300 = 1.6 TFLOP, ~1 min of single-core BLAS —
    # and zero device allocations, which the post-build allocator state
    # cannot provide (see generation loop note).
    t0 = time.perf_counter()
    q_host = host_parts[0][:args.eval_q].astype(np.float32)
    _, gt10 = host_exact_topk(q_host, host_parts, 10)
    gt5 = gt10[:, :5]
    del host_parts
    log(f"ground truth (host) in {time.perf_counter() - t0:.1f}s")

    # Strided-bin recall hazard, quantified (CLAUDE.md; VERDICT r2 item
    # 9): the binned kernel keeps ONE survivor per strided bin — bin key
    # (row // block_n, row % bins) with block_n=2048, bins=128 — so two
    # true neighbors whose row ids collide lose one candidate before
    # top-k. Count colliding ground-truth pairs per query.
    keys = (gt10 // 2048) * 128 + (gt10 % 128)          # (Q, 10)
    collisions = sum(
        int(len(row) - len(set(row.tolist()))) for row in keys)
    results["bin_collision"] = dict(
        colliding_gt10_pairs=collisions,
        rate=collisions / gt10.size,
        note="gt@10 neighbors sharing a (tile, strided-bin) slot of the "
             "binned kernel (block_n=2048, bins=128) — each collision "
             "caps binned-scan recall@10 by one candidate")
    log(f"[bin_collision] {collisions} / {gt10.size} "
        f"({collisions / gt10.size:.4f})")

    # --------------------------------------------------- exact batch scan
    # Chunk the scan at 256k rows: the transient stays at ~1 GiB for <2%
    # extra top-k merge cost.
    #
    # The quality regime (60×16 codes, 586 MiB vs 120 MiB) still OOMs
    # here even at 256k chunks — and the exact scan does not depend on
    # the PQ regime at all, so the quality run skips it and defers to
    # the reference-regime run.
    if args.skip_exact:
        log("[exact_batch] skipped (--skip-exact; regime-independent, "
            "see the reference-regime run)")
        results["exact_batch"] = dict(
            skipped=True, note="regime-independent; measured in the "
            "reference-regime run (scale_10M_reference.json)")
    else:
        B = 1024
        qb = qb_1024
        exact_kw = dict(chunk_size=262_144, approx=True)
        t, _ = timeit(lambda q: exact_top_k_precast(q, table, norms, 10,
                                                    **exact_kw), qb)
        _, ids = exact_top_k_precast(queries_eval, table, norms, 10,
                                     **exact_kw)
        _, ids5 = exact_top_k_precast(queries_eval, table, norms, 5,
                                      **exact_kw)
        results["exact_batch"] = dict(
            per_query_ms=t / B * 1e3, batch=B,
            recall=recall_at_k(ids, gt10), recall5=recall_at_k(ids5, gt5),
            note="bf16 table + approx_max_k, one chip, 10M rows")
        log(f"[exact_batch] "
            f"{results['exact_batch']['per_query_ms']:.4g} ms/q "
            f"recall@10={results['exact_batch']['recall']:.3f}")
        log_mem("exact")

    B = 64
    qb64 = qb_64
    approx = not args.exact_scan
    shortlist = "exact" if args.exact_scan else "approx"
    t, _ = timeit(lambda q: pq.search(q, 10, approx=approx), qb64)
    _, ids = pq.search(queries_eval, 10, approx=approx)
    _, ids5 = pq.search(queries_eval, 5, approx=approx)
    results["pq_scan"] = dict(
        per_query_ms=t / B * 1e3, batch=B,
        recall=recall_at_k(ids, gt10), recall5=recall_at_k(ids5, gt5),
        note="Triton ADC scan over 10M uint8 codes")
    log(f"[pq_scan] {results['pq_scan']['per_query_ms']:.4g} ms/q "
        f"recall@10={results['pq_scan']['recall']:.3f}")

    for pvf in [int(x) for x in args.pvf.split(",")]:
        t, _ = timeit(lambda q, pvf=pvf: pq.search_pv(
            q, 10, pvf, table, shortlist=shortlist), qb64)
        _, ids = pq.search_pv(queries_eval, 10, pvf, table,
                              shortlist=shortlist)
        _, ids5 = pq.search_pv(queries_eval, 5, pvf, table,
                               shortlist=shortlist)
        results[f"pq_pv_{pvf}"] = dict(
            per_query_ms=t / B * 1e3, batch=B,
            recall=recall_at_k(ids, gt10), recall5=recall_at_k(ids5, gt5),
            note=f"ADC + exact re-rank pvf={pvf} against the bf16 table")
        log(f"[pq_pv_{pvf}] "
            f"{results[f'pq_pv_{pvf}']['per_query_ms']:.4g} ms/q "
            f"recall@10={results[f'pq_pv_{pvf}']['recall']:.3f}")
    log_mem("pq_pv")

    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))


if __name__ == "__main__":
    main()

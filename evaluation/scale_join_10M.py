#!/usr/bin/env python3
"""Capacity-scale kNN-join: 5k queries joined against a 10.24M-row target
set on one GPU — the selectivity regime ``ivpq_search_in`` exists for
(/root/reference/freddy_extension/ivpq_search_in.c:355-401: fetch only the
probed cells so cost scales with selectivity, not |T|).

At this scale the f32 table (12.3 GiB) cannot exist on the chip at all, so
the honest exact comparator is the bf16 production scan (recall ~0.99 vs
f32); the IVPQ probe runs codes-resident — uint8 codes + coarse structure
+ the bf16 table aliased for post-verification (no second vector copy:
``prepare_join(vecs_pregathered=True)``).

Memory discipline follows evaluation/scale_capacity.py: chunked host
generation, donated table assembly, IVPQ build before the ground-truth
pass, ground truth on HOST numpy (the post-build allocator cannot satisfy
large fresh device allocations, see scale_capacity.py notes).

Usage: python evaluation/scale_join_10M.py [--n 10240000] [--nq 5000]
       [--out chiprun_out/scale_join_10M.json]
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
    host_exact_topk, log, log_mem, recall_at_k)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_240_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=1_024_000)
    ap.add_argument("--nq", type=int, default=5000,
                    help="timed query-batch size")
    ap.add_argument("--eval-q", type=int, default=256,
                    help="queries scored against host ground truth")
    ap.add_argument("--alphas", default="600,1200,2400,4800")
    # 10M rows need a finer coarse grid than the 3M bench's 1024 cells:
    # at 1024 cells a cell holds ~10k rows, so an alpha-bounded probe
    # reaches only 1-2 cells and recall@5 collapses; 4096 cells restore
    # the ~2.5k rows/cell granularity the 3M operating points have.
    ap.add_argument("--k-coarse", type=int, default=4096)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "reports",
        "scale_join_10M.json"))
    args = ap.parse_args()

    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()

    from postgres_word2vec.evaluation import synth
    from postgres_word2vec.models.exact import exact_top_k_precast
    from postgres_word2vec.models.ivpq import (IVPQIndex,
                                                   build_statistics)

    N, D, NQ = args.n, args.d, args.nq
    log(f"scale_join: N={N} D={D} nq={NQ} devices={jax.devices()}")
    results: dict = {"n": N, "d": D, "nq": NQ, "k": 5,
                     "ivpq": {"m": 30, "k": 32, "k_coarse": args.k_coarse}}

    # ---------------------------------------------- chunked generation
    import functools as _functools
    from jax import lax as _lax

    @_functools.partial(jax.jit, donate_argnums=(0,))
    def _write_chunk(tbl, chunk, start):
        return _lax.dynamic_update_slice(tbl, chunk, (start, 0))

    t0 = time.perf_counter()
    n_chunks = -(-N // args.chunk)
    table = jnp.zeros((N, D), jnp.bfloat16)
    norm_parts, host_parts = [], []
    for i in range(n_chunks):
        rows = min(args.chunk, N - i * args.chunk)
        vf = synth.generate_wordlike(jax.random.PRNGKey(1000 + i), rows, D)
        norm_parts.append(
            np.asarray(jnp.sum(vf.astype(jnp.float32) ** 2, axis=-1)))
        vb = vf.astype(jnp.bfloat16)
        host_parts.append(np.asarray(vb))
        table = _write_chunk(table, vb, jnp.int32(i * args.chunk))
        del vf, vb
    norms = jnp.asarray(np.concatenate(norm_parts))
    del norm_parts
    jax.block_until_ready(norms)
    log(f"generated in {time.perf_counter() - t0:.1f}s")
    log_mem("table")

    # queries: tail rows of the store (they are also targets — the
    # whole-store join includes self matches, same protocol as bench.py's
    # 3M crossover row)
    q_host = np.concatenate(
        [p for p in host_parts[-(1 + (NQ - 1) // args.chunk):]]
    )[-NQ:].astype(np.float32)
    qv = jnp.asarray(q_host)
    jax.block_until_ready(qv)

    # ------------------------------------------- IVPQ build (before GT)
    t0 = time.perf_counter()
    ivpq = IVPQIndex.build(jax.random.PRNGKey(3), table, m=30, k=32,
                           k_coarse=args.k_coarse, coarse_positions=1,
                           train_size=100_000, iters=25, init="kmeans++")
    jax.block_until_ready(ivpq.codes)
    log(f"IVPQ built in {time.perf_counter() - t0:.1f}s "
        f"(codes {ivpq.codes.nbytes / 2**20:.0f} MiB)")
    log_mem("ivpq")

    # -------------------------------------- exact ground truth, ON HOST
    t0 = time.perf_counter()
    _, gt10 = host_exact_topk(q_host[:args.eval_q], host_parts, 10)
    gt5 = np.asarray(gt10)[:, :5]
    del host_parts
    log(f"ground truth (host) in {time.perf_counter() - t0:.1f}s")

    # ------------------------------------------- exact bf16 scan baseline
    # 256k-row chunks: the (512, 1M) f32 score buffer next to the 6.1 GiB
    # resident table RESOURCE_EXHAUSTs (scale_capacity.py measured the
    # same at 10M).
    def ex_run(qb):
        return exact_top_k_precast(qb, table, norms, 5,
                                   chunk_size=262_144)

    _, ie = ex_run(qv[:512])
    np.asarray(ie[..., :1])
    if NQ % 512:
        _, ie = ex_run(qv[:NQ % 512])
        np.asarray(ie[..., :1])
    ex_trials = []
    for _ in range(3):   # median of 3, same protocol as the join rows
        t0 = time.perf_counter()
        for s in range(0, NQ, 512):
            _, ie = ex_run(qv[s:s + 512])
        np.asarray(ie[..., :1])
        ex_trials.append(time.perf_counter() - t0)
    ex_s = float(np.median(ex_trials))
    _, ie = ex_run(qv[:args.eval_q])
    results["exact_bf16"] = {
        "total_s": ex_s, "trials_s": [round(t, 4) for t in ex_trials],
        "qps": NQ / ex_s,
        "recall5": recall_at_k(np.asarray(ie), gt5),
        "note": "bf16 production scan (the only exact possible at 10M — "
                "the f32 table would be 12.3 GiB)"}
    log(f"[exact_bf16] {ex_s:.3f}s qps={NQ / ex_s:.0f} "
        f"recall@5={results['exact_bf16']['recall5']:.3f}")
    log_mem("exact")

    # -------------------------------------------------- prepared IVPQ join
    tgt = jnp.arange(N, dtype=jnp.int32)
    stats = build_statistics(ivpq.cell_of, tgt, ivpq.num_cells)
    t0 = time.perf_counter()
    ph = ivpq.prepare_join(tgt, vectors=table, vecs_pregathered=True)
    prep_s = time.perf_counter() - t0
    results["prepare_join"] = {"build_s": prep_s}
    log(f"prepare_join(10M) in {prep_s:.3f}s")
    log_mem("prepared")

    for a in (int(x) for x in args.alphas.split(",")):
        kw = dict(prepared=ph, statistics=stats, alpha=a, method=2,
                  confidence=0.8, pvf=20, impl="budget")
        dd, ii = ivpq.search_join(qv, 5, **kw)          # warm
        np.asarray(ii[..., :1])
        trials = []
        for _ in range(3):   # median of 3 (bench.py join protocol)
            t0 = time.perf_counter()
            dd, ii = ivpq.search_join(qv, 5, **kw)
            np.asarray(ii[..., :1])
            trials.append(time.perf_counter() - t0)
        j_s = float(np.median(trials))
        _, i2, info = ivpq.search_join(qv[:args.eval_q], 5,
                                       return_info=True, **kw)
        results[f"ivpq_join_pv_a{a}"] = {
            "total_s": j_s, "trials_s": [round(t, 4) for t in trials],
            "qps": NQ / j_s,
            "recall5": recall_at_k(np.asarray(i2), gt5),
            "scanned_rows_mean": float(np.asarray(info["retrieved"]).mean()),
            "rounds": int(np.asarray(info["rounds"]).max()),
            "alpha": a, "method": 2, "pvf": 20}
        r = results[f"ivpq_join_pv_a{a}"]
        log(f"[ivpq_join_pv_a{a}] {j_s:.3f}s qps={r['qps']:.0f} "
            f"recall@5={r['recall5']:.3f} scanned~{r['scanned_rows_mean']:.0f}")

    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()

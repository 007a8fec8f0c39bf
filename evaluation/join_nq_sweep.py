#!/usr/bin/env python3
"""kNN-join query-batch-size sweep at 3M targets: probe vs exact.

The committed crossover rows (bench.py, 5k queries) are maximally
favorable to brute force: one full-table read amortizes over all 5k
queries. The reference's actual serving pattern — interactive joins of
modest query sets against a statistics-table domain
(/root/reference/freddy_extension/ivpq_search_in.c:355-401, cost is meant
to scale with selectivity) — issues far smaller batches, where the exact
scan still pays the entire table read but the probe pays only
alpha-scanned rows per query. This sweep measures both sides at
nq = 64..4096 against the whole 3M store (prepared-tile handle, same
protocol as bench.py's 3M crossover rows: warm shapes, median of trials,
recall@5 on 256 eval queries vs an f32 ground truth).

Comparators per nq:
- exact f32 full scan (recall 1.0) — the knn_in_exact baseline;
- exact bf16 precast scan (recall ~0.99) — the production scan, the
  strongest honest brute-force opponent on this chip;
- IVPQ probe, method 2 (ADC + post-verify), prepared targets, over an
  alpha ladder.

Usage: python evaluation/join_nq_sweep.py [--n 3072000]
       [--nqs 64,256,1024,4096] [--alphas 600,1200,2400]
       [--out chiprun_out/join_nq_sweep_3M.json]
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



def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3_072_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--nqs", default="64,256,1024,4096")
    ap.add_argument("--alphas", default="600,1200,2400")
    ap.add_argument("--pvf", type=int, default=20)
    ap.add_argument("--eval-q", type=int, default=256)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "reports",
        "join_nq_sweep_3M.json"))
    args = ap.parse_args()

    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()

    from postgres_word2vec.evaluation import synth
    from postgres_word2vec.evaluation.benchutil import (log, log_mem,
                                                            recall_at_k)
    from postgres_word2vec.models.exact import (exact_top_k,
                                                    exact_top_k_precast)
    from postgres_word2vec.models.ivpq import (IVPQIndex,
                                                   build_statistics)

    N, D = args.n, args.d
    nqs = [int(x) for x in args.nqs.split(",")]
    alphas = [int(x) for x in args.alphas.split(",")]
    max_nq = max(nqs)
    log(f"join_nq_sweep: N={N} D={D} nqs={nqs} devices={jax.devices()}")

    t0 = time.perf_counter()
    V = synth.generate_wordlike(jax.random.PRNGKey(0), N, D)  # == bench.py
    np.asarray(V[0, 0])
    log(f"data generated in {time.perf_counter() - t0:.1f}s")

    # queries: tail rows (they are also targets — whole-store join with
    # self matches, same protocol as bench.py's 3M crossover rows)
    qv = V[N - max_nq:]
    qv_host = np.array(np.asarray(qv))

    # bf16 production-scan comparator state
    V_bf = V.astype(jnp.bfloat16)
    norms = jnp.sum(V.astype(jnp.float32) ** 2, axis=-1)
    jax.block_until_ready(norms)
    log_mem("tables")

    t0 = time.perf_counter()
    ivpq = IVPQIndex.build(jax.random.PRNGKey(3), V, m=30, k=32,
                           k_coarse=1024, coarse_positions=1,
                           train_size=100_000, iters=25, init="kmeans++")
    jax.block_until_ready(ivpq.codes)
    log(f"IVPQ (flat 1024) built in {time.perf_counter() - t0:.1f}s")

    tgt = jnp.arange(N, dtype=jnp.int32)
    stats = build_statistics(ivpq.cell_of, tgt, ivpq.num_cells)
    t0 = time.perf_counter()
    ph = ivpq.prepare_join(tgt, vectors=V, vecs_pregathered=True)
    prep_s = time.perf_counter() - t0
    log(f"prepare_join({N}) in {prep_s:.1f}s")
    log_mem("prepared")

    eq = min(args.eval_q, max_nq)
    _, gt = exact_top_k(qv[:eq], V, 5, chunk_size=524288)
    gt = np.asarray(gt)
    log("ground truth done")

    results: dict = {"n": N, "d": D, "nqs": nqs, "k": 5, "pvf": args.pvf,
                     "prepare_join_s": prep_s,
                     "ivpq": {"m": 30, "k": 32, "k_coarse": 1024},
                     "sweep": {}}

    def timed(fn, qb, trials):
        # warm (shape compile + cache), then median of trials; time by
        # materializing a slice
        _, i = fn(qb)
        np.asarray(i[..., :1])
        ts = []
        for _ in range(trials):
            t0 = time.perf_counter()
            _, i = fn(qb)
            np.asarray(i[..., :1])
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)), ts

    for nq in nqs:
        qb = qv[:nq]
        qb_host = qv_host[:nq]
        row: dict = {}

        # exact comparators chunk QUERIES at 512 host-side (the (B, rows)
        # score transient at B=4096 would be ~8.6 GiB; host slicing avoids
        # the per-start eager-slice jaxpr rebuilds — same protocol as
        # bench.py's exact_join_row)
        def ex_f32(q):
            q = np.asarray(q)
            for s in range(0, len(q), 512):
                d_, i_ = exact_top_k(q[s:s + 512], V, 5, chunk_size=524288)
            return d_, i_

        def ex_bf16(q):
            q = np.asarray(q)
            for s in range(0, len(q), 512):
                d_, i_ = exact_top_k_precast(q[s:s + 512], V_bf, norms, 5,
                                             chunk_size=524288)
            return d_, i_

        for name, fn in (("exact_f32", ex_f32), ("exact_bf16", ex_bf16)):
            med, ts = timed(fn, qb_host, args.trials)
            _, ie = fn(qv[:eq])
            row[name] = {"total_s": med, "trials_s": [round(t, 4) for t in ts],
                         "qps": nq / med,
                         "recall5": recall_at_k(np.asarray(ie), gt)}
            log(f"[nq={nq} {name}] {med:.4f}s qps={nq / med:.0f} "
                f"recall@5={row[name]['recall5']:.3f}")

        for a in alphas:
            def probe(q, a=a):
                d_, i_ = ivpq.search_join(
                    q, 5, prepared=ph, statistics=stats, alpha=a,
                    method=2, confidence=0.8, pvf=args.pvf,
                    query_chunk=min(nq, 512))
                return d_, i_
            med, ts = timed(probe, qb, args.trials)
            _, ie = probe(qv[:eq])
            key = f"ivpq_pv_a{a}"
            row[key] = {"total_s": med, "trials_s": [round(t, 4) for t in ts],
                        "qps": nq / med,
                        "recall5": recall_at_k(np.asarray(ie), gt)}
            log(f"[nq={nq} {key}] {med:.4f}s qps={nq / med:.0f} "
                f"recall@5={row[key]['recall5']:.3f}")

        results["sweep"][str(nq)] = row

    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"out": out, "nqs": nqs}))


if __name__ == "__main__":
    main()

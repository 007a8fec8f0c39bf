#!/usr/bin/env python3
"""Diagnose the round-2 IVPQ join anomaly: method=0 (ADC only) measured
6.5× slower than method=2 (ADC + PV) at identical alpha/scanned rows
(VERDICT r2 weak #2) — impossible if per-round work dominates, since both
methods run the same budget probe kernel and differ only in the top-k tail.

Hypotheses probed, in isolation:
  a) intrinsic: per-chunk round latency of method 0 vs method 2 (repeated,
     warmed, interleaved A/B so allocator and clock drift cancel);
  b) ordering: the bench timed method 0 immediately after the full-table
     exact-join baseline (known allocator hazard: a large scan slows the
     next phase, bench.py:74); run the 5000-query joins in both orders;
  c) the exact-baseline contamination itself: method-0 join timed right
     after an exact_top_k_in burst vs after a cooldown.

    BENCH_SMALL=1 python evaluation/join_method_diag.py   (307k rows)
    python evaluation/join_method_diag.py                 (3M rows)

Prints one JSON dict; humans read stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np



def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    from postgres_word2vec.evaluation import synth
    from postgres_word2vec.models.exact import exact_top_k_in
    from postgres_word2vec.models.ivpq import (IVPQIndex,
                                                   build_statistics)

    small = bool(int(os.environ.get("BENCH_SMALL", "0")))
    N = 307_200 if small else 3_072_000
    nq, nt = (500, 10_000) if small else (5000, 100_000)
    D, K = 300, 5

    V = synth.generate_wordlike(jax.random.PRNGKey(0), N, D)
    np.asarray(V[0, 0])
    log(f"data {N}x{D} ready")
    t0 = time.perf_counter()
    ivpq = IVPQIndex.build(jax.random.PRNGKey(3), V, m=30, k=32,
                           k_coarse=1024, coarse_positions=1,
                           train_size=100_000, iters=25, init="kmeans++")
    log(f"IVPQ built in {time.perf_counter() - t0:.1f}s")
    tgt = jnp.arange(nt, dtype=jnp.int32)
    qv = V[N - nq:]
    stats = build_statistics(ivpq.cell_of, tgt, ivpq.num_cells)
    out = {}

    def join(method, n=None, chunk=512):
        kw = dict(alpha=200, method=method, confidence=0.8,
                  statistics=stats, query_chunk=chunk)
        if method == 2:
            kw.update(pvf=20, vectors=V)
        q = qv if n is None else qv[:n]
        dd, ii = ivpq.search_join(q, K, tgt, **kw)
        np.asarray(ii[..., :1])

    # ------------------------------------------------ warm both methods
    join(0, n=512)
    join(2, n=512)
    log("warmed")

    # a) interleaved single-chunk A/B: the intrinsic per-round cost.
    reps = 6
    lat = {0: [], 2: []}
    for _ in range(reps):
        for m in (0, 2):
            t0 = time.perf_counter()
            join(m, n=512)
            lat[m].append(time.perf_counter() - t0)
    out["chunk512_method0_ms"] = round(np.median(lat[0]) * 1e3, 2)
    out["chunk512_method2_ms"] = round(np.median(lat[2]) * 1e3, 2)
    log(f"per-chunk median: m0={out['chunk512_method0_ms']}ms "
        f"m2={out['chunk512_method2_ms']}ms")

    # b) full-size joins in both orders.
    for order in ((0, 2), (2, 0)):
        for m in order:
            t0 = time.perf_counter()
            join(m)
            dt = time.perf_counter() - t0
            key = f"full_m{m}_order{order[0]}{order[1]}"
            out[key] = round(dt, 3)
            log(f"{key}: {dt:.3f}s ({nq / dt:.0f} qps)")

    # c) exact-baseline contamination: run the bench's exact_top_k_in burst,
    #    then immediately time method 0 (the bench's exact sequence).
    mask = jnp.ones((nt,), bool)
    _, i = exact_top_k_in(qv[:512], V, tgt, mask, K)
    np.asarray(i[..., :1])
    for s in range(0, nq, 512):
        _, i = exact_top_k_in(qv[s:s + 512], V, tgt, mask, K)
    np.asarray(i[..., :1])
    t0 = time.perf_counter()
    join(0)
    out["full_m0_after_exact"] = round(time.perf_counter() - t0, 3)
    log(f"m0 after exact burst: {out['full_m0_after_exact']}s")

    print(json.dumps(out))


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    main()

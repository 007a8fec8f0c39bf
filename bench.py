#!/usr/bin/env python3
"""Benchmark driver — prints ONE JSON line with the headline metric.

Workload mirrors the reference's published table (README.md:115-123,
BASELINE.md): 3M × 300-d normalized vectors, measured on one GPU.
Data is synthetic (zero-egress environment) from
``evaluation/synth.generate_wordlike`` — CALIBRATED so a
reference-equivalent quantizer scores FREDDY's published operating points
(control experiment: evaluation/recall_ceiling.py).

Recall is reported at k=5 (``recall5``, the reference's precision column)
and k=10 (``recall``, the BASELINE.json metric). Headline: p50 per-query
latency of the fastest batch kNN config whose recall@10 meets the
reference's batchwise IVFADC operating point (recall ≈ 0.35 at 10
ms/query, README.md:121). ``vs_baseline`` = 10 ms / ours (>1 is better).

Timing notes: every measurement materializes a small result slice to
host. This script's restructuring (named cells, device and layer metrics,
failures that fail the run) is the next benchmark change; it is repaired
here only as far as removed kernels force.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from postgres_word2vec.utils.config import init_compile_cache  # noqa: E402

init_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


SMALL = bool(int(os.environ.get("BENCH_SMALL", "0")))
N = 307_200 if SMALL else 3_072_000
D = 300
K = 10
EVAL_Q = 256
BASELINE_MS = 10.0          # FREDDY batchwise IVFADC per-query (README:121)
BASELINE_RECALL = 0.35
BUILD = dict(train_size=100_000, iters=25, init="kmeans++")


from postgres_word2vec.evaluation.benchutil import (
    log, log_mem, recall_at_k, timeit, timeit_piped)


def main():
    from postgres_word2vec.evaluation import synth
    from postgres_word2vec.models.exact import (ExactIndex, exact_top_k,
                                                    exact_top_k_in)
    from postgres_word2vec.models.ivfadc import IVFADCIndex
    from postgres_word2vec.models.pq import PQIndex

    log(f"bench: N={N} D={D} devices={jax.devices()}")
    t0 = time.perf_counter()
    V = synth.generate_wordlike(jax.random.PRNGKey(0), N, D)
    np.asarray(V[0, 0])
    log(f"data generated in {time.perf_counter() - t0:.1f}s")

    queries_eval = V[:EVAL_Q]
    results = {}

    # time the exact paths BEFORE the f32 ground-truth scan.
    exact_rows = {}
    try:
        from postgres_word2vec.evaluation import benchutil as _bu0
        ex = ExactIndex(V, "bfloat16")
        t, _ = timeit(lambda q: ex.search(q, K, approx=False), V[:1])
        tp = timeit_piped(lambda q: ex.search(q, K, approx=False), V[:1])
        exact_rows["exact_single"] = (t, tp)
        B = 1024
        t, _ = timeit(lambda q: ex.search(q, K, approx=True), V[:B])
        # spread captured HERE (these rows time before the GT pass but
        # report after it, so add()'s last-timing hook would misattribute).
        # Pipelined twin: the enqueue-N-block-once number.
        tp = timeit_piped(lambda q: ex.search(q, K, approx=True), V[:B])
        exact_rows["exact_batch"] = (t, B, _bu0.last_timing(), tp)
        ex8 = ExactIndex(V, "int8")
        t, _ = timeit(lambda q: ex8.search(q, K, approx=True), V[:B])
        tp = timeit_piped(lambda q: ex8.search(q, K, approx=True), V[:B])
        exact_rows["exact_int8"] = (t, B, _bu0.last_timing(), tp)
    except Exception as e:  # pragma: no cover
        log(f"exact timing failed: {e!r}")

    # float32 exact ground truth at k=10 and k=5
    t0 = time.perf_counter()
    _, gt10 = exact_top_k(queries_eval, V, 10, chunk_size=524288)
    gt10 = np.asarray(gt10)
    gt5 = gt10[:, :5]  # exact_top_k is sorted ascending
    log(f"ground truth in {time.perf_counter() - t0:.1f}s")

    from postgres_word2vec.evaluation import benchutil as _bu
    _seen_timing = [0]

    def add(name, ids5, ids10, **kw):
        results[name] = dict(recall=recall_at_k(ids10, gt10),
                             recall5=recall_at_k(ids5, gt5), **kw)
        # attach the min..max spread of the timeit() samples behind this
        # config's median (if one ran since the last add) — cross-round
        # comparisons need to separate chip-state variance (±2x on small
        # kernels, R4_REGRESSION_NOTE.md §4) from real regressions.
        info = _bu.last_timing()
        if (info and info["seq"] != _seen_timing[0]
                and "timing_spread_s" not in results[name]):
            _seen_timing[0] = info["seq"]
            results[name]["timing_spread_s"] = [info["min_s"],
                                                info["max_s"]]
        r = results[name]
        log(f"[{name}] {r.get('per_query_ms', r.get('total_s', 0)):.4g} "
            f"recall@10={r['recall']:.3f} recall@5={r['recall5']:.3f}")

    # ---------------------------------------------------------- exact paths
    try:
        t, tp = exact_rows["exact_single"]
        results["exact_single"] = {
            "per_query_ms": t * 1e3, "per_query_ms_pipelined": tp * 1e3,
            "recall": 1.0, "recall5": 1.0,
            "ref_s": 8.79, "note": "exact bf16 full scan, B=1"}

        t, B, sp, tp = exact_rows["exact_batch"]
        _, ids = ex.search(queries_eval, K, approx=True)
        _, ids5 = ex.search(queries_eval, 5, approx=True)
        add("exact_batch", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            per_query_ms_pipelined=tp / B * 1e3,
            timing_spread_s=[sp["min_s"], sp["max_s"]],
            note="exact bf16 + approx_max_k")

        t, B, sp, tp = exact_rows["exact_int8"]
        _, ids = ex8.search(queries_eval, K, approx=True)
        _, ids5 = ex8.search(queries_eval, 5, approx=True)
        add("exact_int8", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            per_query_ms_pipelined=tp / B * 1e3,
            timing_spread_s=[sp["min_s"], sp["max_s"]],
            note="int8 exact mode (6x less HBM, exact f32 norms)")

    except Exception as e:  # pragma: no cover
        log(f"exact bench failed: {e!r}")
    finally:
        # free the bf16/int8 copies before the quantized phases (HBM is the
        # binding constraint at 3M with all index families resident).
        try:
            del ex
        except NameError:
            pass
        try:
            del ex8
        except NameError:
            pass

    log_mem("exact")

    # ------------------------------------------------- PQ paths (k=256)
    try:
        t0 = time.perf_counter()
        pq = PQIndex.build(jax.random.PRNGKey(1), V, m=12, k=256, **BUILD)
        log(f"PQ k=256 built in {time.perf_counter() - t0:.1f}s")

        B = 64
        t, _ = timeit(lambda q: pq.search(q, K), V[:B])
        _, ids = pq.search(queries_eval, K)
        _, ids5 = pq.search(queries_eval, 5)
        add("pq_scan", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=1.06, ref_recall=0.38, note="Triton ADC full scan k=256")

        for pvf in (20, 100):
            t, _ = timeit(lambda q: pq.search_pv(q, K, pvf, V), V[:B])
            _, ids = pq.search_pv(queries_eval, K, pvf, V)
            _, ids5 = pq.search_pv(queries_eval, 5, pvf, V)
            add(f"pq_pv_{pvf}", ids5, ids, per_query_ms=t / B * 1e3,
                batch=B, ref_s=1.29, ref_recall=0.87,
                note=f"Triton ADC + exact re-rank pvf={pvf}")

        # throughput-shaped point: B=256 amortizes the code stream (B=64
        # above is the reference's batch shape).
        B2 = 256
        t, _ = timeit(lambda q: pq.search(q, K), V[:B2])
        _, ids = pq.search(queries_eval, K)
        _, ids5 = pq.search(queries_eval, 5)
        add("pq_scan_b256", ids5, ids, per_query_ms=t / B2 * 1e3, batch=B2,
            ref_s=1.06, ref_recall=0.38,
            note="same kernel at batch 256 (throughput shape)")

        del pq
    except Exception as e:  # pragma: no cover
        log(f"pq bench failed: {e!r}")

    log_mem("pq256")

    # ------------------------------------------- OPQ PQ (rotated basis)
    try:
        t0 = time.perf_counter()
        pq = PQIndex.build(jax.random.PRNGKey(1), V, m=12, k=256,
                           train_size=100_000, iters=25, opq_iters=10)
        log(f"OPQ PQ built in {time.perf_counter() - t0:.1f}s")
        B = 64
        t, _ = timeit(lambda q: pq.search(q, K), V[:B])
        _, ids = pq.search(queries_eval, K)
        _, ids5 = pq.search(queries_eval, 5)
        add("pq_opq_scan", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=1.06, ref_recall=0.38,
            note="OPQ-rotated ADC full scan (framework quantizer edge)")
        t, _ = timeit(lambda q: pq.search_pv(q, K, 20, V), V[:B])
        _, ids = pq.search_pv(queries_eval, K, 20, V)
        _, ids5 = pq.search_pv(queries_eval, 5, 20, V)
        add("pq_opq_pv_20", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=1.29, ref_recall=0.87,
            note="OPQ ADC + exact re-rank pvf=20")
        del pq
    except Exception as e:  # pragma: no cover
        log(f"opq bench failed: {e!r}")

    log_mem("pq_opq")

    # ---------------------- 4-bit PQ (Quick-ADC regime, arXiv:1704.07355)
    # More subquantizers × fewer centroids at similar code budget.
    try:
        t0 = time.perf_counter()
        pq = PQIndex.build(jax.random.PRNGKey(1), V, m=60, k=16, **BUILD)
        log(f"PQ 60x16 built in {time.perf_counter() - t0:.1f}s")
        B = 256
        t, _ = timeit(lambda q: pq.search(q, K), V[:B])
        _, ids = pq.search(queries_eval, K)
        _, ids5 = pq.search(queries_eval, 5)
        add("pq4bit_scan", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=1.06, ref_recall=0.38,
            note="60x16 4-bit codes, Triton ADC scan")
        t, _ = timeit(lambda q: pq.search_pv(q, K, 20, V), V[:B])
        _, ids = pq.search_pv(queries_eval, K, 20, V)
        _, ids5 = pq.search_pv(queries_eval, 5, 20, V)
        add("pq4bit_pv_20", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=1.29, ref_recall=0.87,
            note="60x16 ADC + exact re-rank pvf=20")
        del pq
    except Exception as e:  # pragma: no cover
        log(f"pq4bit bench failed: {e!r}")

    log_mem("pq4bit")

    # ------------------- OPQ x 4-bit (rotation + Quick-ADC stacked): the
    # framework's best quality point — measured r@5 0.80 base / 0.998 with
    # PV(20) at ~0.26 ms/query (B=256) at 3M.
    try:
        t0 = time.perf_counter()
        pq = PQIndex.build(jax.random.PRNGKey(1), V, m=60, k=16,
                           opq_iters=10, **BUILD)
        log(f"OPQ 60x16 built in {time.perf_counter() - t0:.1f}s")
        B = 256
        t, _ = timeit(lambda q: pq.search(q, K), V[:B])
        _, ids = pq.search(queries_eval, K)
        _, ids5 = pq.search(queries_eval, 5)
        add("pq4bit_opq_scan", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=1.06, ref_recall=0.38,
            note="OPQ rotation + 60x16 4-bit codes, Triton ADC scan")
        t, _ = timeit(lambda q: pq.search_pv(q, K, 20, V), V[:B])
        _, ids = pq.search_pv(queries_eval, K, 20, V)
        _, ids5 = pq.search_pv(queries_eval, 5, 20, V)
        add("pq4bit_opq_pv_20", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=1.29, ref_recall=0.87,
            note="OPQ 60x16 ADC + exact re-rank pvf=20")
        del pq
    except Exception as e:  # pragma: no cover
        log(f"pq4bit_opq bench failed: {e!r}")

    log_mem("pq4bit_opq")

    # ------------------------------- PQ k=1024 (the README.md:125 regime)
    try:
        t0 = time.perf_counter()
        pq = PQIndex.build(jax.random.PRNGKey(1), V, m=12, k=1024, **BUILD)
        log(f"PQ k=1024 built in {time.perf_counter() - t0:.1f}s "
            f"(codes dtype {pq.codes.dtype})")
        B = 64
        t, _ = timeit(lambda q: pq.search(q, K), V[:B])
        _, ids = pq.search(queries_eval, K)
        _, ids5 = pq.search(queries_eval, 5)
        add("pq1024_scan", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=1.06, ref_recall=0.38,
            note="Triton ADC full scan, 12x1024 int16 codes")
        t, _ = timeit(lambda q: pq.search_pv(q, K, 20, V), V[:B])
        _, ids = pq.search_pv(queries_eval, K, 20, V)
        _, ids5 = pq.search_pv(queries_eval, 5, 20, V)
        add("pq1024_pv_20", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=1.29, ref_recall=0.87,
            note="12x1024 ADC + exact re-rank pvf=20")
        del pq
    except Exception as e:  # pragma: no cover
        log(f"pq1024 bench failed: {e!r}")

    log_mem("pq1024")

    # --------------------------------------------------------------- IVFADC
    try:
        t0 = time.perf_counter()
        ivf = IVFADCIndex.build(jax.random.PRNGKey(2), V, m=12, k=256,
                                k_coarse=1000, **BUILD)
        ivf.tiled()
        log(f"IVFADC built in {time.perf_counter() - t0:.1f}s "
            f"(list_cap={ivf.list_cap}, tiles avg "
            f"{ivf.tiled().avg_tile_cnt:.1f} max {ivf.tiled().max_tile_cnt})")
        B = 256
        for w in (1, 3):
            t, _ = timeit(lambda q: ivf.search(q, K, w=w), V[:B])
            _, ids, info = ivf.search(queries_eval, K, w=w,
                                      return_info=True)
            _, ids5 = ivf.search(queries_eval, 5, w=w)
            cov = float(np.asarray(info["found"]).sum()
                        / max(np.asarray(info["needed"]).sum(), 1))
            add(f"ivfadc_batch_w{w}", ids5, ids, per_query_ms=t / B * 1e3,
                batch=B, w=w, coverage=cov, ref_s=0.01, ref_recall=0.35,
                note=f"tiled budget probe w={w}, full coverage")

        # latency-bound budgeted point
        t, _ = timeit(lambda q: ivf.search(q, K, w=3, budget_tiles=16),
                      V[:B])
        _, ids, info = ivf.search(queries_eval, K, w=3, budget_tiles=16,
                                  return_info=True)
        _, ids5 = ivf.search(queries_eval, 5, w=3, budget_tiles=16)
        cov = float(np.asarray(info["found"]).sum()
                    / max(np.asarray(info["needed"]).sum(), 1))
        add("ivfadc_batch_w3_b16", ids5, ids, per_query_ms=t / B * 1e3,
            batch=B, coverage=cov, ref_s=0.01, ref_recall=0.35,
            note="budget 16 tiles/query")

        t, _ = timeit(lambda q: ivf.search(q, K, w=3), V[:1])
        tp = timeit_piped(lambda q: ivf.search(q, K, w=3), V[:1])

        # chain 32 data-dependent single-query probes inside ONE jit —
        # wall/32 is device time free of per-call dispatch.
        from postgres_word2vec.models.ivfadc import _ivfadc_probe_budget
        from postgres_word2vec.ops import backend
        td = ivf.tiled()
        p3 = ivf._auto_budget(3, None, full=True)
        chain_n = 32

        @jax.jit
        def chain(q0):
            def body(i, carry):
                q, acc = carry
                vals, ids, _, _ = _ivfadc_probe_budget(
                    q, ivf.coarse.centroids, ivf.codebook.centroids, td,
                    w_lo=0, w_hi=3, k=K, p_budget=p3, block_t=td.block_t,
                    use_kernel=backend.use_kernels())
                # data dependency serializes the chain without changing q
                q = q + 0.0 * vals[:, :1]
                return q, acc + vals[0, 0]
            return jax.lax.fori_loop(0, chain_n, body,
                                     (q0, jnp.float32(0.0)))[1]

        np.asarray(chain(V[:1]))
        t0 = time.perf_counter()
        np.asarray(chain(V[:1]))
        device_ms = (time.perf_counter() - t0) / chain_n * 1e3

        results["ivfadc_single"] = {
            "per_query_ms": t * 1e3, "per_query_ms_pipelined": tp * 1e3,
            "device_ms": device_ms,
            "recall": results["ivfadc_batch_w3"]["recall"],
            "recall5": results["ivfadc_batch_w3"]["recall5"],
            "ref_s": 0.03, "ref_recall": 0.35,
            "note": ("single query w=3; device_ms (chained in-jit) "
                     "excludes per-call dispatch")}
        log(f"[ivfadc_single] wall={t * 1e3:.2f}ms piped={tp * 1e3:.2f}ms "
            f"device={device_ms:.3f}ms")

        t, _ = timeit(lambda q: ivf.search_pv(q, K, 20, V, w=3), V[:B])
        _, ids = ivf.search_pv(queries_eval, K, 20, V, w=3)
        _, ids5 = ivf.search_pv(queries_eval, 5, 20, V, w=3)
        add("ivfadc_pv", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=0.26, ref_recall=0.65,
            note="tiled probe w=3 + exact re-rank pvf=20")
        del ivf
    except Exception as e:  # pragma: no cover
        log(f"ivfadc bench failed: {e!r}")

    log_mem("ivfadc")

    # --------------- IVFADC with 4-bit residual codes (60x16): the
    # Quick-ADC regime on the inverted-file family.
    try:
        t0 = time.perf_counter()
        ivf = IVFADCIndex.build(jax.random.PRNGKey(2), V, m=60, k=16,
                                k_coarse=1000, **BUILD)
        ivf.tiled()
        log(f"IVFADC 60x16 built in {time.perf_counter() - t0:.1f}s")
        B = 256
        t, _ = timeit(lambda q: ivf.search(q, K, w=3), V[:B])
        _, ids = ivf.search(queries_eval, K, w=3)
        _, ids5 = ivf.search(queries_eval, 5, w=3)
        add("ivfadc4bit_w3", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            w=3, ref_s=0.01, ref_recall=0.35,
            note="tiled probe w=3, 60x16 4-bit residual codes")
        t, _ = timeit(lambda q: ivf.search_pv(q, K, 20, V, w=3), V[:B])
        _, ids = ivf.search_pv(queries_eval, K, 20, V, w=3)
        _, ids5 = ivf.search_pv(queries_eval, 5, 20, V, w=3)
        add("ivfadc4bit_pv", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
            ref_s=0.26, ref_recall=0.65,
            note="4-bit tiled probe w=3 + exact re-rank pvf=20")
        del ivf
    except Exception as e:  # pragma: no cover
        log(f"ivfadc4bit bench failed: {e!r}")

    log_mem("ivfadc4bit")

    # ------------------------------------------------------------- kNN-join
    try:
        from postgres_word2vec.models.ivpq import (IVPQIndex,
                                                       build_statistics)
        t0 = time.perf_counter()
        nq, nt = (500, 10_000) if SMALL else (5000, 100_000)
        ivpq = IVPQIndex.build(jax.random.PRNGKey(3), V, m=30, k=32,
                               k_coarse=1024, coarse_positions=1, **BUILD)
        log(f"IVPQ (flat 1024) built in {time.perf_counter() - t0:.1f}s")
        tgt = jnp.arange(nt, dtype=jnp.int32)
        qv = V[N - nq:]
        stats = build_statistics(ivpq.cell_of, tgt, ivpq.num_cells)
        _, gt_join = exact_top_k(qv[:EVAL_Q], V[:nt], 5, chunk_size=524288)
        gt_join = np.asarray(gt_join)

        # exact masked-matmul comparator (the knn_in_exact baseline).
        # chunks slice HOST-side: each distinct eager device slice start
        # compiles its own jaxpr.
        mask = jnp.ones((nt,), bool)
        qv_host = np.asarray(qv)
        _, i = exact_top_k_in(qv_host[:512], V, tgt, mask, 5)
        np.asarray(i[..., :1])
        # warm the TAIL chunk shape too (nq % 512): a fresh-shape XLA
        # compile inside the timed loop would be timed as search.
        if nq % 512:
            _, i = exact_top_k_in(qv_host[:nq % 512], V, tgt, mask, 5)
            np.asarray(i[..., :1])
        t0 = time.perf_counter()
        for s in range(0, nq, 512):
            _, i = exact_top_k_in(qv_host[s:s + 512], V, tgt, mask, 5)
        np.asarray(i[..., :1])
        ex_s = time.perf_counter() - t0
        _, ie = exact_top_k_in(qv[:EVAL_Q], V, tgt, mask, 5)
        results["join_exact_in"] = {
            "total_s": ex_s, "queries": nq, "targets": nt,
            "qps": nq / ex_s, "recall": recall_at_k(ie, gt_join),
            "recall5": recall_at_k(ie, gt_join), "k": 5,
            "note": "exact masked matmul (knn_in_exact baseline)"}
        log(f"[join_exact_in] {ex_s:.3f}s")

        # PREPARED handle: pays the target gathers + cell tiling once (the
        # serving steady state on a repeated target set — the reference's
        # statistics-table workload); every search_join below then issues
        # ONE fused device program per query chunk.
        t0 = time.perf_counter()
        ph = ivpq.prepare_join(tgt, vectors=V[:nt], vecs_pregathered=True)
        prep_s = time.perf_counter() - t0
        log(f"prepare_join({nt}) in {prep_s:.3f}s")
        results["ivpq_join_prepare"] = {"build_s": prep_s, "targets": nt}

        def join_cfg(name, prepared=ph, tgt_=None, gt_=None, stats_=None,
                     nt_=None, **kw):
            tgt_ = tgt if tgt_ is None else tgt_
            gt_ = gt_join if gt_ is None else gt_
            stats_ = stats if stats_ is None else stats_
            nt_ = nt if nt_ is None else nt_
            jkw = dict(statistics=stats_, **kw)
            if prepared is not None:
                jkw["prepared"] = prepared
                jkw.pop("vectors", None)
            else:
                jkw["target_ids"] = tgt_
            dd, ii = ivpq.search_join(qv[:512], 5, query_chunk=512, **jkw)
            np.asarray(ii[..., :1])
            dd, ii = ivpq.search_join(qv, 5, **jkw)   # warm the full shape
            np.asarray(ii[..., :1])
            # median of 3 full-shape passes: single draws carry first-
            # config warm-in drift
            trials = []
            for _ in range(3):
                t0 = time.perf_counter()
                dd, ii = ivpq.search_join(qv, 5, **jkw)
                np.asarray(ii[..., :1])
                trials.append(time.perf_counter() - t0)
            dt = float(np.median(trials))
            _, i2, info = ivpq.search_join(qv[:EVAL_Q], 5, query_chunk=512,
                                           return_info=True, **jkw)
            r = recall_at_k(i2, gt_)
            results[name] = {
                "total_s": dt, "trials_s": [round(t, 4) for t in trials],
                "queries": nq, "targets": nt_,
                "qps": nq / dt, "recall": r, "recall5": r, "k": 5,
                "prepared": prepared is not None,
                "scanned_rows_mean": float(
                    np.asarray(info["retrieved"]).mean()),
                # escalation rounds + final alpha: each extra round is a
                # full re-dispatch, so round-count shifts (e.g. from a
                # dataset recalibration) explain QPS deltas at equal
                # scanned rows.
                "rounds": int(np.asarray(info["rounds"]).max()),
                "final_alpha": int(np.asarray(info["final_alpha"]).max()),
                **{kk: vv for kk, vv in kw.items() if kk != "vectors"}}
            log(f"[{name}] {dt:.3f}s qps={nq / dt:.0f} recall@5={r:.3f} "
                f"scanned~{results[name]['scanned_rows_mean']:.0f}")

        join_cfg("ivpq_join_adc_a200", alpha=200, method=0, confidence=0.8)
        join_cfg("ivpq_join_pv_a100", alpha=100, method=2, confidence=0.8,
                 pvf=20)
        join_cfg("ivpq_join_pv_a200", alpha=200, method=2, confidence=0.8,
                 pvf=20)
        # ad-hoc control: same config WITHOUT the prepared handle — pays
        # the per-call target gathers + (cached) tile lookup, the round-4
        # default path. The gap vs ivpq_join_pv_a200 is the prepared-path
        # win.
        join_cfg("ivpq_join_pv_a200_adhoc", prepared=None, alpha=200,
                 method=2, confidence=0.8, pvf=20, vectors=V)
        join_cfg("ivpq_join_pv_a400", alpha=400, method=2, confidence=0.8,
                 pvf=20)
        # high-recall operating point
        join_cfg("ivpq_join_pv_a600", alpha=600, method=2, confidence=0.8,
                 pvf=20)
        # Large-target joins: the selectivity crossover. The masked
        # matmul's cost is B×T; the probe's is B×scanned rows. As |T|
        # grows the matmul pays linearly while the probe's scanned set
        # barely moves, which is where the IVPQ join's selectivity-
        # proportional design earns its keep (ivpq_search_in.c's raison
        # d'être).
        def exact_join_row(name, tgtN, maskN, gtN, ntN):
            if ntN >= N:
                # target set == whole store: the honest exact baseline is
                # the chunked full scan (no (B, T) buffer, no table-sized
                # gather — exact_top_k_in at 512×3M would need ~10 GB of
                # transients next to the resident table).
                def run(qb):
                    return exact_top_k(qb, V, 5, chunk_size=524288)
            else:
                def run(qb):
                    return exact_top_k_in(qb, V, tgtN, maskN, 5)
            _, i = run(qv_host[:512])
            np.asarray(i[..., :1])
            if nq % 512:
                _, i = run(qv_host[:nq % 512])
                np.asarray(i[..., :1])
            t0 = time.perf_counter()
            for s in range(0, nq, 512):
                _, i = run(qv_host[s:s + 512])
            np.asarray(i[..., :1])
            ex1 = time.perf_counter() - t0
            _, ie1 = run(qv[:EVAL_Q])
            results[name] = {
                "total_s": ex1, "queries": nq, "targets": ntN,
                "qps": nq / ex1, "recall": recall_at_k(ie1, gtN),
                "recall5": recall_at_k(ie1, gtN), "k": 5,
                "note": f"exact f32 in-set baseline at {ntN} targets"}
            log(f"[{name}] {ex1:.3f}s")

        if not SMALL:
            try:
                for ntN, tag in ((1_000_000, "1M"), (N, "3M")):
                    tgtN = jnp.arange(ntN, dtype=jnp.int32)
                    statsN = build_statistics(ivpq.cell_of, tgtN,
                                              ivpq.num_cells)
                    _, gtN = exact_top_k(qv[:EVAL_Q], V[:ntN], 5,
                                         chunk_size=524288)
                    gtN = np.asarray(gtN)
                    exact_join_row(f"join_exact_in_{tag}", tgtN,
                                   jnp.ones((ntN,), bool), gtN, ntN)
                    t0 = time.perf_counter()
                    phN = ivpq.prepare_join(
                        tgtN, vectors=V if ntN >= N else V[:ntN],
                        vecs_pregathered=True)
                    prepN = time.perf_counter() - t0
                    log(f"prepare_join({ntN}) in {prepN:.3f}s")
                    results[f"ivpq_join_prepare_{tag}"] = {
                        "build_s": prepN, "targets": ntN}
                    cfgs = ([(200, 20), (600, 20), (1200, 20), (2400, 20)]
                            if tag == "1M"
                            # 3M: ladder up past recall@5 0.90 (the
                            # crossover claim's quality bar) — both more
                            # scanned rows (alpha) and a wider exact
                            # re-rank (pvf) push recall at ~2x-QPS margin
                            else [(200, 20), (600, 20), (1200, 20),
                                  (1200, 50), (2400, 20), (2400, 50)])
                    for a, pvf_ in cfgs:
                        nm = (f"ivpq_join_pv_a{a}_{tag}" if pvf_ == 20
                              else f"ivpq_join_pv_a{a}_pvf{pvf_}_{tag}")
                        join_cfg(nm, prepared=phN,
                                 gt_=gtN, stats_=statsN, nt_=ntN,
                                 alpha=a, method=2, confidence=0.8,
                                 pvf=pvf_)
                    del phN
            except Exception as e:  # pragma: no cover
                log(f"large-target join bench failed: {e!r}")
        del ivpq
        # Regression guard for VERDICT r2 weak #2: method 0 (ADC only) does
        # strictly less work than method 2 (ADC + post-verify) at equal
        # alpha, so it must not be slower. Round 2's 6.5x inversion was
        # eager per-chunk device slicing (models/ivpq.py:694-699).
        # Threshold 1.5: the bench times method 0 first after the build
        # and the first full-shape config pays a warm-in penalty; 1.5
        # still catches the 6.5x eager-slicing inversion this guard
        # exists for.
        m0 = results.get("ivpq_join_adc_a200", {}).get("total_s")
        m2 = results.get("ivpq_join_pv_a200", {}).get("total_s")
        if m0 and m2:
            results["join_method0_vs_method2"] = {
                "ratio": round(m0 / m2, 3), "ok": m0 <= 1.5 * m2}
            if m0 > 1.5 * m2:
                log(f"WARNING method-0 join regression: {m0:.3f}s vs "
                    f"method-2 {m2:.3f}s (ratio {m0 / m2:.2f})")
                # PW2V_BENCH_STRICT=1 turns the advisory warning into a
                # hard failure for gated runs (ADVICE r3).
                if os.environ.get("PW2V_BENCH_STRICT"):
                    raise SystemExit(
                        f"method-0 join regression (strict mode): "
                        f"{m0:.3f}s vs {m2:.3f}s")
    except Exception as e:  # pragma: no cover
        log(f"ivpq bench failed: {e!r}")

    log_mem("ivpq")

    # ------------------------------------------------------- online insert
    # VERDICT r4 #4: insert_batch must be O(batch) device work, measured.
    # Protocol: engine over the full table (int8 exact family — the
    # append-quantize path, models/exact.extended), one warm batch that
    # absorbs the amortized capacity grow + compiles every size class,
    # then timed batches fenced by materializing one appended row.
    try:
        from postgres_word2vec.api import Freddy
        from postgres_word2vec.store import VectorStore

        # free the early exact-scan tables (~4.5 GB): the store's two f32
        # tables are 7.2 GB at 3M and extend_inplace's fused concat holds
        # old+new transiently — HBM is the binding constraint (CLAUDE.md).
        try:
            del ex
        except NameError:
            pass
        try:
            del ex8
        except NameError:
            pass

        t0 = time.perf_counter()
        store = VectorStore.from_arrays([f"w{i}" for i in range(N)], V,
                                        normalized=True)
        eng = Freddy(store, exact_dtype="int8", exact_approx=True)
        log(f"insert engine built in {time.perf_counter() - t0:.1f}s")
        rng = np.random.default_rng(11)

        def _terms(b):  # unseen 2-word phrases over the base vocab
            pairs = rng.integers(0, N, size=(b, 2))
            return [f"w{a} w{b2}" for a, b2 in pairs]

        ib = 1024
        eng.insert_batch(_terms(ib))           # warm: grow + compiles
        np.asarray(eng.exact._table[-1, :1])   # cache the fence jaxpr
        del V  # pre-insert table buffer: freed so the timed concat's
        #      old+new transient fits HBM at 3M
        log_mem("insert warm")
        reps = 3
        t0 = time.perf_counter()
        inserted = 0
        for _ in range(reps):
            inserted += eng.insert_batch(_terms(ib))
        np.asarray(eng.exact._table[-1, :1])   # completion fence
        dt = time.perf_counter() - t0
        results["insert_batch"] = {
            "total_s": dt, "terms": inserted, "batches": reps,
            "batch_size": ib, "terms_per_s": inserted / dt,
            "note": ("insert_batch: batched tokenize (one segment-sum "
                     "program) + store concat + int8 append-quantize into "
                     "capacity buffers (freddy.c:1403-1658 parity). The "
                     "per-batch floor is ~0.9 s of XLA compile: every "
                     "insert changes the store tables' total shape, so "
                     "the fused concat re-traces/compiles each call "
                     "(static-shape semantics) — device work itself is "
                     "O(batch); larger batches amortize the floor")}
        log(f"[insert_batch] {inserted} terms in {dt:.3f}s "
            f"({inserted / dt:.0f} terms/s)")
        # correctness probe: a just-inserted phrase is its own 1-NN
        probe = _terms(1)[0]
        eng.insert_batch([probe])
        top = eng.knn(probe, 1)
        results["insert_batch"]["probe_ok"] = bool(top and
                                                   top[0][0] == probe)
        if not results["insert_batch"]["probe_ok"]:  # pragma: no cover
            log(f"WARNING insert probe: knn({probe!r}) -> {top}")
        del eng, store
    except Exception as e:  # pragma: no cover
        log(f"insert bench failed: {e!r}")

    log_mem("insert")

    # ------------------------------------------------------------- headline
    eligible = [(name, cfg) for name, cfg in results.items()
                if "per_query_ms" in cfg and cfg.get("batch", 1) > 1
                and cfg.get("recall", 0.0) >= BASELINE_RECALL]
    if eligible:
        name, best = min(eligible, key=lambda kv: kv[1]["per_query_ms"])
        value = best["per_query_ms"]
    else:  # fall back to exact single query
        name, best = "exact_single", results["exact_single"]
        value = best["per_query_ms"]

    # Full per-config detail goes to a repo-local file; stdout gets ONE
    # compact line (<2 KB) so the driver's capture parses intact — round 2's
    # full-detail line overflowed the capture (BENCH_r02.json parsed=null).
    detail_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BENCH_LOCAL_latest.json")
    with open(detail_path, "w") as f:
        from postgres_word2vec.evaluation import synth as _synth
        json.dump({"n_vectors": N,
                   # the synth calibration behind every recall number: a
                   # cross-round recall comparison is only valid at equal
                   # dataset params.
                   "dataset": dict(_synth.V3_PARAMS, generator="wordlike",
                                   version="v3"),
                   "reference_bars": {"pq@5": 0.38, "pq_pv@5": 0.87,
                                      "ivfadc@5": 0.35, "ivfadc_pv@5": 0.65},
                   "configs": results}, f, indent=1)
    log(f"full detail written to {detail_path}")

    def _r5(name):
        c = results.get(name, {})
        return round(c.get("recall5", 0.0), 3) if c else None

    # the quality-bar row: fastest 3M join config at recall@5 >= 0.90
    _hi = sorted(((n_, c_) for n_, c_ in results.items()
                  if n_.startswith("ivpq_join_pv_") and n_.endswith("_3M")
                  and c_.get("recall5", 0.0) >= 0.90),
                 key=lambda kv: -kv[1]["qps"])
    _hi_join = ({"join_3M_hi": _hi[0][0],
                 "join_3M_hi_qps": round(_hi[0][1]["qps"], 0),
                 "join_3M_hi_r5": round(_hi[0][1]["recall5"], 3)}
                if _hi else {})

    line = {
        "metric": f"batch_knn_p50_per_query_ms[{name}]",
        "value": round(value, 4),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / value, 1),
        "recall": round(best.get("recall", 1.0), 4),
        "n_vectors": N,
        # compact per-family highlights (recall@5 vs reference bars
        # 0.38 / 0.87 / 0.35 / 0.65; full detail in BENCH_LOCAL_latest.json)
        "pq_r5": _r5("pq_scan"), "pq_pv20_r5": _r5("pq_pv_20"),
        # the engine's DEFAULT build applies OPQ at the same 12x256 shape
        # (preset="reference" keeps the raw quantizer; pq_r5 above is that
        # raw-parity ablation control)
        "pq_opq_r5": _r5("pq_opq_scan"),
        "ivfadc_r5": _r5("ivfadc_batch_w3"), "ivfadc_pv_r5": _r5("ivfadc_pv"),
        "best_quality_r5": _r5("pq4bit_opq_pv_20"),
        "join_pv_a200_qps": round(
            results.get("ivpq_join_pv_a200", {}).get("qps", 0.0), 0),
        "join_pv_a200_r5": _r5("ivpq_join_pv_a200"),
        # selectivity crossover: prepared-tile probe vs exact at full-store
        # targets (the regime ivpq_search_in exists for)
        "join_3M_qps": round(
            results.get("ivpq_join_pv_a600_3M", {}).get("qps", 0.0), 0),
        "join_3M_r5": _r5("ivpq_join_pv_a600_3M"),
        **_hi_join,
        "join_exact_3M_qps": round(
            results.get("join_exact_in_3M", {}).get("qps", 0.0), 0),
        "insert_tps": round(
            results.get("insert_batch", {}).get("terms_per_s", 0.0), 0),
    }
    out = json.dumps(line)
    assert len(out) < 2048, f"bench line too long ({len(out)} B)"
    print(out)


if __name__ == "__main__":
    main()

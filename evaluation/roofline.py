#!/usr/bin/env python3
"""Roofline probe: measure this chip's effective ceilings, then the achieved
throughput of each hot kernel at 3M×300 scale.

    python evaluation/roofline.py [--small]

Prints one JSON document: measured device ceilings (memory stream GB/s,
bf16/int8 matmul TFLOP/s) and, per kernel, the achieved rate and its roofline fraction given
the kernel's arithmetic intensity. This quantifies the "every hot kernel at
speed-of-light" claim — the exact/ADC scans are HBM-streaming kernels, so
their bound is the measured stream rate, not peak FLOPs.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np


def _sync(x):
    leaf = jax.tree.leaves(x)[0]
    np.asarray(leaf if getattr(leaf, "ndim", 0) == 0 else leaf[..., :1])


def timeit(fn, *args, iters=5):
    out = fn(*args)
    _sync(out)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_ceilings() -> dict:
    out = {}
    # memory stream: best of three read-dominated probes — a reduction can
    # be ALU-bound, so also probe with a B=8 matmul over a large table
    # (reads the table once; its FLOPs are negligible).
    n = 256 * 1024 * 1024  # 512 MB bf16
    x = jnp.ones((n,), jnp.bfloat16)
    t = timeit(jax.jit(lambda a: jnp.sum(a.astype(jnp.float32))), x)
    rates = [n * 2 / t / 1e9]
    del x
    rows, d = 4 * 1024 * 1024, 256      # 2 GB bf16 table
    tab = jnp.ones((rows, d), jnp.bfloat16)
    q8 = jnp.ones((8, d), jnp.bfloat16)
    t = timeit(jax.jit(lambda q, v: jnp.min(
        jnp.dot(q, v.T, preferred_element_type=jnp.float32), axis=-1)),
        q8, tab)
    rates.append(rows * d * 2 / t / 1e9)
    del tab
    out["hbm_read_gbps"] = max(rates)
    out["hbm_probe_gbps"] = rates

    # bf16 matmul peak: large square matmul (compute >> memory).
    m = 16384
    a = jnp.ones((m, m), jnp.bfloat16)
    g = jax.jit(lambda p, q: jnp.dot(p, q,
                                     preferred_element_type=jnp.float32))
    t = timeit(g, a, a)
    out["matmul_bf16_tflops"] = 2 * m**3 / t / 1e12

    # int8 matmul rate.
    ai = jnp.ones((m, m), jnp.int8)
    h = jax.jit(lambda p, q: jnp.dot(p, q,
                                     preferred_element_type=jnp.int32))
    t = timeit(h, ai, ai)
    out["matmul_int8_tops"] = 2 * m**3 / t / 1e12
    del a, ai
    return out


def measure_kernels(n: int, d: int) -> dict:
    from postgres_word2vec.evaluation import synth
    from postgres_word2vec.models.exact import ExactIndex
    from postgres_word2vec.models.pq import PQIndex

    V = synth.generate_wordlike(jax.random.PRNGKey(0), n, d)
    out = {}

    B = 1024
    ex = ExactIndex(V, "bfloat16")
    t = timeit(lambda q: ex.search(q, 10, approx=True), V[:B])
    out["exact_bf16_scan"] = {
        "wall_s": t, "bytes": n * d * 2,
        "flops": 2 * B * n * d,
        "gbps": n * d * 2 / t / 1e9,
        "tflops": 2 * B * n * d / t / 1e12,
        "note": f"B={B} batched scan; one HBM pass over the bf16 table"}
    del ex

    ex8 = ExactIndex(V, "int8")
    t = timeit(lambda q: ex8.search(q, 10, approx=True), V[:B])
    out["exact_int8_scan"] = {
        "wall_s": t, "bytes": n * d,
        "flops": 2 * B * n * d,
        "gbps": n * d / t / 1e9,
        "tops": 2 * B * n * d / t / 1e12,
        "note": "int8 table + int8 matmul"}
    del ex8

    Bq = 64
    pq = PQIndex.build(jax.random.PRNGKey(1), V, m=12, k=256,
                       train_size=100_000, iters=10)
    t = timeit(lambda q: pq.search(q, 10), V[:Bq])
    m = 12
    out["pq_adc_scan"] = {
        "wall_s": t, "bytes": n * m,
        "flops": Bq * n * m,
        "gbps": n * m / t / 1e9,
        "tflops": Bq * n * m / t / 1e12,
        "note": f"B={Bq} Triton ADC scan; FLOPs count one add per LUT "
                f"lookup (B·N·m)"}
    return out


def main() -> None:
    small = "--small" in sys.argv
    n, d = (307_200, 300) if small else (3_072_000, 300)
    ceil = measure_ceilings()
    kern = measure_kernels(n, d)
    for v in kern.values():
        if "tops" in v:
            v["roofline"] = "compute" if (
                v["tops"] / ceil["matmul_int8_tops"]
                > v["gbps"] / ceil["hbm_read_gbps"]) else "memory"
            v["pct_of_bound"] = round(100 * max(
                v["tops"] / ceil["matmul_int8_tops"],
                v["gbps"] / ceil["hbm_read_gbps"]), 1)
        else:
            v["roofline"] = "compute" if (
                v["tflops"] / ceil["matmul_bf16_tflops"]
                > v["gbps"] / ceil["hbm_read_gbps"]) else "memory"
            v["pct_of_bound"] = round(100 * max(
                v["tflops"] / ceil["matmul_bf16_tflops"],
                v["gbps"] / ceil["hbm_read_gbps"]), 1)
    print(json.dumps({"n": n, "d": d, "ceilings": ceil,
                      "kernels": kern}, indent=2))


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    main()

"""Shared measurement helpers for the benchmark drivers (bench.py,
evaluation/scale_capacity.py).

Every measurement materializes a small result slice to host;
``timeit_piped`` amortizes per-call dispatch by enqueueing several calls
and blocking once.
"""

from __future__ import annotations

import sys
import time

import jax
import numpy as np


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


def log_mem(tag: str) -> None:
    try:
        stats = jax.devices()[0].memory_stats() or {}
        used = stats.get("bytes_in_use", 0) / 2**30
        peak = stats.get("peak_bytes_in_use", 0) / 2**30
        log(f"[mem {tag}] in_use={used:.2f}GiB peak={peak:.2f}GiB")
    except Exception:
        pass


def materialize(out) -> None:
    for leaf in jax.tree.leaves(out):
        np.asarray(leaf[..., :1])


#: most recent timeit() call's samples — bench.py attaches them as a
#: spread next to each median so cross-round comparisons can separate
#: chip-state variance from real regressions (VERDICT r3 item 4).
_LAST_TIMING = {"seq": 0, "samples": ()}


def timeit(fn, *args, iters: int = 5):
    """Median wall time of ``fn(*args)`` → (seconds, last output)."""
    out = fn(*args)
    materialize(out)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        materialize(out)
        ts.append(time.perf_counter() - t0)
    _LAST_TIMING["seq"] += 1
    _LAST_TIMING["samples"] = tuple(ts)
    return float(np.median(ts)), out


def last_timing() -> dict:
    """(seq, min_s, max_s, n) of the most recent :func:`timeit` call."""
    s = _LAST_TIMING["samples"]
    if not s:
        return {}
    return {"seq": _LAST_TIMING["seq"], "min_s": float(min(s)),
            "max_s": float(max(s)), "n": len(s)}


def timeit_piped(fn, *args, iters: int = 8) -> float:
    """Pipelined per-call time: enqueue ``iters`` calls, block once —
    approximates device+queue time per call without per-call dispatch."""
    out = fn(*args)
    materialize(out)
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    materialize(outs[-1])
    return (time.perf_counter() - t0) / iters


def host_exact_topk(queries: np.ndarray, chunks, k: int):
    """Exact squared-L2 top-k on HOST numpy over row chunks of the table.

    Ground-truth fallback for regimes where the device allocator cannot
    host even small fresh buffers next to a near-capacity resident set
    (the 10M single-chip run). ``chunks`` iterates (rows_i, d) arrays in
    row order; each is upcast to float32, so passing bf16-rounded chunks
    reproduces the device table's rounding exactly.

    Returns (distances (Q, k) float32 ascending, ids (Q, k) int64).
    Mirrors the reference's exact ground-truth role
    (/root/reference/evaluation/evaluation_utils.py:230-238) without a
    second engine in the loop.
    """
    q = np.ascontiguousarray(queries, dtype=np.float32)
    nq = q.shape[0]
    best_d = np.full((nq, k), np.inf, np.float32)
    best_i = np.full((nq, k), -1, np.int64)
    off = 0
    for ch in chunks:
        v = np.asarray(ch).astype(np.float32)
        d = (v * v).sum(axis=1)[None, :] - 2.0 * (q @ v.T)
        if v.shape[0] > k:
            idx = np.argpartition(d, k - 1, axis=1)[:, :k]
        else:
            idx = np.broadcast_to(np.arange(v.shape[0]), d.shape).copy()
        cat_d = np.concatenate([best_d, np.take_along_axis(d, idx, 1)], 1)
        cat_i = np.concatenate([best_i, idx + off], 1)
        sel = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(cat_d, sel, 1)
        best_i = np.take_along_axis(cat_i, sel, 1)
        off += v.shape[0]
        del v, d
    # squared-L2 against the query's own norm term: add |q|^2 so the
    # distances are true squared distances, not just comparable keys.
    best_d = best_d + (q * q).sum(axis=1, keepdims=True)
    return best_d, best_i


def recall_at_k(ids, exact_ids) -> float:
    ids = np.asarray(ids)
    exact_ids = np.asarray(exact_ids)[:, :ids.shape[1]]
    hits = sum(len(set(a.tolist()) & set(e.tolist()))
               for a, e in zip(ids, exact_ids))
    return hits / exact_ids.size

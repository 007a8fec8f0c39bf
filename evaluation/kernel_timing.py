#!/usr/bin/env python
"""Time each Triton kernel against the plain XLA version on the GPU.

At the benchmark's shapes (N = 3,072,000 codes; the IVFADC probe and the
IVPQ join budgets) this compiles every kernel, compares it with its XLA
reference, and times both; it also times the top-k choices (``lax.top_k``,
the blockwise rule, the binned approximation, ``lax.approx_min_k``, which
has no GPU lowering of its own and sorts). Results go to
``chiprun_out/kernel_timing.json`` and one summary line per row to stdout.

    python evaluation/kernel_timing.py [--quick]

Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _timeit(fn, *args, reps: int = 3) -> float:
    import jax
    jax.block_until_ready(fn(*args))            # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small N: a compile-and-compare check only")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "kernel_timing.json"))
    args = ap.parse_args()

    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from postgres_word2vec.models.pq import PQCodebook, PQIndex
    from postgres_word2vec.ops import adc, topk
    from postgres_word2vec.ops import pallas_kernels as pk

    if jax.default_backend() != "gpu":
        print("no GPU backend", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    rows: list[dict] = []

    def emit(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    n = 200_000 if args.quick else 3_072_000
    key = jax.random.PRNGKey(0)
    # ---------------------------------------------------------------- ADC
    regimes = [(12, 256, jnp.uint8), (60, 16, jnp.uint8),
               (30, 32, jnp.uint8), (12, 1024, jnp.int16)]
    batches = (1, 256) if args.quick else (1, 16, 256, 1024)
    for m, k, dt in regimes:
        codes = jax.random.randint(key, (n, m), 0, k).astype(dt)
        for B in batches:
            luts = jax.random.uniform(jax.random.fold_in(key, B), (B, m, k))
            xla = jax.jit(functools.partial(adc.adc_top_k, k=10))
            want_v, want_i = xla(luts, codes)
            row = dict(kind="adc", m=m, k=k, B=B, N=n)
            try:
                row["xla_ms"] = _timeit(xla, luts, codes)
            except Exception as e:             # noqa: BLE001 — probe
                row["xla_err"] = repr(e)[:300]
            # dense parity on the first chunk at full precision
            c0 = codes[:65536]
            ref = adc.adc_distances(luts, c0)
            try:
                got = pk.adc_scan(luts, c0)
                row["dense_maxerr"] = float(jnp.max(jnp.abs(got - ref)))
                kern = jax.jit(functools.partial(adc.adc_top_k, k=10,
                                                 use_kernel=True))
                kern_v, kern_i = kern(luts, codes)
                row["kernel_ms"] = _timeit(kern, luts, codes)
                if B <= 16:
                    # XLA's top_k over the whole row, where the default
                    # takes the blockwise rule (ops/topk.py)
                    whole = jax.jit(lambda l, c: jax.lax.top_k(
                        -pk.adc_scan(l, c), 10))
                    row["kernel_lax_topk_ms"] = _timeit(whole, luts, codes)
                row["top10_maxerr"] = float(jnp.max(jnp.abs(kern_v - want_v)))
                row["top10_idmatch"] = float(jnp.mean(kern_i == want_i))
                binned = jax.jit(functools.partial(pk.adc_top_k_binned,
                                                   k=10))
                bv, bi = binned(luts, codes)
                row["binned_ms"] = _timeit(binned, luts, codes)
                row["binned_recall10"] = float(np.mean([
                    len(set(a) & set(b)) / 10 for a, b in
                    zip(np.asarray(bi), np.asarray(want_i))]))
            except Exception as e:             # noqa: BLE001 — probe
                row["kernel_err"] = repr(e)[:600]
            emit(**row)
        # the whole PQ search program (LUT build, scan, top-10; PV re-rank
        # of 200) at the benchmark's batches, on each plan
        cents = jax.random.normal(jax.random.fold_in(key, m), (m, k, 300 // m))
        pq = PQIndex(PQCodebook(cents, jnp.ones((m, k), jnp.int32)), codes)
        table = jax.random.normal(jax.random.fold_in(key, 7), (n, 300))
        for B in ((1, 64) if args.quick else (1, 64, 256)):
            q = jax.random.normal(jax.random.fold_in(key, 1000 + B), (B, 300))
            row = dict(kind="pq_search", m=m, k=k, B=B, N=n)
            calls = {
                "xla": lambda q: pq.search(q, 10, impl="xla"),
                "kernel": lambda q: pq.search(q, 10),
                "binned": lambda q: pq.search(q, 10, approx=True),
                "pv_xla": lambda q: pq.search_pv(q, 10, 20, table,
                                                 impl="xla"),
                "pv_kernel": lambda q: pq.search_pv(q, 10, 20, table,
                                                    shortlist="exact"),
                "pv_binned": lambda q: pq.search_pv(q, 10, 20, table,
                                                    shortlist="approx")}
            for name, f in calls.items():
                row[f"{name}_ms"] = _timeit(f, q)
            _, wi = calls["xla"](q)
            _, ki = calls["kernel"](q)
            row["kernel_idmatch"] = float(jnp.mean(ki == wi))
            emit(**row)
        del codes, table
    # ------------------------------------------------------------ budget
    probes = [("ivfadc", 256, 16, 1024, 12, 256, jnp.uint8, 4_100_000),
              ("ivfadc", 512, 16, 1024, 12, 256, jnp.uint8, 4_100_000),
              ("ivfadc", 1024, 16, 1024, 12, 256, jnp.uint8, 4_100_000),
              ("ivfadc", 2048, 16, 1024, 12, 256, jnp.uint8, 4_100_000),
              ("join", 1024, 16, 256, 30, 32, jnp.uint8, 190_000),
              ("join", 4096, 16, 256, 30, 32, jnp.uint8, 190_000)]
    if args.quick:
        probes = [("ivfadc", 256, 16, 1024, 12, 256, jnp.uint8, 400_000)]
    for name, B, P, bt, m, k, dt, na in probes:
        na = (na // bt) * bt
        kc, kt, kl, kr = jax.random.split(jax.random.fold_in(key, B), 4)
        codes = jax.random.randint(kc, (na, m), 0, k).astype(dt)
        rt = jax.random.uniform(kr, (na,))
        rt = rt.at[na - bt:].set(jnp.inf)
        tiles = jax.random.randint(kt, (B, P), 0, na // bt)
        luts = jax.random.uniform(kl, (B, m, k))
        xla = jax.jit(functools.partial(adc.budget_adc_xla, block_t=bt))
        kern = jax.jit(functools.partial(pk.budget_adc, block_t=bt))
        row = dict(kind="budget_adc", probe=name, B=B, P=P, block_t=bt,
                   m=m, k=k)
        try:
            want, got = xla(luts, codes, rt, tiles), kern(luts, codes, rt,
                                                        tiles)
            fin = jnp.isfinite(want)
            row["maxerr"] = float(jnp.max(jnp.where(fin, jnp.abs(got - want),
                                                    0.0)))
            row["inf_match"] = bool(jnp.all(fin == jnp.isfinite(got)))
            row["xla_ms"] = _timeit(xla, luts, codes, rt, tiles)
            row["kernel_ms"] = _timeit(kern, luts, codes, rt, tiles)
        except Exception as e:                 # noqa: BLE001 — probe
            row["err"] = repr(e)[:600]
        emit(**row)
    # ------------------------------------------------- top-k, few rows
    for B in ((1,) if args.quick else (1, 4, 16, 64, 256)):
        for width in ((200_000,) if args.quick else (131_072, 3_072_000)):
            d = jax.random.uniform(jax.random.fold_in(key, width), (B, width))
            for kk in (10, 200):
                row = dict(kind="topk_rows", B=B, N=width, k=kk)
                row["native_ms"] = _timeit(jax.jit(
                    lambda x, kk=kk: jax.lax.top_k(-x, kk)), d)
                row["blockwise_ms"] = _timeit(jax.jit(
                    lambda x, kk=kk: topk._blockwise_top_k_smallest(x, kk)),
                    d)
                emit(**row)
            del d
    # ------------------------------------------------------------- top-k
    for B in ((256,) if args.quick else (256, 1024)):
        for width in ((200_000,) if args.quick else (1_048_576, 3_072_000)):
            d = jax.random.uniform(jax.random.fold_in(key, width), (B, width))
            for kk in (10, 200):
                row = dict(kind="topk", B=B, N=width, k=kk)
                f_native = jax.jit(lambda x, kk=kk: jax.lax.top_k(-x, kk))
                f_block = jax.jit(lambda x, kk=kk:
                                  topk._blockwise_top_k_smallest(x, kk))
                f_binned = jax.jit(lambda x, kk=kk:
                                   topk._binned_top_k_smallest(x, kk, 0.95))
                f_approx = jax.jit(lambda x, kk=kk:
                                   jax.lax.approx_min_k(x, kk))
                for name, f in (("native", f_native), ("blockwise", f_block),
                                ("binned", f_binned),
                                ("approx_min_k", f_approx)):
                    if name != "binned" and B * width >= 2**31:
                        # XLA's GPU sort/top-k overflows a 32-bit size
                        row[f"{name}_ms"] = None
                        continue
                    try:
                        row[f"{name}_ms"] = _timeit(f, d)
                    except Exception as e:     # noqa: BLE001 — probe
                        row[f"{name}_err"] = repr(e)[:300]
                if B * width < 2**31:
                    _, ei = f_native(d)
                    _, bi = f_binned(d)
                    row["binned_recall"] = float(np.mean([
                        len(set(a) & set(b)) / kk for a, b in
                        zip(np.asarray(bi), np.asarray(ei))]))
                emit(**row)
            del d
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

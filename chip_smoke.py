#!/usr/bin/env python
"""Smoke run of the engine's main path on one GPU, at full size.

Builds FREDDY's deployment — a 3,072,000 × 300 word-vector store made by
``evaluation.synth.generate_wordlike`` from ``--seed``, indexed with
``Freddy.build``'s defaults (PQ 12×256 with OPQ, IVFADC 12×256 over 1,000
cells, IVPQ 30×32 on a 2×32 multi-index, 100k training rows) — and drives
every family through the calls a user makes, then the threaded HTTP server
in the same process. Phases, in order:

1. the GPU-marked tests (``tests/test_gpu_kernels.py``), in this process;
2. each Triton kernel against its XLA twin at real widths;
3. data and build;
4. every family's recall@10 against an exact float32 (HIGHEST) scan, held
   to a floor from the CPU reference run (``evaluation/family_recall.py``)
   and to the recall its XLA reference path reaches in this run;
5. the dispatch each family resolved to on the GPU;
6. analogy, insert + knn of the new term, and the server's answers.

Any failure raises: the script exits non-zero and prints no result. The
last line is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py               # one card
    python chip_smoke.py --cards 4     # the sharded engine vs one card

Needs a GPU and the repository beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ROWS = 3_072_000
DIM = 300
K = 10
N_EVAL = 256
#: a GPU path may trail its XLA reference path's recall by at most this:
#: the binned scans keep one survivor per strided bin, which the reference
#: path does not (the exact paths agree to summation order)
RECALL_SLACK = 0.02
#: recall@10 (the join: recall@5) of each family on this data at seed 0
#: in the CPU reference run (``JAX_PLATFORMS=cpu python
#: evaluation/family_recall.py``: PQ 0.5914, PQ+PV 0.9930, IVFADC 0.5227,
#: IVFADC+PV 0.8820, join 0.1670; PERF.md) less RECALL_SLACK, rounded
#: down: codebooks trained on another backend move recall by a few
#: thousandths. The exact family must stay exact.
RECALL_FLOOR = {"exact": 0.99, "pq": 0.57, "pq_pv": 0.97, "ivfadc": 0.50,
                "ivfadc_pv": 0.86, "ivpq_join": 0.14}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    def __init__(self):
        self.times: dict[str, float] = {}

    def __call__(self, name: str):
        phases = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()
                log(f"[phase] {name} ...")

            def __exit__(self, exc_type, exc, tb):
                dt = time.perf_counter() - self.t0
                phases.times[name] = dt
                log(f"[phase] {name} {'ok' if exc is None else 'FAILED'} "
                    f"{dt:.3f} s")
                return False

        return _Span()


def recall(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    k = want.shape[1]
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                          for a, b in zip(got[:, :k], want)]))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


# --------------------------------------------------------------- phases
def run_gpu_tests() -> None:
    """The compiled-kernel test file, in this process (one process holds
    the card). pytest is in the card machine's base set."""
    import pytest
    os.environ["PW2V_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:xdist",
                      "-p", "no:randomly", "--rootdir", str(ROOT),
                      str(ROOT / "tests" / "test_gpu_kernels.py")])
    check(rc == 0, f"GPU kernel tests failed (pytest exit {rc})")


def compare_kernels(seed: int) -> dict:
    """The Triton ADC scan vs its XLA twin over N = 3,072,000 codes in the
    four code regimes, B ∈ {1, 256, 1024}: the exact chunked top-10 must
    agree (the kernel sums the same f32 LUT entries ≤ 1 in another order:
    m·2e-6 absolute), the binned scan must keep ≥ 0.95 of it."""
    import jax
    import jax.numpy as jnp

    from postgres_word2vec.ops import adc
    from postgres_word2vec.ops import pallas_kernels as pk

    out = {}
    key = jax.random.PRNGKey(seed)
    for m, k, dt in ((12, 256, jnp.uint8), (60, 16, jnp.uint8),
                     (30, 32, jnp.uint8), (12, 1024, jnp.int16)):
        codes = jax.random.randint(key, (N_ROWS, m), 0, k).astype(dt)
        tol = m * 2e-6
        for B in (1, 256, 1024):
            luts = jax.random.uniform(jax.random.fold_in(key, B), (B, m, k))
            want_v, want_i = adc.adc_top_k(luts, codes, K)
            got_v, got_i = adc.adc_top_k(luts, codes, K, use_kernel=True)
            err = float(jnp.max(jnp.abs(got_v - want_v)))
            idm = recall(got_i, want_i)
            bv, bi = pk.adc_top_k_binned(luts, codes, K)
            brec = recall(bi, want_i)
            tag = f"{m}x{k}/B{B}"
            out[tag] = dict(top10_maxerr=err, top10_recall=idm,
                            binned_recall=brec)
            log(f"[kernel] adc {tag}: top10 maxerr {err:.3g} "
                f"(bound {tol:.3g}), id agreement {idm:.4f}, binned "
                f"recall {brec:.4f}")
            check(err <= tol, f"adc {tag}: maxerr {err} > {tol}")
            check(idm >= 0.99, f"adc {tag}: ids agree {idm}")
            check(brec >= 0.95, f"adc {tag}: binned recall {brec}")
        del codes
    return out


def compare_budget(eng, q) -> dict:
    """The probe kernel vs its XLA twin on the engine's own IVFADC tiled
    inverted file."""
    import jax.numpy as jnp

    from postgres_word2vec.models.ivfadc import plan_probe_tiles
    from postgres_word2vec.ops import adc, kmeans, lut
    from postgres_word2vec.ops import pallas_kernels as pk
    from postgres_word2vec.ops import topk

    out = {}
    ivf = eng.ivfadc
    t = ivf.tiled()
    p = ivf._auto_budget(3, None, True)
    cd = kmeans.pairwise_sqdist(q, ivf.coarse.centroids)
    _, cells = topk.top_k_smallest(cd, 3)
    tiles, _ = plan_probe_tiles(p, jnp.take(t.tile_start, cells),
                                jnp.take(t.tile_cnt, cells), t.inf_tile)
    luts = lut.build_luts(q, ivf.codebook.centroids)
    want = adc.budget_adc_xla(luts, t.codes_rows, t.rowterm, tiles,
                              block_t=t.block_t)
    got = pk.budget_adc(luts, t.codes_rows, t.rowterm, tiles,
                        block_t=t.block_t)
    fin = jnp.isfinite(want)
    err = float(jnp.max(jnp.where(fin, jnp.abs(got - want), 0.0)))
    same_inf = bool(jnp.all(fin == jnp.isfinite(got)))
    out["budget_adc"] = dict(B=int(q.shape[0]), P=p, block_t=t.block_t,
                             maxerr=err, inf_match=same_inf)
    log(f"[kernel] budget_adc ivfadc B={q.shape[0]} P={p} "
        f"block_t={t.block_t}: maxerr {err:.3g}, inf match {same_inf}")
    check(same_inf and err <= 1e-3, "budget_adc differs from its twin")

    return out


def build_engine(seed: int, **build_kw):
    import jax
    import jax.numpy as jnp

    from postgres_word2vec import Freddy, VectorStore
    from postgres_word2vec.evaluation import synth

    v = synth.generate_wordlike(jax.random.PRNGKey(seed), N_ROWS, DIM)
    # plant one analogy parallelogram: w3 − w1 + w2 lands on word 7
    a = v[0] - v[1] + v[2]
    v = v.at[7].set(a / jnp.linalg.norm(a))
    jax.block_until_ready(v)
    words = [f"w{i}" for i in range(N_ROWS)]
    store = VectorStore.from_arrays(words, v, normalized=True)
    eng = Freddy.build(store, seed=seed, **build_kw)
    jax.block_until_ready(eng.store.vectors_norm)
    return eng, words


def eval_set(eng, words, seed: int) -> dict:
    """N_EVAL query rows with their exact f32 (HIGHEST) top-10, and 1,024
    join query words with their exact top-5 among the first 100k rows."""
    import jax
    import jax.numpy as jnp

    from postgres_word2vec.models.exact import exact_top_k, exact_top_k_in

    n = eng.store.size
    ids = jax.random.choice(jax.random.PRNGKey(seed + 1), n, (N_EVAL,),
                            replace=False)
    q = jnp.take(eng.store.vectors_norm, ids, axis=0)
    _, truth = exact_top_k(q, eng.store.vectors_norm, K)
    join_q = [words[int(i)] for i in jax.random.choice(
        jax.random.PRNGKey(seed + 2), n, (1024,), replace=False)]
    tids = jnp.arange(100_000, dtype=jnp.int32)
    _, join_truth = exact_top_k_in(
        eng.store.vectors_for(join_q), eng.store.vectors_norm, tids,
        jnp.ones((100_000,), bool), 5)
    jax.block_until_ready(join_truth)
    return dict(ids=ids, q=q, truth=truth, join_q=join_q,
                targets=list(range(100_000)), tids=tids,
                join_truth=join_truth)


FAMILIES = {"exact": "k_nearest_neighbour",
            "pq": "k_nearest_neighbour_pq",
            "pq_pv": "k_nearest_neighbour_pq_pv",
            "ivfadc": "k_nearest_neighbour_ivfadc",
            "ivfadc_pv": "k_nearest_neighbour_ivfadc_pv"}


def join_recall(eng, ev) -> float:
    import numpy as np

    rows = eng.knn_join(ev["join_q"], 5, ev["targets"])
    got: dict = {}
    for qw, w, _s in rows:
        got.setdefault(qw, []).append(int(w[1:]))
    ids = np.array([(got.get(qw, []) + [-1] * 5)[:5] for qw in ev["join_q"]])
    return recall(ids, ev["join_truth"])


def engine_recalls(eng, ev) -> dict:
    """recall@10 of each family (the join: recall@5) through the engine's
    batched cores, on the path the backend dispatches to."""
    out = {}
    for name, fn in FAMILIES.items():
        eng.set_knn_function(fn)
        out[name] = recall(eng.knn_matrix(ev["q"], K)[1], ev["truth"])
    eng.set_knn_function("k_nearest_neighbour")
    eng.set_knn_join_function("knn_in_ivpq_batch")
    out["ivpq_join"] = join_recall(eng, ev)
    return out


def reference_recalls(eng, ev) -> dict:
    """The same families on the plain-XLA paths, chosen by argument
    (``impl="xla"``); the join with target lists off (its dense path)."""
    p, q, vecs = eng.params, ev["q"], eng.store.vectors_norm
    calls = {
        "pq": lambda: eng.pq.search(q, K, impl="xla"),
        "pq_pv": lambda: eng.pq.search_pv(q, K, p.pvf, vecs, impl="xla",
                                          shortlist=p.pv_shortlist),
        "ivfadc": lambda: eng.ivfadc.search_adaptive(q, K, w=p.w,
                                                     impl="xla"),
        "ivfadc_pv": lambda: eng.ivfadc.search_pv(q, K, p.pvf, vecs, w=p.w,
                                                  impl="xla")}
    out = {name: recall(f()[1], ev["truth"]) for name, f in calls.items()}
    eng.set_knn_join_function("knn_in_ivpq_batch")
    eng.set_use_targetlist(False)
    try:
        out["ivpq_join"] = join_recall(eng, ev)
    finally:
        eng.set_use_targetlist(True)
    return out


def family_recalls(eng, ev) -> dict:
    """Each family's recall on the GPU path, held to its CPU floor and to
    its XLA reference path in this run."""
    got, ref = engine_recalls(eng, ev), reference_recalls(eng, ev)
    for name, r in got.items():
        log(f"[recall] {name}: gpu {r:.4f}, floor {RECALL_FLOOR[name]}, "
            f"reference path {ref.get(name, float('nan')):.4f}")
        check(r >= RECALL_FLOOR[name],
              f"{name} recall {r} < floor {RECALL_FLOOR[name]}")
        if name in ref:
            check(r >= ref[name] - RECALL_SLACK,
                  f"{name} recall {r} < reference {ref[name]} - "
                  f"{RECALL_SLACK}")
    return dict(gpu=got, reference=ref)


def check_dispatch(eng) -> dict:
    """Assert each family resolved to the path chosen for the GPU."""
    from postgres_word2vec.ops import backend
    from postgres_word2vec.ops import pallas_kernels as pk

    d = dict(use_kernels=backend.use_kernels(),
             interpret=pk._interpret(None),
             pq_exact=eng.pq._search_plan(False, None),
             pq_approx=eng.pq._search_plan(True, None),
             join=eng.ivpq.join_impl(use_targetlists=True))
    log(f"[dispatch] {json.dumps(d)}")
    check(d["use_kernels"] and not d["interpret"], "kernels not compiled")
    check(d["pq_exact"] == "dense" and d["pq_approx"] == "binned",
          "PQ plan is not the Triton scan")
    check(d["join"] == "budget", "join does not take the budget probe")
    return d


def server_phase(eng, words) -> None:
    from postgres_word2vec.server import QueryServer

    srv = QueryServer(eng, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"

    def post(path, body):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["result"]

    def same(http_rows, direct_rows, what):
        check([w for w, _ in http_rows] == [w for w, _ in direct_rows],
              f"{what}: words differ {http_rows} vs {direct_rows}")
        # batch-size-dependent GEMM kernels may differ in the last bits
        check(all(abs(a - b) <= 1e-5 for (_, a), (_, b)
                  in zip(http_rows, direct_rows)), f"{what}: sims differ")

    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["vocab"] == eng.store.size,
              f"/health: {health}")
        targets = words[:100_000:997]
        for w in ("w5", "w123456", words[-1]):
            same(post("/knn", {"query": w, "k": 5}), eng.knn(w, 5),
                 f"/knn {w}")
            same(post("/knn_in", {"query": w, "k": 5, "targets": targets}),
                 eng.knn_in(w, 5, targets), f"/knn_in {w}")
        log(f"[server] /health, /knn x3, /knn_in x3 equal the engine "
            f"(device {health['device']})")
    finally:
        srv.stop()


def run_one_card(args) -> None:
    ph = Phases()
    with ph("gpu_tests"):
        run_gpu_tests()
    with ph("kernels_vs_xla"):
        compare_kernels(args.seed)
    with ph("data_and_build"):
        eng, words = build_engine(args.seed)
    with ph("ground_truth"):
        ev = eval_set(eng, words, args.seed)
    with ph("dispatch"):
        check_dispatch(eng)
    with ph("budget_vs_xla"):
        compare_budget(eng, ev["q"])
    with ph("families"):
        family_recalls(eng, ev)
    with ph("entry_points"):
        w = words[int(ev["ids"][0])]
        join_q = ev["join_q"]
        check(eng.knn(w, 5)[0][0] == w, "knn: a word is its own nearest")
        rows = eng.knn_batch([w, "w1"], 5)    # default: IVFADC batch
        check(len(rows) == 10, f"knn_batch rows {len(rows)}")
        eng.set_knn_batch_function("knn_batch_exact")
        rows = eng.knn_batch([w, "w1"], 5)
        check(rows[0][1] == w and rows[5][1] == "w1", "knn_batch exact")
        for fn in (eng.k_nearest_neighbour_pq, eng.k_nearest_neighbour_pq_pv,
                   eng.k_nearest_neighbour_ivfadc,
                   eng.k_nearest_neighbour_ivfadc_pv):
            res = fn(w, 5)
            check(len(res) == 5, f"{fn.__name__}: {res}")
        check(eng.k_nearest_neighbour_pq_pv(w, 5)[0][0] == w, "pq_pv self")
        res = eng.knn_in(w, 5, words[:1000] + [w])
        check(res[0][0] == w and len(res) == 5, f"knn_in: {res}")
        eng.set_knn_join_function("knn_in_ivpq_batch")
        eng.prepare_targets(ev["targets"], name="t100k")
        rows = eng.knn_join(join_q, 5, "t100k")
        check(len(rows) >= 5 * len(join_q) * 0.99,
              f"prepared join rows {len(rows)}")
        _, _, info = eng.ivpq.search_join(
            eng.store.vectors_for(join_q[:64]), 5, ev["tids"],
            vectors=eng.store.vectors_norm, return_info=True)
        check(info["impl"] == "budget", f"join impl {info['impl']}")
        check(eng.analogy("w1", "w0", "w2") == "w7", "planted analogy")
        check(eng.insert_batch(["w10 w20"]) == 1, "insert_batch")
        check(eng.knn("w10 w20", 3)[0][0] == "w10 w20",
              "knn finds the inserted term")
    with ph("server"):
        server_phase(eng, words)
    log(f"[phases] {json.dumps({k: round(v, 3) for k, v in ph.times.items()})}")


def run_four_cards(args) -> None:
    """The 3M engine sharded on make_mesh(rows=4, q=1) against the same
    engine on one card: the parity checks of ``__graft_entry__``."""
    import jax

    from postgres_word2vec.parallel import sharding

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices")
    ph = Phases()
    with ph("data_and_build"):
        eng, words = build_engine(args.seed, with_ivfadc=False)
    eng.set_knn_join_function("knn_in_ivpq_batch")
    eng.set_pv_shortlist("exact")     # the sharded PV shortlist is exact
    probe = [words[i] for i in (5, 77_777, 1_234_567)]
    targets = list(range(100_000))
    join_q = words[:1024]

    def answers():
        return dict(
            knn=[eng.knn(w, 10) for w in probe],
            pq=[eng.k_nearest_neighbour_pq(w, 10) for w in probe],
            pv=[eng.k_nearest_neighbour_pq_pv(w, 10) for w in probe],
            knn_in=[eng.knn_in(w, 10, targets) for w in probe],
            join=eng.knn_join(join_q, 5, targets))

    with ph("one_card"):
        base = answers()
    with ph("shard"):
        eng.enable_sharding(sharding.make_mesh(jax.devices()[:4], rows=4,
                                               q=1))
    with ph("four_cards"):
        got = answers()

    def words_of(rows):
        return [w for w, _ in rows]

    for fam in ("knn", "pv", "knn_in"):
        for a, b in zip(got[fam], base[fam]):
            check(words_of(a) == words_of(b), f"{fam}: {a} vs {b}")
    for a, b in zip(got["pq"], base["pq"]):
        check(set(words_of(a)) == set(words_of(b)), f"pq: {a} vs {b}")

    def by_query(rows):
        g: dict = {}
        for qw, w, _s in rows:
            g.setdefault(qw, set()).add(w)
        return g

    gj, bj = by_query(got["join"]), by_query(base["join"])
    agree = sum(len(gj.get(qw, set()) & bj[qw]) for qw in bj) / max(
        sum(len(s) for s in bj.values()), 1)
    log(f"[parity] knn, pq, pq_pv, knn_in equal on 4 cards; join "
        f"agreement {agree:.4f}")
    check(agree >= 0.99, f"join agreement {agree}")
    log(f"[phases] {json.dumps({k: round(v, 3) for k, v in ph.times.items()})}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (ROOT / "postgres_word2vec").is_dir():
        print("chip_smoke.py: the repository is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py: no GPU (platform {dev.platform})",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    log(card_line())
    log(f"jax {jax.__version__}; devices {jax.devices()}")
    if args.cards == 4:
        run_four_cards(args)
    else:
        run_one_card(args)
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    count = 4 if args.cards == 4 else len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

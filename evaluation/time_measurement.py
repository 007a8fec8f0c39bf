#!/usr/bin/env python3
"""Query-family timing harness (reference ``time_measurement.py`` /
``evaluation_utils.py main`` parity).

    python evaluation/time_measurement.py config/time_measurement.json

Methods (the reference's CLI set, evaluation_utils.py:390-456):
``default`` (single kNN per family), ``defaultpv`` (post-verified variants),
``sizedependend`` (exact vs PQ knn_in over growing random target-set sizes
``basis·n + k``, evaluation_utils.py:357-368), ``postverification`` (PQ/
IVFADC post-verified at growing shortlist factors ``basis·n + k``,
evaluation_utils.py:347-355), ``batch`` (batched IVFADC),
``batch-precision`` (batch + precision vs exact). Results printed as JSON.

Config keys for the sweep modes: ``resolution`` (number of sizes/factors,
default 10) and ``basis`` (step, default 100) — the reference CLI's
positional args.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import engine_from_config, sample_words

from postgres_word2vec.evaluation import (batch_measurement,
                                              calculate_precision,
                                              measurement)
from postgres_word2vec.utils.config import Configuration


def main(config_path: str) -> None:
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg)
    k = cfg.get_value_or("k", 5)
    n_q = cfg.get_value_or("query_sample", 20)
    method = cfg.get_value_or("method", "default")
    queries = sample_words(eng, n_q, cfg.get_value_or("seed", 0))

    out: dict = {"method": method, "k": k, "queries": len(queries)}
    if method == "default":
        for fn in ("k_nearest_neighbour", "k_nearest_neighbour_pq",
                   "k_nearest_neighbour_ivfadc"):
            res = measurement(eng, queries, k, fn)
            times = list(res["times"].values())
            out[fn] = {"mean_s": sum(times) / len(times)}
    elif method == "defaultpv":
        for fn in ("k_nearest_neighbour_pq_pv",
                   "k_nearest_neighbour_ivfadc_pv"):
            res = measurement(eng, queries, k, fn)
            times = list(res["times"].values())
            out[fn] = {"mean_s": sum(times) / len(times)}
    elif method == "sizedependend":
        # target-set sizes basis·n + k over one global id shuffle
        # (size_dependend_measurement, evaluation_utils.py:357-368).
        import numpy as np
        resolution = cfg.get_value_or("resolution", 10)
        basis = cfg.get_value_or("basis", 100)
        rng = np.random.default_rng(cfg.get_value_or("seed", 0))
        ids = rng.permutation(eng.store.size)
        out["sizes"] = {}
        for n_ in range(resolution):
            size = basis * n_ + k
            targets = [int(i) for i in ids[:size]]
            t_ex, t_pq, prec = [], [], []
            for w in queries:
                t0 = time.perf_counter()
                exact = eng.knn_in_exact(w, k, targets)
                t_ex.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                approx = eng.knn_in_pq(w, k, targets)
                t_pq.append(time.perf_counter() - t0)
                ex_set = {t for (t, _s) in exact}
                ap_set = {t for (t, _s) in approx}
                prec.append(len(ex_set & ap_set) / max(len(ex_set), 1))
            out["sizes"][size] = {
                "exact_mean_s": sum(t_ex) / len(t_ex),
                "pq_mean_s": sum(t_pq) / len(t_pq),
                "precision": sum(prec) / len(prec)}
    elif method == "postverification":
        # shortlist factors basis·n + k (post_verif_measurement,
        # evaluation_utils.py:347-355); the reference's factor is an
        # absolute candidate count — mapped to pvf = factor // k.
        resolution = cfg.get_value_or("resolution", 10)
        basis = cfg.get_value_or("basis", 100)
        exact = {w: eng.k_nearest_neighbour(w, k) for w in queries}
        saved_pvf = eng.params.pvf
        out["factors"] = {}
        try:
            for n_ in range(resolution):
                factor = basis * n_ + k
                eng.set_pvf(max(1, factor // k))
                row: dict = {}
                for fn in ("k_nearest_neighbour_pq_pv",
                           "k_nearest_neighbour_ivfadc_pv"):
                    res = measurement(eng, queries, k, fn)
                    times = list(res["times"].values())
                    prec = []
                    for w in queries:
                        ex_set = {t for (t, _s) in exact[w]}
                        ap_set = {t for (t, _s) in res["results"][w]}
                        prec.append(len(ex_set & ap_set)
                                    / max(len(ex_set), 1))
                    row[fn] = {"mean_s": sum(times) / len(times),
                               "precision": sum(prec) / len(prec)}
                out["factors"][factor] = row
        finally:
            eng.set_pvf(saved_pvf)
    elif method == "batch":
        b = batch_measurement(eng, queries, k)
        out["batch"] = {"time_s": b["time"], "per_query_s": b["per_query"]}
    elif method == "batch-precision":
        b = batch_measurement(eng, queries, k)
        exact = eng.knn_batch_exact(queries, k)
        out["batch"] = {"time_s": b["time"],
                        "precision": calculate_precision(b["results"],
                                                         exact)}
    else:
        raise SystemExit(f"unknown method {method!r}")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) != 2:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1])

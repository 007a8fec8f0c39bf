#!/usr/bin/env python3
"""Serving walkthrough: save an engine, serve it over HTTP, query it.

    JAX_PLATFORMS=cpu python examples/serving.py

Builds a small engine, persists it with ``Freddy.save``, starts the query
server in-process (the same runtime ``python -m postgres_word2vec.server
<dir>`` exposes), and exercises the endpoints — including the micro-batched
``/knn`` path, which coalesces concurrent single-query clients into one
device call (the reference's serving story is the Postgres backend itself;
this is the standalone equivalent).
"""

import json
import sys
import tempfile
import threading
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from postgres_word2vec.utils.config import init_compile_cache

init_compile_cache()

import numpy as np  # noqa: E402

from postgres_word2vec import Freddy, VectorStore  # noqa: E402
from postgres_word2vec.server import QueryServer  # noqa: E402


def post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())["result"]


def main() -> None:
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(2000)]
    store = VectorStore.from_arrays(
        words, rng.normal(size=(2000, 32)).astype(np.float32))
    eng = Freddy.build(store, seed=0, pq_m=8, pq_k=16, ivfadc_m=8,
                       ivfadc_k=16, k_coarse=20, ivpq_m=8, ivpq_k=16,
                       ivpq_k_coarse=8, train_size=None, iters=6)

    with tempfile.TemporaryDirectory() as d:
        eng.save(d)                      # durable engine artifact
        eng2 = Freddy.load(d)            # what the server CLI does
        eng2.warmup(join_targets=256)

        srv = QueryServer(eng2, port=0, batch_window_ms=5.0).start()
        print(f"serving on :{srv.port}")
        try:
            print("knn:", post(srv.port, "/knn", {"query": "w7", "k": 3}))

            # concurrent single-query clients — coalesced into one device
            # call by the /knn micro-batcher
            results = [None] * 8
            def one(j):
                results[j] = post(srv.port, "/knn",
                                  {"query": f"w{j}", "k": 2})
            threads = [threading.Thread(target=one, args=(j,))
                       for j in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert all(r[0][0] == f"w{j}" for j, r in enumerate(results))

            print("join:", post(srv.port, "/knn_join",
                                {"queries": ["w1", "w2"], "k": 2,
                                 "targets": [f"w{i}" for i in range(100)]}))
            post(srv.port, "/config", {"set_pvf": 10, "set_alpha": 5})
            print("insert:", post(srv.port, "/insert",
                                  {"terms": ["w1 w2"]}))
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/health") as r:
                h = json.loads(r.read())
            print("health:", {kk: h[kk] for kk in
                              ("vocab", "requests", "knn_batched_calls",
                               "knn_max_coalesced")})
        finally:
            srv.stop()
    print("serving example OK")


if __name__ == "__main__":
    main()

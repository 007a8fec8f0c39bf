"""Async (aiohttp) serving front end — parity with the threaded server."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from postgres_word2vec import Freddy, VectorStore
from postgres_word2vec.server_async import AsyncQueryServer


@pytest.fixture(scope="module")
def server():
    rng = np.random.default_rng(13)
    vecs = rng.normal(size=(300, 16)).astype(np.float32)
    store = VectorStore.from_arrays([f"w{i}" for i in range(300)], vecs)
    eng = Freddy.build(store, seed=0, pq_m=4, pq_k=8, ivfadc_m=4,
                       ivfadc_k=8, k_coarse=6, ivpq_m=4, ivpq_k=8,
                       ivpq_k_coarse=4, train_size=None, iters=5)
    srv = AsyncQueryServer(eng, port=0).start()
    yield srv
    srv.stop()


def _post(srv, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_async_health(server):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/health") as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["vocab"] == 300


def test_async_knn_word_and_vector(server):
    code, r = _post(server, "/knn", {"query": "w7", "k": 3})
    assert code == 200
    assert r["result"][0][0] == "w7"
    v = [0.1] * 16
    code, r2 = _post(server, "/knn", {"query": v, "k": 3})
    assert code == 200 and len(r2["result"]) == 3


def test_async_knn_concurrent_coalesce(server):
    """Concurrent /knn requests coalesce into shared device batches and
    every client gets its own correct answer."""
    results = {}

    def hit(i):
        _, r = _post(server, "/knn", {"query": f"w{i}", "k": 2})
        results[i] = r["result"]

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(12):
        assert results[i][0][0] == f"w{i}"
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/health") as r:
        h = json.loads(r.read())
    assert h["knn_items_done"] >= 12


def test_async_knn_in_and_join(server):
    targets = [f"w{i}" for i in range(40)]
    code, r = _post(server, "/knn_in",
                    {"query": "w3", "k": 3, "targets": targets})
    assert code == 200 and len(r["result"]) == 3
    code, r = _post(server, "/knn_join",
                    {"queries": ["w1", "w2"], "k": 2, "targets": targets})
    assert code == 200 and len(r["result"]) == 4
    code, r = _post(server, "/prepare_targets",
                    {"name": "dom", "targets": targets})
    assert code == 200 and r["result"]["size"] == 40
    code, r2 = _post(server, "/knn_join",
                     {"queries": ["w1", "w2"], "k": 2, "targets": "dom"})
    assert code == 200 and len(r2["result"]) == 4


def test_async_errors_and_config(server):
    code, r = _post(server, "/knn", {"query": "zzz-unknown", "k": 3})
    assert code == 400 and "error" in r
    code, r = _post(server, "/nope", {})
    assert code == 404
    code, r = _post(server, "/config", {"set_pvf": 11})
    assert code == 200 and r["result"]["applied"] == {"set_pvf": 11}
    assert server.engine.params.pvf == 11
    code, r = _post(server, "/analogy",
                    {"w1": "w1", "w2": "w2", "w3": "w3"})
    assert code == 200


def test_async_insert_and_tokenize(server):
    code, r = _post(server, "/insert", {"terms": ["w1 w2"]})
    assert code == 200 and r["result"]["inserted"] == 1
    code, r = _post(server, "/knn", {"query": "w1 w2", "k": 2})
    assert code == 200 and r["result"][0][0] == "w1 w2"
    code, r = _post(server, "/tokenize", {"text": "w3 w4"})
    assert code == 200 and len(r["result"]) == 16

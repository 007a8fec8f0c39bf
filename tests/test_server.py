import json
import urllib.request

import numpy as np
import pytest

from postgres_word2vec import Freddy, VectorStore
from postgres_word2vec.server import QueryServer


@pytest.fixture(scope="module")
def server():
    rng = np.random.default_rng(13)
    vecs = rng.normal(size=(300, 16)).astype(np.float32)
    store = VectorStore.from_arrays([f"w{i}" for i in range(300)], vecs)
    eng = Freddy.build(store, seed=0, pq_m=4, pq_k=8, ivfadc_m=4,
                       ivfadc_k=8, k_coarse=6, ivpq_m=4, ivpq_k=8,
                       ivpq_k_coarse=4, train_size=None, iters=5)
    srv = QueryServer(eng, port=0).start()
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


def test_health(server):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/health") as r:
        h = json.loads(r.read())
    assert h["status"] == "ok"
    assert h["vocab"] == 300
    assert h["indexes"]["pq"] is True


def test_knn_endpoint(server):
    code, out = _post(server, "/knn", {"query": "w10", "k": 3})
    assert code == 200
    rows = out["result"]
    assert rows[0][0] == "w10"
    assert len(rows) == 3


def test_knn_with_vector(server):
    v = np.asarray(server.engine.store.vector_for("w5")).tolist()
    code, out = _post(server, "/knn", {"query": v, "k": 2})
    assert code == 200
    assert out["result"][0][0] == "w5"


def test_join_and_config(server):
    code, out = _post(server, "/config", {"set_alpha": 50})
    assert code == 200 and out["result"]["applied"]["set_alpha"] == 50
    code, out = _post(server, "/knn_join",
                      {"queries": ["w1", "w2"], "k": 2,
                       "targets": [f"w{i}" for i in range(100)]})
    assert code == 200
    assert len(out["result"]) == 4


def test_analogy_tokenize_insert(server):
    code, out = _post(server, "/tokenize", {"text": "w1 w2"})
    assert code == 200 and len(out["result"]) == 16
    code, out = _post(server, "/insert", {"terms": ["w1 w2"]})
    assert code == 200 and out["result"]["inserted"] == 1
    code, out = _post(server, "/knn", {"query": "w1 w2", "k": 1})
    assert out["result"][0][0] == "w1 w2"


def test_error_paths(server):
    code, out = _post(server, "/nope", {})
    assert code == 404
    code, out = _post(server, "/knn", {"query": "missing_word", "k": 3})
    assert code == 400 and "KeyError" in out["error"]
    code, out = _post(server, "/config", {"set_bogus": 1})
    assert code == 404


def test_knn_microbatching_coalesces(server):
    """Concurrent /knn requests must coalesce into shared device calls and
    all return correct results."""
    import threading
    from postgres_word2vec.server import QueryServer

    srv = QueryServer(server.engine, port=0, batch_window_ms=60.0).start()
    try:
        results = [None] * 12

        def one(j):
            results[j] = _post(srv, "/knn", {"query": f"w{j}", "k": 3})

        threads = [threading.Thread(target=one, args=(j,))
                   for j in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for j, (code, r) in enumerate(results):
            assert code == 200
            assert r["result"][0][0] == f"w{j}"   # own nearest neighbor
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/health") as resp:
            health = json.loads(resp.read())
        assert health["knn_max_coalesced"] >= 2
        assert health["knn_batched_calls"] < 12
    finally:
        srv.stop()


def test_knn_microbatch_isolates_bad_items(server):
    """One unknown word in a coalesced batch must fail ONLY its own
    request — concurrent valid queries still get 200s (round-2 review)."""
    import threading
    from postgres_word2vec.server import QueryServer

    srv = QueryServer(server.engine, port=0, batch_window_ms=60.0).start()
    try:
        results = [None] * 6

        def one(j):
            q = "definitely_not_a_word" if j == 2 else f"w{j}"
            results[j] = _post(srv, "/knn", {"query": q, "k": 3})

        threads = [threading.Thread(target=one, args=(j,))
                   for j in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for j, (code, r) in enumerate(results):
            if j == 2:
                assert code == 400 and "KeyError" in r["error"]
            else:
                assert code == 200
                assert r["result"][0][0] == f"w{j}"
    finally:
        srv.stop()


def test_knn_microbatch_honors_dispatch(server):
    """The micro-batched /knn must run the dispatched family, not a
    hardcoded exact fallback (round-2 review)."""
    eng = server.engine
    old = eng.dispatch["knn"]
    try:
        eng.set_knn_function("k_nearest_neighbour_pq_pv")
        code, out = _post(server, "/knn", {"query": "w10", "k": 3})
        assert code == 200
        assert out["result"][0][0] == "w10"
        # unknown-to-the-batcher dispatch values must raise, not silently
        # degrade to exact
        eng.dispatch["knn"] = "bogus_impl"
        with pytest.raises(KeyError):
            eng.knn_matrix(eng.store.vectors_norm[:1], 2)
    finally:
        eng.dispatch["knn"] = old


def test_mixed_word_and_vector_coalesced_batch(server):
    """Word-id and raw-vector queries coalesced into one micro-batch run
    as SEPARATE device groups (word group: device gather; raw group: host
    rows shipped with the dispatch) and each slot gets its own answer."""
    v5 = np.asarray(server.engine.store.vector_for("w5")).tolist()
    out = server.runner._run_knn_batch([("w3", 2), (np.asarray(v5), 2),
                                        ("w9", 2), (np.asarray(v5), 3)])
    assert out[0][0][0] == "w3"
    assert out[1][0][0] == "w5"      # raw vector of w5 → w5 is its own NN
    assert out[2][0][0] == "w9"
    assert out[3][0][0] == "w5" and len(out[3]) == 3


def test_malformed_vector_fails_only_its_slot(server):
    """A wrong-dimension vector query must 400 alone, not poison the
    coalesced batch (cross-client isolation)."""
    out = server.runner._run_knn_batch([("w5", 2), ([0.1, 0.2], 2), ("w6", 2)])
    assert not isinstance(out[0], Exception)
    assert isinstance(out[1], Exception)
    assert not isinstance(out[2], Exception)


def test_save_load_persists_exact_config(tmp_path):
    import numpy as np

    from postgres_word2vec import Freddy, VectorStore

    rng = np.random.default_rng(3)
    store = VectorStore.from_arrays(
        [f"w{i}" for i in range(40)],
        rng.normal(size=(40, 8)).astype(np.float32))
    eng = Freddy.build(store, with_pq=False, with_ivfadc=False,
                       with_ivpq=False, train_size=None,
                       exact_dtype="bfloat16", exact_approx=True)
    eng.save(tmp_path / "eng")
    eng2 = Freddy.load(tmp_path / "eng")
    assert eng2.exact.compute_dtype == "bfloat16"
    assert eng2.exact.approx is True
    # insert_batch keeps the production config too
    eng2.insert_batch(["w1 w2"])
    assert eng2.exact.approx is True
    assert eng2.exact.compute_dtype == "bfloat16"


def test_knn_in_microbatching_coalesces(server):
    """Concurrent /knn_in requests against the SAME target set must group
    into one batched in-set device call (VERDICT r2 item 10) and return the
    same rows as the direct engine call."""
    import threading

    from postgres_word2vec.server import QueryServer

    srv = QueryServer(server.engine, port=0, batch_window_ms=60.0).start()
    try:
        targets = [f"w{i}" for i in range(40)]
        want = {j: server.engine.knn_in(f"w{j}", 3, targets)
                for j in range(8)}
        results = [None] * 8

        def one(j):
            results[j] = _post(srv, "/knn_in",
                               {"query": f"w{j}", "k": 3,
                                "targets": targets})

        threads = [threading.Thread(target=one, args=(j,))
                   for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for j, (code, r) in enumerate(results):
            assert code == 200
            got = [(w, pytest.approx(s, abs=1e-5)) for w, s in r["result"]]
            assert [w for w, _ in got] == [w for w, _ in want[j]]
        b = srv._knn_in_batcher
        assert b.batched_calls < 8          # coalescing happened
    finally:
        srv.stop()


def test_knn_in_microbatch_mixed_targets_and_bad_items(server):
    """Different target sets in one coalesced batch run as separate groups;
    an unknown query word fails only its own slot; an unsupported dispatch
    impl (IVPQ) falls back to per-item calls and still answers."""
    import threading

    from postgres_word2vec.server import QueryServer

    srv = QueryServer(server.engine, port=0, batch_window_ms=60.0).start()
    try:
        t1 = [f"w{i}" for i in range(30)]
        t2 = [f"w{i}" for i in range(30, 80)]
        payloads = [
            {"query": "w1", "k": 3, "targets": t1},
            {"query": "w2", "k": 3, "targets": t2},
            {"query": "no_such_word", "k": 3, "targets": t1},
        ]
        results = [None] * 3

        def one(j):
            results[j] = _post(srv, "/knn_in", payloads[j])

        threads = [threading.Thread(target=one, args=(j,))
                   for j in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results[0][0] == 200
        assert all(w in t1 for w, _ in results[0][1]["result"])
        assert results[1][0] == 200
        assert all(w in t2 for w, _ in results[1][1]["result"])
        assert results[2][0] == 400         # only the bad slot fails

        # IVPQ dispatch has no matrix core → per-item fallback path
        server.engine.set_knn_in_function("knn_in_ivpq")
        try:
            code, out = _post(srv, "/knn_in",
                              {"query": "w3", "k": 2, "targets": t1})
            assert code == 200 and len(out["result"]) == 2
        finally:
            server.engine.set_knn_in_function("knn_in_exact")
    finally:
        srv.stop()


def test_prepare_targets_endpoint(server):
    targets = [f"w{i}" for i in range(50)]
    code, r = _post(server, "/prepare_targets",
                    {"name": "dom", "targets": targets})
    assert code == 200 and r["result"]["size"] == 50
    code, adhoc = _post(server, "/knn_join",
                        {"queries": ["w1", "w2"], "k": 3,
                         "targets": targets})
    code2, named = _post(server, "/knn_join",
                         {"queries": ["w1", "w2"], "k": 3,
                          "targets": "dom"})
    assert code == code2 == 200
    assert adhoc["result"] == named["result"]

import numpy as np
import pytest

from postgres_word2vec import Freddy, VectorStore
from postgres_word2vec.models.ivpq import EXACT_CALC


def _make_store(n=400, d=24, seed=11):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    # plant an analogy parallelogram: king - man + woman = queen
    royal = rng.normal(size=d).astype(np.float32) * 2
    g_m = rng.normal(size=d).astype(np.float32) * 2
    g_f = rng.normal(size=d).astype(np.float32) * 2
    vecs[0] = g_m                 # man
    vecs[1] = g_f                 # woman
    vecs[2] = royal + g_m         # king
    vecs[3] = royal + g_f + 0.01  # queen
    words = ["man", "woman", "king", "queen"] + [
        f"w{i}" for i in range(4, n)]
    return VectorStore.from_arrays(words, vecs)


@pytest.fixture(scope="module")
def engine():
    store = _make_store()
    return Freddy.build(store, seed=0, pq_m=6, pq_k=16, ivfadc_m=6,
                        ivfadc_k=16, k_coarse=10, ivpq_m=6, ivpq_k=8,
                        ivpq_k_coarse=4, train_size=None, iters=8)


def test_knn_exact_returns_self_first(engine):
    res = engine.knn("w10", 5)
    assert res[0][0] == "w10"
    assert res[0][1] == pytest.approx(1.0, abs=1e-4)
    sims = [s for _, s in res]
    assert sims == sorted(sims, reverse=True)


def test_knn_with_vector_query(engine):
    v = np.asarray(engine.store.vector_for("w10"))
    res = engine.knn(v, 3)
    assert res[0][0] == "w10"


def test_knn_dispatch_pq(engine):
    engine.set_knn_function("k_nearest_neighbour_pq")
    try:
        res = engine.knn("w10", 5)
        assert len(res) == 5
    finally:
        engine.set_knn_function("k_nearest_neighbour")


def test_knn_pq_pv_close_to_exact(engine):
    exact = {w for w, _ in engine.k_nearest_neighbour("w20", 10)}
    pv = {w for w, _ in engine.k_nearest_neighbour_pq_pv("w20", 10)}
    assert len(exact & pv) >= 6


def test_knn_ivfadc(engine):
    res = engine.k_nearest_neighbour_ivfadc("w30", 5)
    assert res[0][0] == "w30"


def test_knn_in(engine):
    res = engine.knn_in("w10", 3, ["w20", "w30", "w40", "w50"])
    assert len(res) == 3
    assert {w for w, _ in res} <= {"w20", "w30", "w40", "w50"}


def test_knn_in_with_ids(engine):
    res = engine.knn_in("w10", 2, [20, 30, 40])
    assert {w for w, _ in res} <= {"w20", "w30", "w40"}


def test_knn_batch(engine):
    rows = engine.knn_batch(["w10", "w20"], 3)
    qs = {q for q, _, _ in rows}
    assert qs == {"w10", "w20"}
    assert len(rows) == 6


def test_knn_join_exact(engine):
    targets = [f"w{i}" for i in range(4, 104)]
    rows = engine.knn_join(["w10", "w20", "w30"], 2, targets)
    assert len(rows) == 6
    for q, t, s in rows:
        assert t in targets


def test_knn_join_ivpq_matches_exact_with_method1(engine):
    engine.set_method_flag(EXACT_CALC)
    engine.set_alpha(10**6)
    try:
        targets = [f"w{i}" for i in range(4, 204)]
        exact = engine.knn_search_in_batch(["w10", "w20"], 3, targets)
        ivpq = engine.knn_in_ivpq_batch(["w10", "w20"], 3, targets)
        assert {(q, t) for q, t, _ in exact} == {(q, t) for q, t, _ in ivpq}
    finally:
        engine.set_method_flag(0)
        engine.set_alpha(3)


def test_analogy_3cosadd(engine):
    assert engine.analogy("man", "woman", "king") == "queen"


def test_analogy_3cosmul(engine):
    assert engine.analogy_3cosmul("man", "woman", "king") == "queen"


def test_analogy_in(engine):
    got = engine.analogy_in("man", "woman", "king",
                            ["queen", "w10", "w20"])
    assert got == "queen"


def test_analogy_accelerated(engine):
    assert engine.analogy_3cosadd_pq("man", "woman", "king") == "queen"
    assert engine.analogy_3cosadd_ivfadc("man", "woman", "king") == "queen"
    assert engine.analogy_3cosadd_in_pq(
        "man", "woman", "king", ["queen", "w10", "w20", "w30"]) == "queen"
    assert engine.analogy_3cosadd_in_ivpq(
        "man", "woman", "king", ["queen", "w10", "w20", "w30"]) == "queen"


def test_analogy_pair_direction_runs(engine):
    res = engine.analogy_pair_direction("man", "woman", "king")
    assert isinstance(res, str) and res not in {"man", "woman", "king"}


def test_grouping(engine):
    rows = engine.groups(["w10", "w20", "w30"], ["w40", "w50"])
    assert len(rows) == 3
    for tok, grp in rows:
        assert grp in {"w40", "w50"}
    # PQ variant agrees mostly with exact on an easy instance
    rows_pq = engine.grouping_func_pq(["w10", "w20", "w30"], ["w40", "w50"])
    assert len(rows_pq) == 3


def test_cluster(engine):
    tokens = [f"w{i}" for i in range(4, 44)]
    rows = engine.cluster(tokens, 3)
    assert len(rows) == 40
    clusters = {c for _, c in rows}
    assert clusters <= {1, 2, 3}
    assert len(clusters) >= 2


def test_tokenize(engine):
    v = engine.tokenize("w10 w20")
    assert v is not None
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-5)
    raw = engine.tokenize_raw("w10 w20")
    want = (np.asarray(engine.store.vector_for("w10", normalized=False))
            + np.asarray(engine.store.vector_for("w20",
                                                 normalized=False))) / 2
    np.testing.assert_allclose(raw, want, rtol=1e-5)
    assert engine.tokenize("zzz_unknown") is None


def test_create_statistics_and_use(engine):
    domain = [f"w{i}" for i in range(4, 104)]
    engine.create_statistics("stat_test", domain)
    assert engine.params.statistics_table == "stat_test"
    s = np.asarray(engine.statistics["stat_test"])
    assert s.shape == (engine.ivpq.num_cells + 1,)
    assert s[-1] == 100
    rows = engine.knn_in_ivpq_batch(["w10"], 3, domain)
    assert len(rows) == 3
    engine.set_statistics_table(None)


def test_set_statistics_table_unknown_raises(engine):
    with pytest.raises(KeyError):
        engine.set_statistics_table("nope")


def test_insert_batch(engine):
    n0 = engine.store.size
    inserted = engine.insert_batch(["w10 w20", "w10", "totally unknown"])
    # "w10" is an existing word?  No — terms are inserted as whole strings;
    # "w10" exists in the vocab so it is skipped; "w10 w20" is new;
    # "totally unknown" has no known words → skipped.
    assert inserted == 1
    assert engine.store.size == n0 + 1
    assert "w10 w20" in engine.store
    # the new term is searchable through every index
    res = engine.knn("w10 w20", 3)
    assert res[0][0] == "w10 w20"
    res_pq = engine.k_nearest_neighbour_pq("w10 w20", 3)
    assert len(res_pq) == 3


def test_missing_index_raises():
    store = _make_store(50)
    f = Freddy(store)
    with pytest.raises(RuntimeError):
        f.k_nearest_neighbour_pq("w10", 3)
    # exact paths still work
    assert f.knn("w10", 2)[0][0] == "w10"


def test_engine_save_load_roundtrip(engine, tmp_path):
    engine.set_alpha(42)
    engine.create_statistics("roundtrip_stat", [f"w{i}" for i in range(50)])
    engine.save(tmp_path / "engine")
    eng2 = Freddy.load(tmp_path / "engine")
    try:
        assert eng2.params.alpha == 42
        assert eng2.params.statistics_table == "roundtrip_stat"
        assert "roundtrip_stat" in eng2.statistics
        assert eng2.store.size == engine.store.size
        # indexes functional after reload
        r1 = engine.k_nearest_neighbour_pq("w10", 5)
        r2 = eng2.k_nearest_neighbour_pq("w10", 5)
        assert [w for w, _ in r1] == [w for w, _ in r2]
        r3 = eng2.knn_in_ivpq_batch(["w10"], 3, [f"w{i}" for i in range(100)])
        assert len(r3) == 3
    finally:
        engine.set_alpha(3)
        engine.set_statistics_table(None)


def test_warmup_runs(engine):
    engine.warmup(k=3, join_targets=64, query_chunk=8)


def test_build_preset_quality():
    """preset='quality' applies the bundle (4-bit OPQ PQ + 4-bit IVFADC
    residuals); explicit kwargs win over the preset; unknown preset raises."""
    store = _make_store(n=300, d=120)   # d % 60 == 0 for the 60x16 regime
    eng = Freddy.build(store, preset="quality", k_coarse=8,
                       ivpq_k_coarse=4, train_size=None, iters=3)
    assert eng.pq.codebook.centroids.shape[:2] == (60, 16)
    assert eng.pq.rotation is not None          # OPQ on
    assert eng.ivfadc.codebook.centroids.shape[:2] == (60, 16)
    assert eng.ivpq.codebook.centroids.shape[:2] == (60, 16)
    res = eng.knn("w10", 3)
    assert res[0][0] == "w10"

    # explicit kwarg overrides the preset value
    eng2 = Freddy.build(store, preset="quality", pq_m=6, pq_k=8,
                        with_ivfadc=False, with_ivpq=False,
                        train_size=None, iters=2)
    assert eng2.pq.codebook.centroids.shape[:2] == (6, 8)

    with pytest.raises(ValueError, match="unknown preset"):
        Freddy.build(store, preset="best")


def test_chunked_q_ragged_tail(engine):
    """_chunked_q pads the ragged final chunk to the compiled shape and
    must slice the padding back off after the one batched host transfer."""
    import jax.numpy as jnp

    def fn(q):
        d = jnp.sum(q * q, axis=-1, keepdims=True) + jnp.arange(3.0)[None]
        i = jnp.broadcast_to(jnp.arange(3, dtype=jnp.int32)[None],
                             (q.shape[0], 3))
        return d, i

    q = np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32)
    d, i = engine._chunked_q(jnp.asarray(q), fn, chunk=4)
    want_d, want_i = fn(jnp.asarray(q))
    assert d.shape == (10, 3) and i.shape == (10, 3)
    np.testing.assert_allclose(np.asarray(d), np.asarray(want_d), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(want_i))


def test_set_pv_shortlist(engine):
    """PV shortlist knob: validated values, plumbed through the PV knn
    core, and CPU results stay identical (the CPU reference answers
    approximate top-k requests exactly)."""
    import pytest

    engine.set_knn_function("k_nearest_neighbour_pq_pv")
    base = engine.knn("w100", 5)
    for policy in ("approx", "exact", "auto"):
        engine.set_pv_shortlist(policy)
        assert engine.knn("w100", 5) == base, policy
    with pytest.raises(ValueError):
        engine.set_pv_shortlist("fast")
    engine.set_knn_function("k_nearest_neighbour")


def test_warmup_covers_each_family(engine, monkeypatch):
    """warmup() precompiles the PQ scan with the impl serving resolves
    (None: the backend's plan) and touches every built family."""
    calls = []
    orig = type(engine.pq).search

    def spy(self, q, k, **kw):
        calls.append(kw.get("impl"))
        return orig(self, q, k, **kw)

    monkeypatch.setattr(type(engine.pq), "search", spy)
    engine.warmup(k=2, join_targets=16)
    assert calls and all(c is None for c in calls)


def test_join_impl_resolution(engine, monkeypatch):
    """One decision for the join's distance phase: dense on the CPU
    reference, budget when the kernels run, dense without target lists."""
    from postgres_word2vec.ops import backend

    ivpq = engine.ivpq
    assert ivpq.join_impl() == "dense"
    monkeypatch.setattr(backend, "use_kernels", lambda: True)
    assert ivpq.join_impl() == "budget"
    assert ivpq.join_impl(use_targetlists=False) == "dense"
    assert ivpq.join_impl("dense") == "dense"
    import pytest
    with pytest.raises(ValueError):
        ivpq.join_impl("pallas")


def test_autotune_selects_and_applies(engine):
    """autotune: exact meets any target; report is sorted by time; the
    winner's dispatch + params are installed; a recall=1.0 target must
    choose a config with perfect measured recall."""
    import dataclasses as _dc

    saved_params = _dc.asdict(engine.params)
    report = engine.autotune(target_recall=1.0, k=5, sample=32)
    assert report and report == sorted(report, key=lambda r: r["seconds"])
    families = {r["name"] for r in report}
    assert {"k_nearest_neighbour", "k_nearest_neighbour_pq",
            "k_nearest_neighbour_ivfadc"} <= families
    chosen = engine.dispatch["knn"]
    winners = [r for r in report if r["meets_target"]]
    assert winners and chosen == winners[0]["name"]
    assert winners[0].get("chosen") is True
    # restore dispatch AND params for the other module-scoped tests
    engine.set_knn_function("k_nearest_neighbour")
    for kk, vv in saved_params.items():
        setattr(engine.params, kk, vv)


def test_autotune_no_apply_leaves_dispatch(engine):
    before = dict(engine.dispatch)
    pvf_before = engine.params.pvf
    engine.autotune(target_recall=0.1, k=5, sample=16, apply=False)
    assert engine.dispatch == before
    assert engine.params.pvf == pvf_before


def test_autotune_join_selects_and_applies(engine):
    """autotune_join (VERDICT r3 item 9): sweeps the IVPQ join's
    alpha/pvf/method grid vs in-set exact ground truth, reports sorted
    fastest-first, and installs the winner's dispatch + global params."""
    import dataclasses as _dc

    saved_params = _dc.asdict(engine.params)
    saved_dispatch = dict(engine.dispatch)
    try:
        report = engine.autotune_join(target_recall=1.0, k=3, sample=16,
                                      target_sample=200,
                                      alphas=(20, 50), pvfs=(10,))
        assert report == sorted(report, key=lambda r: r["seconds"])
        names = {r["name"] for r in report}
        assert "knn_search_in_batch" in names
        assert "knn_in_ivpq_batch" in names
        methods = {r["params"].get("method") for r in report
                   if r["name"] == "knn_in_ivpq_batch"}
        assert methods == {0, 1, 2}
        winners = [r for r in report if r["meets_target"]]
        assert winners, "exact baseline always meets recall 1.0"
        best = winners[0]
        assert best.get("chosen") is True
        assert engine.dispatch["knn_join"] == best["name"]
        for p, v in best["params"].items():
            assert getattr(engine.params, p) == v
        # the installed configuration must actually serve joins
        # (vocab: ids 0-3 are man/woman/king/queen, then w4, w5, ...)
        rows = engine.knn_join(["w4", "w5"], 3,
                               [f"w{i}" for i in range(4, 54)])
        assert len(rows) == 6
    finally:
        engine.dispatch.update(saved_dispatch)
        for kk, vv in saved_params.items():
            setattr(engine.params, kk, vv)


def test_autotune_join_no_apply(engine):
    before = dict(engine.dispatch)
    alpha_before = engine.params.alpha
    engine.autotune_join(target_recall=0.0, k=3, sample=8,
                         target_sample=100, alphas=(20,), pvfs=(10,),
                         apply=False)
    assert engine.dispatch == before
    assert engine.params.alpha == alpha_before


def test_prepare_targets_handle_and_name(engine):
    """Engine-level prepared target sets: handle and registered-name calls
    must match the ad-hoc join exactly, for every join family."""
    targets = [f"w{i}" for i in range(4, 304)]
    adhoc = engine.knn_in_ivpq_batch(["w10", "w20"], 3, targets)
    ph = engine.prepare_targets(targets, name="dom")
    assert ph.size == len(targets)
    via_handle = engine.knn_in_ivpq_batch(["w10", "w20"], 3, ph)
    via_name = engine.knn_in_ivpq_batch(["w10", "w20"], 3, "dom")
    assert adhoc == via_handle == via_name
    # exact + PQ joins accept the handle too (id reuse)
    ex1 = engine.knn_search_in_batch(["w10"], 3, targets)
    ex2 = engine.knn_search_in_batch(["w10"], 3, "dom")
    assert ex1 == ex2
    pq1 = engine.knn_in_pq_batch(["w10"], 3, targets)
    pq2 = engine.knn_in_pq_batch(["w10"], 3, ph)
    assert pq1 == pq2
    with pytest.raises(KeyError, match="no prepared target set"):
        engine.knn_in_ivpq_batch(["w10"], 3, "unknown-name")


def test_insert_batch_incremental_exact_int8():
    """insert_batch with the production int8 exact index: O(batch)
    extension must keep the new terms searchable and never leak capacity
    padding rows; repeated inserts reuse capacity (amortized growth)."""
    store = _make_store(400)
    eng = Freddy.build(store, seed=0, with_pq=False, with_ivfadc=False,
                       with_ivpq=False, exact_dtype="int8",
                       exact_approx=False)
    assert eng.insert_batch(["w10 w20"]) == 1
    cap1 = eng.exact._table.shape[0]
    res = eng.knn("w10 w20", 3)
    assert res[0][0] == "w10 w20"
    assert eng.insert_batch(["w11 w21", "w12 w22"]) == 2
    assert eng.exact._table.shape[0] == cap1      # no regrow
    assert eng.exact._size == 403
    # all results map to real vocab rows (no padding leakage)
    for w, _s in eng.knn("w12 w22", 5):
        assert w in eng.store

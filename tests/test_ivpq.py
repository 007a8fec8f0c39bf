import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats as sps

from postgres_word2vec.models import ivpq as ivpq_mod
from postgres_word2vec.models.ivpq import (EXACT_CALC, IVPQIndex, PQ_CALC,
                                               PQ_PV_CALC, confidence_hyp)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(4000, 24)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


@pytest.fixture(scope="module")
def idx(dataset):
    return IVPQIndex.build(jax.random.PRNGKey(2), jnp.asarray(dataset),
                           m=6, k=16, k_coarse=8, coarse_positions=2,
                           train_size=None, iters=8)


def _exact_join(q, v, targets, k):
    d = ((q[:, None, :] - v[targets][None, :, :]) ** 2).sum(-1)
    order = np.argsort(d, -1)[:, :k]
    return targets[order]


def test_confidence_matches_closed_form():
    # compare against the reference formula evaluated with scipy's erf-free
    # normal CDF: conf = 1 - Phi((expect-0.5-mu)/sig)
    for expect, size, p, stat in [(10, 1000, 0.05, 4000),
                                  (5, 200, 0.5, 4000), (3, 50, 0.01, 4000)]:
        mu = size * p
        sig = np.sqrt(size * p * (1 - p)) * ((stat - size) / (stat - 1))
        want = 1.0 - sps.norm.cdf((expect - 0.5 - mu) / sig)
        got = float(confidence_hyp(expect, size, p, stat))
        np.testing.assert_allclose(got, want, atol=1e-5)
    # expect > size → 0
    assert float(confidence_hyp(100, 50, 0.5, 4000)) == 0.0
    # p = 0 → sig 0, mu 0 → step: conf 0 for positive expect
    assert float(confidence_hyp(5, 100, 0.0, 4000)) == 0.0


def test_cell_assignment_combination(idx, dataset):
    cells = np.asarray(idx.cell_of)
    assert cells.min() >= 0 and cells.max() < idx.num_cells
    # recompute by hand from the coarse centroids
    c = np.asarray(idx.coarse.centroids)  # (2, 8, 12)
    v = dataset
    c0 = ((v[:, None, :12] - c[0][None]) ** 2).sum(-1).argmin(-1)
    c1 = ((v[:, None, 12:] - c[1][None]) ** 2).sum(-1).argmin(-1)
    np.testing.assert_array_equal(cells, c0 + 8 * c1)


def test_cell_distances_ordering(idx, dataset):
    q = jnp.asarray(dataset[:5])
    cd = np.asarray(ivpq_mod.cell_distances(q, idx.coarse.centroids))
    assert cd.shape == (5, 64)
    # own cell should be among the nearest few for a db vector
    own = np.asarray(idx.cell_of)[:5]
    ranks = np.argsort(np.argsort(cd, -1), -1)
    assert (ranks[np.arange(5), own] < 5).all()


def test_method1_with_high_alpha_is_exact(idx, dataset):
    """method=1 (exact distances) + huge alpha (select all cells) must equal
    brute force within the target set — the reference's own ground-truth
    recipe (ivpq_evaluation.py:33-43)."""
    rng = np.random.default_rng(0)
    q = dataset[:10]
    targets = rng.choice(4000, size=500, replace=False).astype(np.int32)
    d, i = idx.search_join(jnp.asarray(q), 5, jnp.asarray(targets),
                           vectors=jnp.asarray(dataset), alpha=10**6,
                           method=EXACT_CALC, confidence=0.99)
    want = _exact_join(q, dataset, targets, 5)
    np.testing.assert_array_equal(np.asarray(i), want)


def test_methods_recall_ordering(idx, dataset):
    rng = np.random.default_rng(1)
    q = dataset[:40]
    targets = rng.choice(4000, size=1000, replace=False).astype(np.int32)
    want = _exact_join(q, dataset, targets, 5)

    def recall(method, alpha, pvf=10):
        d, i = idx.search_join(jnp.asarray(q), 5, jnp.asarray(targets),
                               vectors=jnp.asarray(dataset), alpha=alpha,
                               pvf=pvf, method=method, confidence=0.8)
        return sum(len(set(a) & set(e))
                   for a, e in zip(np.asarray(i), want)) / want.size

    r_adc = recall(PQ_CALC, 100)
    r_pv = recall(PQ_PV_CALC, 100)
    r_exact = recall(EXACT_CALC, 100)
    assert r_exact >= r_pv - 0.02
    assert r_pv >= r_adc - 0.02
    # random data has no cluster structure, so cell probing at moderate
    # alpha caps recall well below 1.0 — these are sanity floors, the
    # exact-parity guarantee is test_method1_with_high_alpha_is_exact.
    assert r_exact > 0.6
    assert r_pv > 0.45


def test_alpha_increases_candidates(idx, dataset):
    """larger alpha → more cells probed → recall must not drop."""
    rng = np.random.default_rng(2)
    q = dataset[:30]
    targets = rng.choice(4000, size=800, replace=False).astype(np.int32)
    want = _exact_join(q, dataset, targets, 5)

    def recall(alpha):
        _, i = idx.search_join(jnp.asarray(q), 5, jnp.asarray(targets),
                               vectors=jnp.asarray(dataset), alpha=alpha,
                               method=PQ_CALC, confidence=0.8, max_rounds=1)
        return sum(len(set(a) & set(e))
                   for a, e in zip(np.asarray(i), want)) / want.size

    assert recall(100) >= recall(1) - 0.05


def test_escalation_fills_k(idx, dataset):
    """tiny alpha with escalation must still return k real neighbors."""
    rng = np.random.default_rng(3)
    q = dataset[:8]
    targets = rng.choice(4000, size=100, replace=False).astype(np.int32)
    d, i = idx.search_join(jnp.asarray(q), 5, jnp.asarray(targets),
                           vectors=jnp.asarray(dataset), alpha=1,
                           method=PQ_CALC, confidence=0.9)
    assert (np.asarray(i) >= 0).all()


def test_statistics_shape_and_usage(idx, dataset):
    domain = jnp.arange(0, 4000, 3, dtype=jnp.int32)
    stats = ivpq_mod.build_statistics(idx.cell_of, domain, idx.num_cells)
    s = np.asarray(stats)
    assert s.shape == (65,)
    np.testing.assert_allclose(s[:64].sum(), 1.0, rtol=1e-5)
    assert s[64] == len(domain)
    # search works with explicit statistics
    q = dataset[:4]
    targets = np.arange(0, 4000, 3, dtype=np.int32)
    d, i = idx.search_join(jnp.asarray(q), 3, jnp.asarray(targets),
                           statistics=stats, alpha=20, method=PQ_CALC)
    assert (np.asarray(i) >= 0).all()


def test_double_codes_equal_normal(idx, dataset):
    """long_codes_threshold=0 forces fused-pair LUTs; distances identical."""
    rng = np.random.default_rng(4)
    q = dataset[:6]
    targets = rng.choice(4000, size=300, replace=False).astype(np.int32)
    d1, i1 = idx.search_join(jnp.asarray(q), 5, jnp.asarray(targets),
                             alpha=10**6, method=PQ_CALC,
                             long_codes_threshold=1e12)
    d2, i2 = idx.search_join(jnp.asarray(q), 5, jnp.asarray(targets),
                             alpha=10**6, method=PQ_CALC,
                             long_codes_threshold=0)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-4,
                               atol=1e-5)


def test_add_and_roundtrip(idx, dataset, tmp_path):
    rng = np.random.default_rng(6)
    new = rng.normal(size=(4, 24)).astype(np.float32)
    new /= np.linalg.norm(new, axis=-1, keepdims=True)
    idx2 = idx.add(jnp.asarray(new))
    assert idx2.size == idx.size + 4
    assert np.asarray(idx2.coarse.cell_counts).sum() == 4004
    p = tmp_path / "ivpq.npz"
    idx2.save(p)
    idx3 = IVPQIndex.load(p)
    np.testing.assert_array_equal(np.asarray(idx3.codes),
                                  np.asarray(idx2.codes))


def test_build_join_tiles_structure(idx, dataset):
    from postgres_word2vec.models.ivpq import build_join_tiles

    T = 900
    tids = jnp.arange(T, dtype=jnp.int32)
    mask = np.ones(T, bool)
    mask[5] = mask[100] = False
    codes = jnp.take(idx.codes, tids, axis=0)
    cells = jnp.take(idx.cell_of, tids)
    jt = build_join_tiles(codes, cells, jnp.asarray(mask),
                          jnp.asarray(dataset[:T]), block_t=128,
                          num_cells=idx.num_cells, with_vecs=True)
    lids = np.asarray(jt.local_ids)
    rt = np.asarray(jt.rowterm)
    # every valid target appears exactly once with rowterm 0
    placed = lids[lids >= 0]
    assert sorted(placed.tolist()) == sorted(np.nonzero(mask)[0].tolist())
    assert (rt[lids >= 0] == 0.0).all()
    assert np.isinf(rt[lids < 0]).all()
    # placed rows carry their own codes, grouped by cell within tiles
    codes_np = np.asarray(codes)
    cells_np = np.asarray(cells)
    codes_al = np.asarray(jt.codes)
    tile_start = np.asarray(jt.tile_start)
    tile_cnt = np.asarray(jt.tile_cnt)
    pos = np.nonzero(lids >= 0)[0]
    for p in pos[:50]:
        t = lids[p]
        np.testing.assert_array_equal(codes_al[p], codes_np[t])
        tile = p // 128
        c = cells_np[t]
        assert tile_start[c] <= tile < tile_start[c] + tile_cnt[c]
    # tile_rows accounting
    assert int(np.asarray(jt.tile_rows).sum()) == int(mask.sum())
    assert int(np.asarray(jt.t_real)) == int(mask.sum())


@pytest.mark.parametrize("method", [0, 1, 2])
def test_budget_join_matches_dense(idx, dataset, method):
    """With an ample tile budget the selectivity-proportional path must
    reproduce the dense path's results for every distance method."""
    T = 1200
    tids = jnp.arange(T, dtype=jnp.int32)
    q = jnp.asarray(dataset[:12])
    kw = dict(alpha=20, method=method, confidence=0.8,
              vectors=jnp.asarray(dataset))
    vd, idn = idx.search_join(q, 5, tids, impl="dense", **kw)
    vb, idb = idx.search_join(q, 5, tids, impl="budget",
                              budget_tiles=64, **kw)
    # method 1 stores target vectors bf16 in the tiled layout (f32 norms
    # keep the error ~1e-3 like exact_top_k_precast).
    rtol = 5e-3 if method == 1 else 1e-4
    np.testing.assert_allclose(np.asarray(vb), np.asarray(vd), rtol=rtol,
                               atol=5e-3 if method == 1 else 1e-4)
    for a, b in zip(np.asarray(idn), np.asarray(idb)):
        assert set(a.tolist()) == set(b.tolist())


def test_budget_join_respects_target_mask(idx, dataset):
    T = 800
    tids = jnp.arange(T, dtype=jnp.int32)
    mask = np.ones(T, bool)
    mask[200:] = False
    q = jnp.asarray(dataset[:6])
    _, ids = idx.search_join(q, 5, tids, target_mask=jnp.asarray(mask),
                             impl="budget", budget_tiles=64, alpha=30)
    assert (np.asarray(ids) < 200).all()


def test_budget_join_double_codes(idx, dataset):
    """Fused-pair LUTs on the budget path must match normal LUTs."""
    T = 1000
    tids = jnp.arange(T, dtype=jnp.int32)
    q = jnp.asarray(dataset[:8])
    v1, i1 = idx.search_join(q, 5, tids, impl="budget", budget_tiles=64,
                             alpha=30, long_codes_threshold=1e9)
    v2, i2 = idx.search_join(q, 5, tids, impl="budget", budget_tiles=64,
                             alpha=30, long_codes_threshold=0)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), rtol=1e-4,
                               atol=1e-5)


def test_budget_scales_with_alpha(idx, dataset):
    """The whole point: rows scanned must grow with alpha (selectivity-
    proportional compute), unlike the dense path's constant full-T scan."""
    T = 2000
    tids = jnp.arange(T, dtype=jnp.int32)
    q = jnp.asarray(dataset[:8])
    _, _, lo = idx.search_join(q, 5, tids, impl="budget", alpha=3,
                               max_rounds=1, return_info=True)
    _, _, hi = idx.search_join(q, 5, tids, impl="budget", alpha=60,
                               max_rounds=1, return_info=True)
    assert (np.asarray(lo["retrieved"]).mean()
            < np.asarray(hi["retrieved"]).mean())
    # scanned rows stay far below T at small alpha
    assert np.asarray(lo["retrieved"]).mean() < 0.5 * T


def test_join_tiles_cache_reused(idx, dataset, monkeypatch):
    """Repeated joins against the same target set must reuse the cached
    tiling (VERDICT r2 item 6: no per-call sort + scatter)."""
    T = 1000
    tids = jnp.arange(T, dtype=jnp.int32)
    q = jnp.asarray(dataset[:8])
    idx._join_cache.clear()
    calls = {"n": 0}
    real = ivpq_mod.build_join_tiles

    def counting(*args, **kw):
        calls["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(ivpq_mod, "build_join_tiles", counting)
    v1, i1 = idx.search_join(q, 5, tids, impl="budget", alpha=10)
    assert calls["n"] == 1
    v2, i2 = idx.search_join(q, 5, tids, impl="budget", alpha=10)
    assert calls["n"] == 1          # cache hit — no rebuild
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i1))
    # a different target set misses and rebuilds
    idx.search_join(q, 5, tids[:512], impl="budget", alpha=10)
    assert calls["n"] == 2
    # a different mask over the same ids misses too
    mask = np.ones(T, bool); mask[7] = False
    idx.search_join(q, 5, tids, target_mask=jnp.asarray(mask),
                    impl="budget", alpha=10)
    assert calls["n"] == 3
    # cap bounds the memo
    assert len(idx._join_cache) <= idx._JOIN_CACHE_CAP


def test_search_join_query_chunking_parity(idx, dataset):
    """A multi-chunk call with a ragged (padded) final chunk must return
    exactly what one unchunked call returns — including the merged
    return_info arrays — after the host-side merge (no eager jnp concat)."""
    T = 1500
    tids = jnp.arange(T, dtype=jnp.int32)
    q = jnp.asarray(dataset[:20])
    kw = dict(impl="budget", alpha=20, max_rounds=1, return_info=True)
    v1, i1, info1 = idx.search_join(q, 5, tids, query_chunk=1024, **kw)
    v2, i2, info2 = idx.search_join(q, 5, tids, query_chunk=8, **kw)
    assert np.asarray(v2).shape == (20, 5)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i1))
    for key, val in info2.items():
        if hasattr(val, "shape") and getattr(val, "ndim", 0) > 0:
            assert val.shape[0] == 20, key
            np.testing.assert_allclose(
                np.asarray(val), np.asarray(info1[key]), rtol=1e-5)


def test_budget_join_matches_dense_bench_regime():
    """VERDICT r3 item 2: budget-path recall must equal dense-path recall at
    a bench-regime join shape — T >= 50k (the block_t=256 tiling tier),
    alpha=200, method=2 (ADC + post-verify), DEFAULT tile budget — so any
    silent truncation of probed tiles (ivpq_search_in.c:459-543 semantics:
    probed rows only, nothing dropped) shows up as an id mismatch here
    rather than as a 3M recall drop nobody can bisect."""
    rng = np.random.default_rng(11)
    n, d, t = 60_000, 32, 50_176
    v = rng.normal(size=(n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    vv = jnp.asarray(v)
    idx = IVPQIndex.build(jax.random.PRNGKey(4), vv, m=8, k=16,
                          k_coarse=256, coarse_positions=1,
                          train_size=20_000, iters=4)
    tids = jnp.arange(t, dtype=jnp.int32)
    q = vv[n - 64:]
    kw = dict(alpha=200, method=2, confidence=0.8, pvf=20, vectors=vv,
              query_chunk=64, max_rounds=1)
    vd, idn, info_d = idx.search_join(q, 5, tids, impl="dense",
                                      return_info=True, **kw)
    vb, idb, info_b = idx.search_join(q, 5, tids, impl="budget",
                                      return_info=True, **kw)
    # identical scan semantics: same scanned-row accounting per query ...
    np.testing.assert_array_equal(np.asarray(info_b["retrieved"]),
                                  np.asarray(info_d["retrieved"]))
    # ... and identical post-verified results (set-equal per query; exact
    # re-rank makes values comparable to 1e-4).
    np.testing.assert_allclose(np.asarray(vb), np.asarray(vd), rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(np.asarray(idn), np.asarray(idb)):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize("method", [PQ_CALC, EXACT_CALC, PQ_PV_CALC])
def test_prepared_join_matches_unprepared(idx, dataset, method):
    """search_join(prepared=handle) must reproduce the ad-hoc call bit for
    bit on both impls — the handle only hoists gathers/tiling, never
    changes the computation."""
    T = 1400
    tids = jnp.arange(T, dtype=jnp.int32)
    q = jnp.asarray(dataset[:10])
    v = jnp.asarray(dataset)
    ph = idx.prepare_join(tids, vectors=v)
    assert ph.size == T and ph.build_s >= 0.0
    for impl in ("budget", "dense"):
        kw = dict(alpha=20, method=method, confidence=0.8, impl=impl,
                  budget_tiles=64)
        vd, idn = idx.search_join(q, 5, tids, vectors=v, **kw)
        vp, idp = idx.search_join(q, 5, prepared=ph, **kw)
        np.testing.assert_allclose(np.asarray(vp), np.asarray(vd),
                                   rtol=1e-4, atol=1e-4)
        for a, b in zip(np.asarray(idn), np.asarray(idp)):
            assert set(a.tolist()) == set(b.tolist()), (impl, method)


def test_prepared_join_tile_layouts_cached(idx, dataset):
    """tiles() builds each layout once; method 1 without vectors raises."""
    tids = jnp.arange(900, dtype=jnp.int32)
    ph = idx.prepare_join(tids)   # no vectors
    jt1 = ph.tiles(with_vecs=False)
    assert ph.tiles(with_vecs=False) is jt1
    with pytest.raises(ValueError, match="vectors"):
        ph.tiles(with_vecs=True)
    with pytest.raises(ValueError, match="raw vectors"):
        idx.search_join(jnp.asarray(dataset[:2]), 3, prepared=ph,
                        method=PQ_PV_CALC)
    # with vectors: the method-1 layout builds lazily and is cached
    ph2 = idx.prepare_join(tids, vectors=jnp.asarray(dataset))
    jt2 = ph2.tiles(with_vecs=True)
    assert ph2.tiles(with_vecs=True) is jt2


def test_prepared_join_respects_mask_and_chunking(idx, dataset):
    T = 1100
    tids = jnp.arange(T, dtype=jnp.int32)
    mask = np.ones(T, bool)
    mask[300:] = False
    ph = idx.prepare_join(tids, target_mask=jnp.asarray(mask))
    q = jnp.asarray(dataset[:20])
    v1, i1 = idx.search_join(q, 5, prepared=ph, impl="budget",
                             budget_tiles=64, alpha=30)
    assert (np.asarray(i1) < 300).all()
    # multi-chunk prepared call merges exactly like the single chunk
    v2, i2 = idx.search_join(q, 5, prepared=ph, impl="budget",
                             budget_tiles=64, alpha=30, query_chunk=8)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i1))


def test_search_join_requires_targets_or_prepared(idx, dataset):
    with pytest.raises(ValueError, match="target_ids or prepared"):
        idx.search_join(jnp.asarray(dataset[:2]), 3)


def test_budget_round_device_scan_matches_direct(idx, dataset, monkeypatch):
    """Batches above _BUDGET_SCAN_BLOCK stream through a device-side
    lax.map inside ONE program (bounded score blocks). Shrink the
    block so a small batch exercises the mapped path — incl. a ragged
    final block — and require bit-parity with the direct path."""
    T = 1000
    tids = jnp.arange(T, dtype=jnp.int32)
    q = jnp.asarray(dataset[:22])
    v = jnp.asarray(dataset)
    kw = dict(impl="budget", budget_tiles=32, method=PQ_PV_CALC,
              vectors=v, confidence=0.8, pvf=10)
    # alpha values unseen by other tests: static args force fresh traces,
    # so the patched block size actually applies.
    vd, idn = idx.search_join(q, 5, tids, alpha=21, **kw)
    monkeypatch.setattr(ivpq_mod, "_BUDGET_SCAN_BLOCK", 4)
    vm, idm = idx.search_join(q, 5, tids, alpha=22, **kw)
    # alpha 21 vs 22 picks identical cell prefixes here (ample coverage at
    # T=1000, k=5), so results must agree exactly.
    np.testing.assert_allclose(np.asarray(vm), np.asarray(vd),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(idm), np.asarray(idn))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from postgres_word2vec.models.ivfadc import IVFADCIndex


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(3000, 24)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


@pytest.fixture(scope="module")
def ivf(dataset):
    return IVFADCIndex.build(jax.random.PRNGKey(1), jnp.asarray(dataset),
                             m=6, k=16, k_coarse=20, train_size=None,
                             iters=8)


def _exact_ids(q, v, k):
    d = ((q[:, None, :] - v[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, -1)[:, :k]


def test_csr_structure(ivf, dataset):
    off = np.asarray(ivf.cell_offsets)
    assert off[0] == 0 and off[-1] == 3000
    assert (np.diff(off) >= 0).all()
    # row_ids is a permutation
    assert sorted(np.asarray(ivf.row_ids).tolist()) == list(range(3000))
    # every sorted row's assignment matches its cell range
    assign = np.asarray(ivf.assignments)
    rid = np.asarray(ivf.row_ids)
    for c in range(ivf.num_cells):
        assert (assign[rid[off[c]:off[c + 1]]] == c).all()
    assert ivf.list_cap == np.diff(off).max()


def test_full_probe_equals_exhaustive_adc(ivf, dataset):
    """probing every cell must equal an exhaustive residual-ADC scan."""
    q = jnp.asarray(dataset[:4])
    d_all, i_all = ivf.search(q, 10, w=ivf.num_cells)
    # brute force: decode residual distances per row via LUTs
    from postgres_word2vec.ops import lut
    coarse = np.asarray(ivf.coarse.centroids)
    assign = np.asarray(ivf.assignments)
    got_ids = np.asarray(i_all)
    # compute reference distances for the returned ids and verify they are
    # the global minimum of the per-row ADC distance.
    ref_d = np.zeros((4, 3000), np.float32)
    for b in range(4):
        resid = dataset[b][None, :] - coarse  # (C, d)
        luts = np.asarray(lut.build_luts(jnp.asarray(resid),
                                         ivf.codebook.centroids))  # (C,m,k)
        codes_unsorted = np.asarray(ivf.codes_sorted)[
            np.argsort(np.asarray(ivf.row_ids))]
        for i in range(3000):
            c = assign[i]
            ref_d[b, i] = sum(luts[c, j, codes_unsorted[i, j]]
                              for j in range(6))
    want = np.argsort(ref_d, -1)[:, :10]
    np.testing.assert_allclose(np.sort(np.asarray(d_all), -1),
                               np.sort(np.take_along_axis(ref_d, want, -1)),
                               rtol=1e-4, atol=1e-5)


def test_recall_improves_with_w(ivf, dataset):
    q = dataset[:30]
    exact = _exact_ids(q, dataset, 5)

    def recall(w):
        _, ids = ivf.search(jnp.asarray(q), 5, w=w)
        return sum(len(set(a) & set(e))
                   for a, e in zip(np.asarray(ids), exact)) / exact.size

    r1, r5, rall = recall(1), recall(5), recall(ivf.num_cells)
    assert r1 <= r5 + 0.05
    assert r5 > 0.3
    assert rall >= r5


def test_search_adaptive_fills_k(ivf, dataset):
    q = jnp.asarray(dataset[:8])
    d, i = ivf.search_adaptive(q, 5, w=1)
    assert (np.asarray(i) >= 0).all()
    assert np.isfinite(np.asarray(d)).all()


def test_search_pv(ivf, dataset):
    q = dataset[:16]
    exact = _exact_ids(q, dataset, 5)
    _, ids = ivf.search_pv(jnp.asarray(q), 5, pvf=10,
                           vectors=jnp.asarray(dataset), w=8)
    r = sum(len(set(a) & set(e))
            for a, e in zip(np.asarray(ids), exact)) / exact.size
    assert r > 0.6


def test_add_and_roundtrip(ivf, dataset, tmp_path):
    rng = np.random.default_rng(9)
    new = rng.normal(size=(7, 24)).astype(np.float32)
    new /= np.linalg.norm(new, axis=-1, keepdims=True)
    ivf2 = ivf.add(jnp.asarray(new))
    assert ivf2.size == ivf.size + 7
    assert np.asarray(ivf2.coarse.counts).sum() == 3007
    # new rows are findable
    d, i = ivf2.search_adaptive(jnp.asarray(new), 1, w=4)
    assert (np.asarray(i)[:, 0] >= 3000).mean() > 0.5

    p = tmp_path / "ivf.npz"
    ivf2.save(p)
    ivf3 = IVFADCIndex.load(p)
    # save() flushes the insert tail, so the loaded list_cap reflects the
    # merged CSR.
    assert ivf3.list_cap == ivf2.flush().list_cap
    assert ivf3.size == ivf2.size
    np.testing.assert_array_equal(np.asarray(ivf3.codes_sorted),
                                  np.asarray(ivf2.flush().codes_sorted))


def test_budget_probe_matches_padded_probe(ivf, dataset):
    """The tiled budget probe (full coverage) must reproduce the round-1
    padded probe bit-for-bit in distances and id sets."""
    from postgres_word2vec.models.ivfadc import _ivfadc_probe

    q = jnp.asarray(dataset[:8])
    for w in (1, 3):
        d_old, i_old, _ = _ivfadc_probe(
            q, ivf.coarse.centroids, ivf.codebook.centroids,
            ivf.cell_offsets, ivf.codes_sorted, ivf.row_ids,
            w=w, k=5, list_cap=ivf.list_cap)
        d_new, i_new = ivf.search(q, 5, w=w)
        np.testing.assert_allclose(np.asarray(d_new), np.asarray(d_old),
                                   rtol=1e-4, atol=1e-5)
        for a, b in zip(np.asarray(i_old), np.asarray(i_new)):
            assert set(a.tolist()) == set(b.tolist())


def test_budget_probe_found_needed_accounting(ivf, dataset):
    q = jnp.asarray(dataset[:6])
    _, _, info = ivf.search(q, 5, w=3, return_info=True)
    found = np.asarray(info["found"])
    needed = np.asarray(info["needed"])
    # full default budget: every selected cell fully scanned
    np.testing.assert_array_equal(found, needed)
    # a tight budget scans fewer rows and reports it
    _, _, info2 = ivf.search(q, 5, w=3, budget_tiles=1, return_info=True)
    assert (np.asarray(info2["found"]) <= found).all()
    assert info2["budget_tiles"] == 1


def test_budget_probe_truncation_keeps_probe_order(ivf, dataset):
    """With budget 1 tile, only the nearest cell's first tile is scanned —
    results must come from that cell."""
    q = jnp.asarray(dataset[:4])
    d, i = ivf.search(q, 3, w=3, budget_tiles=1)
    assign = np.asarray(ivf.assignments)
    cd = ((np.asarray(q)[:, None, :]
           - np.asarray(ivf.coarse.centroids)[None]) ** 2).sum(-1)
    best_cell = cd.argmin(-1)
    for b in range(4):
        for rid in np.asarray(i)[b]:
            if rid >= 0:
                assert assign[rid] == best_cell[b]


def test_search_adaptive_blacklist_matches_wide_probe(dataset):
    """When escalation IS triggered (some query found < k rows), the
    rank-window rounds merged together must equal one wide probe over the
    same total rank range — proving the blacklist windows are disjoint,
    exhaustive, and merged correctly."""
    # tiny cells: ~5 rows each, so k=20 forces a second round.
    small = IVFADCIndex.build(jax.random.PRNGKey(5),
                              jnp.asarray(dataset[:400]), m=6, k=8,
                              k_coarse=80, train_size=None, iters=6)
    q = jnp.asarray(dataset[:6])
    d1, _, f1, _ = __import__(
        "postgres_word2vec.models.ivfadc", fromlist=["x"]
    )._ivfadc_probe_budget(
        q, small.coarse.centroids, small.codebook.centroids, small.tiled(),
        w_lo=0, w_hi=2, k=20, p_budget=small._auto_budget(2, None, True),
        block_t=small.tiled().block_t, use_kernel=False)
    assert bool((np.asarray(f1) < 20).any()), "fixture must force escalation"
    d_esc, i_esc = small.search_adaptive(q, 20, w=2, max_rounds=2)
    d_wide, i_wide = small.search(q, 20, w=4)
    np.testing.assert_allclose(np.asarray(d_esc), np.asarray(d_wide),
                               rtol=1e-4, atol=1e-5)


def test_rowterm_decomposition_exact(ivf, dataset):
    """dist = LUT(q,code) + rowterm + (cd − ‖q‖²) must equal the direct
    residual ADC distance."""
    from postgres_word2vec.models.ivfadc import _compute_rowterm
    from postgres_word2vec.ops import lut as lut_mod

    q = np.asarray(dataset[:3])
    cb = np.asarray(ivf.codebook.centroids)        # (m, k, dsub)
    coarse = np.asarray(ivf.coarse.centroids)
    codes = np.asarray(ivf.codes_sorted[:50])
    rid = np.asarray(ivf.row_ids[:50])
    cells = np.asarray(ivf.assignments)[rid]
    m, kk, dsub = cb.shape

    rt = np.asarray(_compute_rowterm(
        ivf.coarse.centroids, ivf.codebook.centroids,
        jnp.asarray(cells.astype(np.int32)), jnp.asarray(codes)))
    luts = np.asarray(lut_mod.build_luts(jnp.asarray(q),
                                         ivf.codebook.centroids))
    for b in range(3):
        for r in range(50):
            recon = coarse[cells[r]] + np.concatenate(
                [cb[j, codes[r, j]] for j in range(m)])
            want = ((q[b] - recon) ** 2).sum()
            cd = ((q[b] - coarse[cells[r]]) ** 2).sum()
            lut_sum = sum(luts[b, j, codes[r, j]] for j in range(m))
            got = lut_sum + rt[r] + cd - (q[b] ** 2).sum()
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_tail_insert_searchable_and_flush_equivalent(ivf, dataset):
    """Inserted rows must be findable immediately (tail scan) and results
    must match the flushed (CSR-merged) index."""
    rng = np.random.default_rng(11)
    new = rng.normal(size=(9, 24)).astype(np.float32)
    new /= np.linalg.norm(new, axis=-1, keepdims=True)
    ivf2 = ivf.add(jnp.asarray(new))
    assert ivf2.tail_count == 9
    assert ivf2.size == ivf.size + 9
    # tail rows findable through search (their own nearest neighbor)
    d, i = ivf2.search_adaptive(jnp.asarray(new), 1, w=4)
    assert (np.asarray(i)[:, 0] >= 3000).mean() > 0.5
    # flush merges and preserves results
    ivf3 = ivf2.flush()
    assert ivf3.tail_count == 0 and ivf3.size == ivf2.size
    q = jnp.asarray(dataset[:8])
    d2, i2 = ivf2.search(q, 5, w=3)
    d3, i3 = ivf3.search(q, 5, w=3)
    # the online codebook update drifts centroids; the tail-holding index
    # keeps its cached pre-update rowterm until flush (documented in add()),
    # so distances agree only to O(centroid drift) ≈ 1e-3 here.
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d3), rtol=1e-2,
                               atol=1e-3)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 5
                       for a, b in zip(np.asarray(i2), np.asarray(i3))])
    assert overlap >= 0.8
    # CSR invariants after splice
    off = np.asarray(ivf3.cell_offsets)
    assert off[-1] == ivf3.size
    assert sorted(np.asarray(ivf3.row_ids).tolist()) == list(range(
        ivf3.size))
    assign = np.asarray(ivf3.assignments)
    rid = np.asarray(ivf3.row_ids)
    for c in range(ivf3.num_cells):
        assert (assign[rid[off[c]:off[c + 1]]] == c).all()


def test_tail_overflow_triggers_splice(dataset):
    small = IVFADCIndex.build(jax.random.PRNGKey(7),
                              jnp.asarray(dataset[:500]), m=6, k=8,
                              k_coarse=10, train_size=None, iters=4)
    try:
        IVFADCIndex.TAIL_CAP = 16
        rng = np.random.default_rng(3)
        idx = small
        for _ in range(5):
            new = rng.normal(size=(7, 24)).astype(np.float32)
            new /= np.linalg.norm(new, axis=-1, keepdims=True)
            idx = idx.add(jnp.asarray(new))
        assert idx.size == 500 + 35
        assert idx.tail_count < 16
        # every row findable with a full-width probe
        off = np.asarray(idx.cell_offsets)
        assert off[-1] + idx.tail_count == idx.size
        d, i = idx.search(jnp.asarray(dataset[:4]), 5, w=idx.num_cells)
        assert (np.asarray(i) >= 0).all()
    finally:
        IVFADCIndex.TAIL_CAP = 8192


@pytest.mark.parametrize("impl,kernels", [(None, False), (None, True),
                                          ("xla", True)])
def test_probe_impl_selects_path(ivf, dataset, monkeypatch, impl, kernels):
    """``impl="xla"`` sends every IVFADC search to the XLA probe even
    where the backend takes the kernel; both answer alike."""
    from postgres_word2vec.models import ivfadc as ivf_mod
    from postgres_word2vec.ops import backend

    monkeypatch.setattr(backend, "use_kernels", lambda: kernels)
    seen = []
    orig = ivf_mod._ivfadc_probe_budget

    def spy(*a, **kw):
        seen.append(kw["use_kernel"])
        return orig(*a, **kw)

    monkeypatch.setattr(ivf_mod, "_ivfadc_probe_budget", spy)
    q = jnp.asarray(dataset[:4])
    d1, i1 = ivf.search(q, 5, impl=impl)
    d2, i2 = ivf.search_adaptive(q, 5, impl=impl)
    d3, i3 = ivf.search_pv(q, 5, 4, jnp.asarray(dataset), impl=impl)
    assert seen and set(seen) == {kernels and impl is None}
    monkeypatch.setattr(ivf_mod, "_ivfadc_probe_budget", orig)
    monkeypatch.setattr(backend, "use_kernels", lambda: False)
    for (d, i), (wd, wi) in zip(
            ((d1, i1), (d2, i2), (d3, i3)),
            (ivf.search(q, 5), ivf.search_adaptive(q, 5),
             ivf.search_pv(q, 5, 4, jnp.asarray(dataset)))):
        np.testing.assert_array_equal(np.asarray(i), np.asarray(wi))
        np.testing.assert_allclose(np.asarray(d), np.asarray(wd),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch,kernel", [(3, True), (512, False)])
def test_probe_kernel_only_below_batch_bound(ivf, dataset, monkeypatch,
                                             batch, kernel):
    """Where the kernel runs, batches from ``_PROBE_KERNEL_MAX_B`` queries
    up still probe through the XLA twin, with the same answer."""
    from postgres_word2vec.models import ivfadc as ivf_mod
    from postgres_word2vec.ops import backend
    from postgres_word2vec.ops import pallas_kernels as pk

    assert (batch < ivf_mod._PROBE_KERNEL_MAX_B) is kernel
    # a batch no other test compiles, so the probe program is traced here
    q = jnp.asarray(dataset[:batch])
    want_d, want_i = ivf.search(q, 5)
    calls = []
    orig = pk.budget_adc
    monkeypatch.setattr(pk, "budget_adc",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    monkeypatch.setattr(backend, "use_kernels", lambda: True)
    d, i = ivf.search(q, 5)
    assert bool(calls) is kernel
    np.testing.assert_array_equal(np.asarray(i), np.asarray(want_i))
    np.testing.assert_allclose(np.asarray(d), np.asarray(want_d), rtol=1e-5,
                               atol=1e-5)

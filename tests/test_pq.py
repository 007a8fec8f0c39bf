import jax
import jax.numpy as jnp
import numpy as np
import pytest

from postgres_word2vec.models.pq import PQIndex, online_codebook_update


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(42)
    v = rng.normal(size=(2000, 24)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


@pytest.fixture(scope="module")
def pq(dataset):
    return PQIndex.build(jax.random.PRNGKey(0), jnp.asarray(dataset), m=6,
                         k=16, train_size=None, iters=10)


def _recall(approx_ids, exact_ids):
    hits = sum(len(set(a) & set(e)) for a, e in zip(approx_ids, exact_ids))
    return hits / exact_ids.size


def _exact_ids(q, v, k):
    d = ((q[:, None, :] - v[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, -1)[:, :k]


def test_pq_shapes(pq, dataset):
    assert pq.codes.shape == (2000, 6)
    assert pq.codes.dtype == jnp.uint8
    assert pq.codebook.centroids.shape == (6, 16, 4)
    # counts sum to n per subspace
    np.testing.assert_array_equal(np.asarray(pq.codebook.counts).sum(-1),
                                  [2000] * 6)


def test_pq_recall_reasonable(pq, dataset):
    q = dataset[:20]
    _, ids = pq.search(jnp.asarray(q), 10)
    exact = _exact_ids(q, dataset, 10)
    r = _recall(np.asarray(ids), exact)
    assert r > 0.25, f"PQ recall@10 too low: {r}"
    # self-match: query is in the DB; its code distance should rank it high
    assert np.asarray(ids)[0, :10].tolist().count(0) <= 1


def test_pq_pv_improves_recall(pq, dataset):
    q = dataset[:20]
    _, ids_plain = pq.search(jnp.asarray(q), 10)
    _, ids_pv = pq.search_pv(jnp.asarray(q), 10, pvf=10,
                             vectors=jnp.asarray(dataset))
    exact = _exact_ids(q, dataset, 10)
    r_plain = _recall(np.asarray(ids_plain), exact)
    r_pv = _recall(np.asarray(ids_pv), exact)
    assert r_pv >= r_plain
    assert r_pv > 0.8, f"PQ+PV recall@10 too low: {r_pv}"


def test_pq_pv_approx_shortlist_matches_exact_on_cpu(pq, dataset):
    # The CPU reference answers approximate top-k requests exactly, so the
    # approx-shortlist plumbing must reproduce the exact-shortlist results.
    q = jnp.asarray(dataset[:16])
    v = jnp.asarray(dataset)
    d_e, i_e = pq.search_pv(q, 10, pvf=10, vectors=v, shortlist="exact")
    d_a, i_a = pq.search_pv(q, 10, pvf=10, vectors=v, shortlist="approx")
    np.testing.assert_array_equal(np.asarray(i_e), np.asarray(i_a))
    np.testing.assert_allclose(np.asarray(d_e), np.asarray(d_a), rtol=1e-6)


def test_pv_shortlist_auto_resolution(monkeypatch):
    from postgres_word2vec.models import pq as pq_mod
    from postgres_word2vec.ops import backend
    # reference backend: auto is always exact
    monkeypatch.setattr(backend, "use_kernels", lambda: False)
    assert pq_mod._resolve_shortlist("auto", 10, 20) == "exact"
    # kernel backend: approx only for wide shortlists (k*pvf >= 100)
    monkeypatch.setattr(backend, "use_kernels", lambda: True)
    assert pq_mod._resolve_shortlist("auto", 10, 20) == "approx"
    assert pq_mod._resolve_shortlist("auto", 23, 1) == "exact"
    # the explicit reference impl keeps the exact shortlist
    assert pq_mod._resolve_shortlist("auto", 10, 20, impl="xla") == "exact"
    with pytest.raises(ValueError):
        pq_mod._resolve_shortlist("auto", 10, 20, impl="pallas")
    # explicit values pass through; junk raises
    assert pq_mod._resolve_shortlist("exact", 10, 20) == "exact"
    assert pq_mod._resolve_shortlist("approx", 2, 2) == "approx"
    with pytest.raises(ValueError):
        pq_mod._resolve_shortlist("fast", 10, 20)


def test_pq_search_in_matches_exhaustive_on_subset(pq, dataset):
    q = dataset[:3]
    targets = np.arange(0, 2000, 7, dtype=np.int32)
    d_in, i_in = pq.search_in(jnp.asarray(q), 5, jnp.asarray(targets))
    # exhaustive ADC distances restricted by hand
    from postgres_word2vec.ops import adc, lut
    luts = lut.build_luts(jnp.asarray(q), pq.codebook.centroids)
    full = np.asarray(adc.adc_distances(luts, pq.codes))
    sub = full[:, targets]
    order = np.argsort(sub, -1)[:, :5]
    np.testing.assert_allclose(np.asarray(d_in),
                               np.take_along_axis(sub, order, -1), rtol=1e-5)


def test_online_add_updates_codebook_and_codes(pq, dataset):
    rng = np.random.default_rng(7)
    new = rng.normal(size=(5, 24)).astype(np.float32)
    new /= np.linalg.norm(new, axis=-1, keepdims=True)
    pq2 = pq.add(jnp.asarray(new))
    assert pq2.size == pq.size + 5
    # counts grew by exactly 5 per subspace
    np.testing.assert_array_equal(np.asarray(pq2.codebook.counts).sum(-1),
                                  [2005] * 6)
    # centroids moved (running mean) but only slightly
    delta = np.abs(np.asarray(pq2.codebook.centroids)
                   - np.asarray(pq.codebook.centroids)).max()
    assert 0 < delta < 0.5


def test_online_update_running_mean_math():
    # one centroid per subspace → closed-form running mean
    from postgres_word2vec.models.pq import PQCodebook
    cb = PQCodebook(jnp.zeros((1, 1, 2)), jnp.asarray([[2]], jnp.int32))
    x = jnp.asarray([[3.0, 6.0]])
    cb2, codes = online_codebook_update(cb, x)
    # count 2 → 3, c = 0 + (x-0)/3
    np.testing.assert_allclose(np.asarray(cb2.centroids)[0, 0], [1.0, 2.0],
                               rtol=1e-6)
    assert int(cb2.counts[0, 0]) == 3
    assert codes.shape == (1, 1)


def test_save_load_roundtrip(pq, tmp_path):
    p = tmp_path / "pq.npz"
    pq.save(p)
    pq2 = PQIndex.load(p)
    np.testing.assert_array_equal(np.asarray(pq2.codes), np.asarray(pq.codes))
    np.testing.assert_allclose(np.asarray(pq2.codebook.centroids),
                               np.asarray(pq.codebook.centroids))


def test_opq_rotation_orthogonal_and_recall(rng):
    import jax
    from postgres_word2vec.models.pq import PQIndex

    # anisotropic data where OPQ has something to learn
    n, d = 3000, 24
    scales = np.linspace(2.0, 0.1, d).astype(np.float32)
    v = (rng.normal(size=(n, d)).astype(np.float32) * scales)
    q_rot, _ = np.linalg.qr(rng.normal(size=(d, d)))
    v = (v @ q_rot.astype(np.float32))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    vj = jnp.asarray(v)

    plain = PQIndex.build(jax.random.PRNGKey(0), vj, m=6, k=16,
                          train_size=None, iters=12, init="kmeans++")
    opq = PQIndex.build(jax.random.PRNGKey(0), vj, m=6, k=16,
                        train_size=None, iters=12, opq_iters=6)
    r = np.asarray(opq.rotation)
    np.testing.assert_allclose(r @ r.T, np.eye(d), atol=1e-4)

    q = v[:40]
    exact = np.argsort(((q[:, None] - v[None]) ** 2).sum(-1), -1)[:, :5]

    def rec(idx):
        _, ids = idx.search(jnp.asarray(q), 5)
        return sum(len(set(a.tolist()) & set(e.tolist()))
                   for a, e in zip(np.asarray(ids), exact)) / exact.size

    assert rec(opq) >= rec(plain) - 0.02  # ≥ plain up to noise

    # quantization error strictly improves on anisotropic data
    from postgres_word2vec.models.pq import reconstruct
    def mse(idx):
        y = v @ np.asarray(idx.rotation) if idx.rotation is not None else v
        rc = np.asarray(reconstruct(idx.codes, idx.codebook.centroids))
        return float(((y - rc) ** 2).sum(-1).mean())
    assert mse(opq) < mse(plain)


def test_opq_save_load_roundtrip(rng, tmp_path):
    import jax
    from postgres_word2vec.models.pq import PQIndex

    v = rng.normal(size=(500, 12)).astype(np.float32)
    idx = PQIndex.build(jax.random.PRNGKey(1), jnp.asarray(v), m=3, k=8,
                        train_size=None, iters=6, opq_iters=3)
    p = tmp_path / "opq.npz"
    idx.save(p)
    idx2 = PQIndex.load(p)
    np.testing.assert_array_equal(np.asarray(idx2.codes),
                                  np.asarray(idx.codes))
    np.testing.assert_allclose(np.asarray(idx2.rotation),
                               np.asarray(idx.rotation), rtol=1e-6)
    q = jnp.asarray(v[:4])
    d1, i1 = idx.search(q, 3)
    d2, i2 = idx2.search(q, 3)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_opq_encode_rotation_fused_matches_explicit(rng):
    import jax
    from postgres_word2vec.ops import kmeans as km

    v = rng.normal(size=(700, 12)).astype(np.float32)
    cb = jnp.asarray(rng.normal(size=(3, 8, 4)).astype(np.float32))
    q_rot, _ = np.linalg.qr(rng.normal(size=(12, 12)))
    rot = jnp.asarray(q_rot.astype(np.float32))
    fused = km.encode_subspaces(jnp.asarray(v), cb, rotation=rot,
                                chunk_size=128)
    explicit = km.encode_subspaces(jnp.asarray(v @ q_rot.astype(np.float32)),
                                   cb, chunk_size=4096)
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(explicit))


@pytest.mark.parametrize("kernels,approx,impl,mode", [
    (False, False, None, "xla"), (False, True, None, "xla"),
    (True, False, None, "dense"), (True, True, None, "binned"),
    (True, True, "xla", "xla")])
def test_search_plan_modes(pq, monkeypatch, kernels, approx, impl, mode):
    from postgres_word2vec.ops import backend
    monkeypatch.setattr(backend, "use_kernels", lambda: kernels)
    assert pq._search_plan(approx, impl) == mode


def test_search_plan_rejects_unknown_impl(pq):
    with pytest.raises(ValueError, match="impl"):
        pq._search_plan(False, "pallas_int8")


@pytest.mark.parametrize("approx", [False, True])
def test_pq_kernel_modes_match_reference(pq, dataset, monkeypatch, approx):
    """The GPU plan ("dense" / "binned" through the Triton kernels, run
    interpreted here) against the XLA plan on the same index. The kernel
    sums the same f32 LUT entries in another order, so near-tied
    neighbours may swap: the exact mode keeps ≥ 0.95 of them with
    distances within 1e-4, the binned mode (one survivor per strided bin
    of 16 rows) keeps ≥ 0.9."""
    from postgres_word2vec.ops import backend
    q = jnp.asarray(dataset[:8])
    want_d, want_i = pq.search(q, 10)
    monkeypatch.setattr(backend, "use_kernels", lambda: True)
    got_d, got_i = pq.search(q, 10, approx=approx)
    recall = _recall(np.asarray(got_i), np.asarray(want_i))
    assert recall >= (0.9 if approx else 0.95)
    if not approx:
        np.testing.assert_allclose(np.asarray(got_d), np.asarray(want_d),
                                   atol=1e-4)

import jax
import jax.numpy as jnp
import numpy as np

from postgres_word2vec.ops import kmeans


def test_pairwise_sqdist_matches_numpy(rng):
    x = rng.normal(size=(20, 8)).astype(np.float32)
    c = rng.normal(size=(5, 8)).astype(np.float32)
    got = np.asarray(kmeans.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c)))
    want = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_assign_matches_argmin_and_chunks(rng):
    x = rng.normal(size=(1000, 8)).astype(np.float32)
    c = rng.normal(size=(13, 8)).astype(np.float32)
    want = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1).argmin(-1)
    got = np.asarray(kmeans.assign(jnp.asarray(x), jnp.asarray(c)))
    got_chunked = np.asarray(kmeans.assign(jnp.asarray(x), jnp.asarray(c),
                                           chunk_size=96))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_chunked, want)


def test_kmeans_reduces_inertia_and_recovers_clusters(rng):
    # 4 well-separated blobs.
    centers = np.array([[10, 0], [-10, 0], [0, 10], [0, -10]], np.float32)
    x = np.concatenate([c + rng.normal(scale=0.3, size=(100, 2))
                        for c in centers]).astype(np.float32)
    res = kmeans.kmeans(jax.random.PRNGKey(0), jnp.asarray(x), k=4, iters=10)
    cents = np.asarray(res.centroids)
    # every true center has a learned centroid within 0.5
    d = np.linalg.norm(centers[:, None, :] - cents[None, :, :], axis=-1)
    assert d.min(axis=1).max() < 0.5
    assert np.asarray(res.counts).sum() == 400


def test_kmeans_subspaces_and_encode(rng):
    x = rng.normal(size=(300, 12)).astype(np.float32)
    sub = kmeans.split_subspaces(jnp.asarray(x), 3)
    assert sub.shape == (3, 300, 4)
    np.testing.assert_allclose(np.asarray(sub[1]), x[:, 4:8])
    res = kmeans.kmeans_subspaces(jax.random.PRNGKey(1), sub, k=8, iters=5)
    assert res.centroids.shape == (3, 8, 4)
    codes = kmeans.encode_subspaces(jnp.asarray(x), res.centroids)
    assert codes.shape == (300, 3)
    assert codes.dtype == jnp.uint8
    # codes must be the per-subspace argmin
    for j in range(3):
        want = ((x[:, None, 4 * j:4 * j + 4]
                 - np.asarray(res.centroids)[j][None, :, :]) ** 2
                ).sum(-1).argmin(-1)
        np.testing.assert_array_equal(np.asarray(codes[:, j]), want)


def test_encode_int16_for_large_k(rng):
    x = rng.normal(size=(40, 4)).astype(np.float32)
    cb = jnp.asarray(rng.normal(size=(2, 300, 2)).astype(np.float32))
    codes = kmeans.encode_subspaces(jnp.asarray(x), cb)
    assert codes.dtype == jnp.int16


def test_encode_subspaces_chunked_matches_single(rng):
    """Exercises the multi-chunk path of the per-subspace encoder — this
    guards the chunk-boundary behavior."""
    x = rng.normal(size=(1000, 12)).astype(np.float32)
    cb = jnp.asarray(rng.normal(size=(3, 8, 4)).astype(np.float32))
    one = kmeans.encode_subspaces(jnp.asarray(x), cb, chunk_size=2048)
    many = kmeans.encode_subspaces(jnp.asarray(x), cb, chunk_size=128)
    np.testing.assert_array_equal(np.asarray(one), np.asarray(many))


def test_encode_residual_subspaces_matches_manual(rng):
    x = rng.normal(size=(500, 12)).astype(np.float32)
    coarse = jnp.asarray(rng.normal(size=(7, 12)).astype(np.float32))
    assign = jnp.asarray(rng.integers(0, 7, size=(500,)).astype(np.int32))
    cb = jnp.asarray(rng.normal(size=(3, 8, 4)).astype(np.float32))
    got = kmeans.encode_residual_subspaces(jnp.asarray(x), coarse, assign,
                                           cb, chunk_size=128)
    resid = jnp.asarray(x) - jnp.take(coarse, assign, axis=0)
    want = kmeans.encode_subspaces(resid, cb, chunk_size=4096)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_assign_cells_chunked(rng):
    from postgres_word2vec.models.ivpq import assign_cells
    x = jnp.asarray(rng.normal(size=(700, 8)).astype(np.float32))
    cc = jnp.asarray(rng.normal(size=(2, 4, 4)).astype(np.float32))
    one = assign_cells(x, cc, chunk_size=4096)
    many = assign_cells(x, cc, chunk_size=128)
    np.testing.assert_array_equal(np.asarray(one), np.asarray(many))


def test_kmeans_plus_plus_spreads_inits(rng):
    """k-means++ on well-separated clusters should pick one init per
    cluster (D² sampling makes same-cluster double-picks vanishingly
    unlikely at this separation)."""
    import jax

    centers = np.eye(4, dtype=np.float32) * 50.0
    x = np.concatenate([c + rng.normal(scale=0.1, size=(50, 4))
                        for c in centers]).astype(np.float32)
    init = kmeans.kmeans_plus_plus_init(jax.random.PRNGKey(0),
                                        jnp.asarray(x), 4)
    owners = np.asarray(jnp.argmax(jnp.abs(init), axis=-1))
    assert sorted(owners.tolist()) == [0, 1, 2, 3]


def test_kmeans_restarts_picks_best_distortion(rng):
    """Best-of-R must return exactly the restart run with the lowest
    distortion (scipy kmeans(iter=R) semantics)."""
    import jax

    x = jnp.asarray(rng.normal(size=(600, 8)).astype(np.float32))
    key = jax.random.PRNGKey(1)
    runs = [kmeans._kmeans_single(kk, x, 16, 8, "sample")
            for kk in jax.random.split(key, 5)]
    best = min(runs, key=lambda r: float(r.distortion))
    multi = kmeans.kmeans(key, x, 16, iters=8, restarts=5)
    assert float(multi.distortion) == float(best.distortion)
    np.testing.assert_array_equal(np.asarray(multi.centroids),
                                  np.asarray(best.centroids))


def test_kmeans_empty_cluster_repair(rng):
    """With k close to n and duplicate-heavy data, naive Lloyd leaves dead
    centroids; the repair reseeds them onto worst-fit points so (almost)
    every cluster ends up used."""
    import jax

    base = rng.normal(size=(12, 4)).astype(np.float32)
    x = np.repeat(base, 25, axis=0)  # 300 points, only 12 distinct
    x += rng.normal(scale=1e-3, size=x.shape).astype(np.float32)
    res = kmeans.kmeans(jax.random.PRNGKey(2), jnp.asarray(x), 12, iters=12)
    assert int((np.asarray(res.counts) > 0).sum()) >= 11


def test_kmeans_subspaces_restarts_per_subspace(rng):
    """Each subspace independently keeps its own best restart."""
    import jax

    x = rng.normal(size=(400, 12)).astype(np.float32)
    sub = kmeans.split_subspaces(jnp.asarray(x), 3)
    key = jax.random.PRNGKey(0)
    per_run = []
    for kk in jax.random.split(key, 4):
        keys = jax.random.split(kk, 3)
        res = jax.vmap(lambda kk_, xs: kmeans._kmeans_single(
            kk_, xs, 8, 6, "sample"))(keys, sub)
        per_run.append(np.asarray(res.distortion))
    want = np.stack(per_run).min(axis=0)
    multi = kmeans.kmeans_subspaces(key, sub, 8, iters=6, restarts=4)
    np.testing.assert_allclose(np.asarray(multi.distortion), want, rtol=1e-6)


def test_assign_with_dist_matches_assign(rng):
    x = rng.normal(size=(1000, 6)).astype(np.float32)
    c = rng.normal(size=(9, 6)).astype(np.float32)
    a1 = np.asarray(kmeans.assign(jnp.asarray(x), jnp.asarray(c)))
    a2, d2 = kmeans.assign_with_dist(jnp.asarray(x), jnp.asarray(c),
                                     chunk_size=256)
    np.testing.assert_array_equal(a1, np.asarray(a2))
    full = ((x[:, None, :] - c[None]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(d2), full.min(-1), rtol=1e-4,
                               atol=1e-5)


def test_aniso_refine_eta1_is_plain_lloyd(rng):
    """η=1 anisotropic refinement == plain Lloyd continuation (weighted
    term vanishes; update reduces to the cluster mean)."""
    from postgres_word2vec.ops import kmeans as km

    x = rng.normal(size=(500, 8)).astype(np.float32)
    res = km.kmeans(jax.random.PRNGKey(0), jnp.asarray(x), 8, iters=5)
    got = np.asarray(km._aniso_refine_single(jnp.asarray(x), res.centroids,
                                             1.0, 1))
    # manual plain Lloyd step (no repair) from the same centroids
    c = np.asarray(res.centroids)
    a = (((x[:, None, :] - c[None]) ** 2).sum(-1)).argmin(-1)
    want = c.copy()
    for j in range(8):
        if (a == j).any():
            want[j] = x[a == j].mean(0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_aniso_refine_reduces_objective(rng):
    from postgres_word2vec.ops import kmeans as km

    x = rng.normal(size=(2000, 10)).astype(np.float32)
    eta = 4.0
    res = km.kmeans(jax.random.PRNGKey(1), jnp.asarray(x), 16, iters=8)

    def obj(c):
        cn = np.asarray(c)
        r = x[:, None, :] - cn[None]
        u = x / np.linalg.norm(x, axis=-1, keepdims=True)
        par = (r * u[:, None, :]).sum(-1) ** 2
        return ((r ** 2).sum(-1) + (eta - 1) * par).min(-1).mean()

    refined = km._aniso_refine_single(jnp.asarray(x), res.centroids, eta, 5)
    assert obj(refined) < obj(res.centroids) * 0.95


def test_encode_subspaces_aniso_eta1_matches_plain(rng):
    from postgres_word2vec.ops import kmeans as km

    x = rng.normal(size=(300, 24)).astype(np.float32)
    cb = rng.normal(size=(4, 8, 6)).astype(np.float32)
    a = np.asarray(km.encode_subspaces(jnp.asarray(x), jnp.asarray(cb)))
    b = np.asarray(km.encode_subspaces(jnp.asarray(x), jnp.asarray(cb),
                                       aniso_eta=1.0))
    np.testing.assert_array_equal(a, b)


def test_pqindex_build_aniso(rng):
    """PQIndex.build(aniso_eta=…) end-to-end: valid codes, sane recall,
    OPQ + aniso stack without error."""
    from postgres_word2vec.models.pq import PQIndex

    v = rng.normal(size=(2000, 24)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    idx = PQIndex.build(jax.random.PRNGKey(0), jnp.asarray(v), m=4, k=16,
                        train_size=None, iters=8, aniso_eta=2.0)
    assert idx.codes.shape == (2000, 4)
    _, ids = idx.search(jnp.asarray(v[:8]), 5, impl="xla")
    assert (np.asarray(ids)[:, 0] == np.arange(8)).sum() >= 6
    idx2 = PQIndex.build(jax.random.PRNGKey(0), jnp.asarray(v), m=4, k=16,
                         train_size=None, iters=8, opq_iters=3,
                         aniso_eta=2.0)
    assert idx2.rotation is not None and idx2.codes.shape == (2000, 4)

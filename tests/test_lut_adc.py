import jax
import jax.numpy as jnp
import numpy as np

from postgres_word2vec.ops import adc, lut


def _np_luts(q, cb):
    B = q.shape[0]
    m, k, dsub = cb.shape
    qs = q.reshape(B, m, dsub)
    return ((qs[:, :, None, :] - cb[None]) ** 2).sum(-1)


def test_build_luts_matches_numpy(rng):
    q = rng.normal(size=(3, 12)).astype(np.float32)
    cb = rng.normal(size=(4, 5, 3)).astype(np.float32)
    got = np.asarray(lut.build_luts(jnp.asarray(q), jnp.asarray(cb)))
    np.testing.assert_allclose(got, _np_luts(q, cb), rtol=1e-4, atol=1e-5)


def test_adc_distances_matches_numpy(rng):
    q = rng.normal(size=(2, 12)).astype(np.float32)
    cb = rng.normal(size=(4, 6, 3)).astype(np.float32)
    codes = rng.integers(0, 6, size=(50, 4)).astype(np.uint8)
    luts = _np_luts(q, cb)
    want = np.zeros((2, 50), np.float32)
    for b in range(2):
        for i in range(50):
            want[b, i] = sum(luts[b, j, codes[i, j]] for j in range(4))
    got = np.asarray(adc.adc_distances(jnp.asarray(luts), jnp.asarray(codes)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_double_luts_equal_normal(rng):
    q = rng.normal(size=(2, 12)).astype(np.float32)
    cb = rng.normal(size=(4, 6, 3)).astype(np.float32)
    codes = rng.integers(0, 6, size=(30, 4)).astype(np.uint8)
    luts = lut.build_luts(jnp.asarray(q), jnp.asarray(cb))
    normal = adc.adc_distances(luts, jnp.asarray(codes))
    dl = lut.build_double_luts(luts)
    fc = lut.fuse_codes(jnp.asarray(codes), 6)
    assert dl.shape == (2, 2, 36)
    fused = adc.adc_distances(dl, fc)
    np.testing.assert_allclose(np.asarray(fused), np.asarray(normal),
                               rtol=1e-5)


def test_adc_top_k_exhaustive(rng):
    q = rng.normal(size=(3, 12)).astype(np.float32)
    cb = rng.normal(size=(4, 6, 3)).astype(np.float32)
    codes = rng.integers(0, 6, size=(500, 4)).astype(np.uint8)
    luts = lut.build_luts(jnp.asarray(q), jnp.asarray(cb))
    dists = np.asarray(adc.adc_distances(luts, jnp.asarray(codes)))
    vals, idx = adc.adc_top_k(luts, jnp.asarray(codes), 5, chunk_size=64)
    want_idx = np.argsort(dists, -1)[:, :5]
    np.testing.assert_allclose(np.asarray(vals),
                               np.take_along_axis(dists, want_idx, -1),
                               rtol=1e-5)


def test_adc_top_k_in_respects_targets(rng):
    q = rng.normal(size=(2, 12)).astype(np.float32)
    cb = rng.normal(size=(4, 6, 3)).astype(np.float32)
    codes = rng.integers(0, 6, size=(200, 4)).astype(np.uint8)
    luts = lut.build_luts(jnp.asarray(q), jnp.asarray(cb))
    targets = np.array([5, 17, 42, 99, 150, 151, 7, 3], np.int32)
    mask = np.ones(8, bool)
    vals, ids = adc.adc_top_k_in(luts, jnp.asarray(codes),
                                 jnp.asarray(targets), jnp.asarray(mask), 3)
    dists = np.asarray(adc.adc_distances(luts, jnp.asarray(codes)))
    want = np.sort(dists[:, targets], -1)[:, :3]
    np.testing.assert_allclose(np.asarray(vals), want, rtol=1e-5)
    assert set(np.asarray(ids).ravel()) <= set(targets.tolist())


def test_adc_top_k_in_padding(rng):
    q = rng.normal(size=(1, 12)).astype(np.float32)
    cb = rng.normal(size=(4, 6, 3)).astype(np.float32)
    codes = rng.integers(0, 6, size=(50, 4)).astype(np.uint8)
    luts = lut.build_luts(jnp.asarray(q), jnp.asarray(cb))
    targets = np.array([5, 17, -1, -1], np.int32)
    mask = np.array([True, True, False, False])
    vals, ids = adc.adc_top_k_in(luts, jnp.asarray(codes),
                                 jnp.asarray(targets), jnp.asarray(mask), 4)
    ids = np.asarray(ids)
    assert set(ids[0, :2].tolist()) == {5, 17}
    assert (ids[0, 2:] == -1).all()
    assert np.isinf(np.asarray(vals)[0, 2:]).all()


def test_post_verify_reranks_exactly(rng):
    vectors = rng.normal(size=(100, 12)).astype(np.float32)
    q = rng.normal(size=(2, 12)).astype(np.float32)
    cand = np.array([[3, 50, 7, 99, 1], [0, 2, 4, 6, 8]], np.int32)
    cd = np.zeros_like(cand, np.float32)
    vals, ids = adc.post_verify(jnp.asarray(q), jnp.asarray(cand),
                                jnp.asarray(cd), jnp.asarray(vectors), 3)
    d_all = ((q[:, None, :] - vectors[cand]) ** 2).sum(-1)
    order = np.argsort(d_all, -1)[:, :3]
    np.testing.assert_allclose(np.asarray(vals),
                               np.take_along_axis(d_all, order, -1),
                               rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(ids),
                                  np.take_along_axis(cand, order, -1))


def test_xla_scan_chunks_capped(rng):
    """The XLA gather scan takes chunks of at most ``_XLA_CHUNK`` rows
    whatever memory allows (two here, the last clamped to end at row n and
    its overlap masked), and answers like brute force."""
    n = adc._XLA_CHUNK + 5
    codes = rng.integers(0, 16, size=(n, 2)).astype(np.uint8)
    luts = rng.random((1, 2, 16)).astype(np.float32)
    jaxpr = str(jax.make_jaxpr(lambda l, c: adc.adc_top_k(l, c, 3))(
        jnp.asarray(luts), jnp.asarray(codes)))
    assert "length=2" in jaxpr
    d, i = adc.adc_top_k(jnp.asarray(luts), jnp.asarray(codes), 3)
    full = luts[0, 0, codes[:, 0]] + luts[0, 1, codes[:, 1]]
    np.testing.assert_allclose(np.asarray(d)[0], np.sort(full)[:3],
                               rtol=1e-6)
    np.testing.assert_allclose(full[np.asarray(i)[0]], np.asarray(d)[0],
                               rtol=1e-6)

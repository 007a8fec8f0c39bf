import numpy as np
import jax.numpy as jnp

from postgres_word2vec.ops import vector_ops as vo


def test_cosine_similarity_matches_numpy(rng):
    a = rng.normal(size=(7, 32)).astype(np.float32)
    b = rng.normal(size=(7, 32)).astype(np.float32)
    got = np.asarray(vo.cosine_similarity(jnp.asarray(a), jnp.asarray(b)))
    want = np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cosine_norm_is_dot(rng):
    a = rng.normal(size=(5, 16)).astype(np.float32)
    b = rng.normal(size=(5, 16)).astype(np.float32)
    an = a / np.linalg.norm(a, axis=-1, keepdims=True)
    bn = b / np.linalg.norm(b, axis=-1, keepdims=True)
    got = np.asarray(vo.cosine_similarity_norm(jnp.asarray(an),
                                               jnp.asarray(bn)))
    np.testing.assert_allclose(got, np.sum(an * bn, -1), rtol=1e-5)


def test_normalize_and_algebra(rng):
    a = rng.normal(size=(4, 8)).astype(np.float32)
    b = rng.normal(size=(4, 8)).astype(np.float32)
    n = np.asarray(vo.vec_normalize(jnp.asarray(a)))
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(vo.vec_plus(a, b)), a + b)
    np.testing.assert_allclose(np.asarray(vo.vec_minus(a, b)), a - b)


def test_centroid(rng):
    vs = rng.normal(size=(10, 6)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(vo.centroid(jnp.asarray(vs))),
                               vs.mean(0), rtol=1e-5)


def test_sim_sqdist_roundtrip_on_unit_vectors(rng):
    a = rng.normal(size=(9, 12)).astype(np.float32)
    b = rng.normal(size=(9, 12)).astype(np.float32)
    an = a / np.linalg.norm(a, axis=-1, keepdims=True)
    bn = b / np.linalg.norm(b, axis=-1, keepdims=True)
    sq = np.asarray(vo.squared_l2(jnp.asarray(an), jnp.asarray(bn)))
    sim = np.asarray(vo.sim_from_sqdist(sq))
    np.testing.assert_allclose(sim, np.sum(an * bn, -1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(vo.sqdist_from_sim(sim)), sq,
                               atol=1e-5)

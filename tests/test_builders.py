import jax
import jax.numpy as jnp
import numpy as np

from postgres_word2vec.models.builders import (IVFADCIndexCreator,
                                                   PQIndexCreator,
                                                   VectorFeeder)



def _data(rng, n=1200, d=24):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_vector_feeder(rng):
    v = _data(rng, 1000)
    feeder = VectorFeeder(v, batch_size=300)
    batches = list(feeder)
    assert [b.shape[0] for b, _ in batches] == [300, 300, 300, 100]
    assert [off for _, off in batches] == [0, 300, 600, 900]
    np.testing.assert_array_equal(np.concatenate([b for b, _ in batches]), v)


def test_streaming_pq_equals_monolithic(rng):
    v = _data(rng)
    creator = PQIndexCreator.from_training(jax.random.PRNGKey(0), v, m=6,
                                           k=16, iters=6)
    for batch, _ in VectorFeeder(v, batch_size=256):
        creator.index_batch(batch)
    idx = creator.finalize()
    # monolithic encode with the same codebook must give identical codes
    from postgres_word2vec.ops import kmeans
    want = np.asarray(kmeans.encode_subspaces(jnp.asarray(v),
                                              creator.codebook.centroids))
    np.testing.assert_array_equal(np.asarray(idx.codes), want)
    np.testing.assert_array_equal(np.asarray(idx.codebook.counts).sum(-1),
                                  [1200] * 6)


def test_pq_checkpoint_resume(rng, tmp_path):
    v = _data(rng)
    creator = PQIndexCreator.from_training(jax.random.PRNGKey(0), v, m=6,
                                           k=16, iters=6)
    feeder = VectorFeeder(v, batch_size=400)
    b, _ = feeder.next_batch()
    creator.index_batch(b)
    creator.checkpoint(tmp_path / "ckpt.npz")

    resumed = PQIndexCreator.resume(tmp_path / "ckpt.npz")
    assert resumed.rows_done == 400
    while feeder.has_next():
        b, _ = feeder.next_batch()
        resumed.index_batch(b)
    idx = resumed.finalize()
    assert idx.size == 1200

    # against a non-streaming build with the same codebook
    full = PQIndexCreator(creator.codebook)
    full.index_batch(v)
    np.testing.assert_array_equal(np.asarray(idx.codes),
                                  np.asarray(full.finalize().codes))


def test_streaming_ivfadc(rng, tmp_path):
    v = _data(rng)
    creator = IVFADCIndexCreator.from_training(jax.random.PRNGKey(1), v,
                                               m=6, k=16, k_coarse=10,
                                               iters=6)
    feeder = VectorFeeder(v, batch_size=500)
    b, _ = feeder.next_batch()
    creator.index_batch(b)
    creator.checkpoint(tmp_path / "ivf.npz")
    resumed = IVFADCIndexCreator.resume(tmp_path / "ivf.npz")
    while feeder.has_next():
        b, _ = feeder.next_batch()
        resumed.index_batch(b)
    idx = resumed.finalize()
    assert idx.size == 1200
    # searchable and self-consistent
    d, i = idx.search_adaptive(jnp.asarray(v[:5]), 3, w=3)
    assert (np.asarray(i)[:, 0] == np.arange(5)).mean() >= 0.8

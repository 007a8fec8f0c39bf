"""Tests for the synthetic data generators (evaluation/synth.py)."""

import jax
import numpy as np

from postgres_word2vec.evaluation import synth


def test_wordlike_shapes_and_norms():
    v = synth.generate_wordlike(jax.random.PRNGKey(0), 3000, 32,
                                n_topics=16, group=8, chunk_size=1024)
    assert v.shape == (3000, 32)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(v), axis=-1), 1.0,
                               rtol=1e-5)


def test_wordlike_deterministic():
    a = synth.generate_wordlike(jax.random.PRNGKey(7), 500, 16, n_topics=8)
    b = synth.generate_wordlike(jax.random.PRNGKey(7), 500, 16, n_topics=8)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_wordlike_chunking_invariant():
    """Chunked generation must produce identical rows regardless of
    chunk_size (per-chunk fold_in keyed by chunk index)."""
    a = synth.generate_wordlike(jax.random.PRNGKey(3), 600, 16,
                                n_topics=8, chunk_size=200)
    b = synth.generate_wordlike(jax.random.PRNGKey(3), 600, 16,
                                n_topics=8, chunk_size=200)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert a.shape == (600, 16)


def test_wordlike_has_neighbor_structure():
    """Rows sharing a concept must be much closer than random pairs — the
    property that makes recall measurable (real embeddings' near-synonym
    structure)."""
    n = 4000
    v = np.asarray(synth.generate_wordlike(jax.random.PRNGKey(1), n, 64,
                                           n_topics=32, group=8,
                                           chunk_size=2048))
    q = v[:64]
    sims = q @ v.T
    np.fill_diagonal(sims[:, :64], -1.0)
    top1 = np.sort(sims, axis=-1)[:, -1]
    med_pair = np.median(sims)
    # nearest neighbor clearly separated from the bulk
    assert np.median(top1) > med_pair + 0.25


def test_mixture_still_available():
    v = synth.generate_mixture(jax.random.PRNGKey(0), 2000, 24, eval_q=16)
    assert v.shape == (2000, 24)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(v), axis=-1), 1.0,
                               rtol=1e-5)

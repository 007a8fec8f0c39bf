import jax.numpy as jnp
import numpy as np
import pytest

from postgres_word2vec.ops import topk


def test_top_k_smallest_matches_sort(rng):
    d = rng.normal(size=(4, 50)).astype(np.float32)
    vals, idx = topk.top_k_smallest(jnp.asarray(d), 7)
    order = np.argsort(d, axis=-1)[:, :7]
    np.testing.assert_allclose(np.asarray(vals),
                               np.take_along_axis(d, order, -1), rtol=1e-6)
    np.testing.assert_allclose(np.take_along_axis(d, np.asarray(idx), -1),
                               np.take_along_axis(d, order, -1), rtol=1e-6)


def test_merge_top_k(rng):
    a = rng.normal(size=(3, 5)).astype(np.float32)
    b = rng.normal(size=(3, 4)).astype(np.float32)
    ia = np.arange(5)[None, :].repeat(3, 0)
    ib = (np.arange(4) + 100)[None, :].repeat(3, 0)
    vals, idx = topk.merge_top_k_smallest(
        jnp.asarray(a), jnp.asarray(ia), jnp.asarray(b), jnp.asarray(ib), 6)
    both = np.concatenate([a, b], -1)
    want = np.sort(both, -1)[:, :6]
    np.testing.assert_allclose(np.asarray(vals), want, rtol=1e-6)


def test_chunked_top_k_equals_global(rng):
    n, chunk = 1000, 128
    d = rng.normal(size=(2, n)).astype(np.float32)
    pad = (-n) % chunk
    dp = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)

    def score_chunk(start):
        return jnp.asarray(dp)[:, start:start + chunk] \
            if isinstance(start, int) else jnp.take(
                jnp.asarray(dp), start + jnp.arange(chunk), axis=1)

    vals, idx = topk.chunked_top_k_smallest(score_chunk, n + pad, chunk, 10,
                                            (2,))
    want_idx = np.argsort(d, -1)[:, :10]
    np.testing.assert_allclose(np.asarray(vals),
                               np.take_along_axis(d, want_idx, -1), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), want_idx)


def test_blockwise_top_k_exact(rng):
    from postgres_word2vec.ops.topk import _blockwise_top_k_smallest
    d = rng.normal(size=(3, 20000)).astype(np.float32)
    vals, idx = _blockwise_top_k_smallest(jnp.asarray(d), 7, block=512)
    order = np.argsort(d, -1)[:, :7]
    np.testing.assert_allclose(np.asarray(vals),
                               np.take_along_axis(d, order, -1), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), order)


def test_blockwise_top_k_with_inf_padding(rng):
    from postgres_word2vec.ops.topk import _blockwise_top_k_smallest
    d = rng.normal(size=(2, 1000)).astype(np.float32)   # 1000 % 512 != 0
    vals, idx = _blockwise_top_k_smallest(jnp.asarray(d), 5, block=512)
    order = np.argsort(d, -1)[:, :5]
    np.testing.assert_array_equal(np.asarray(idx), order)


def test_top_k_smallest_wide_rows_use_blockwise(rng):
    d = rng.normal(size=(2, 70000)).astype(np.float32)
    vals, idx = topk.top_k_smallest(jnp.asarray(d), 9)
    order = np.argsort(d, -1)[:, :9]
    np.testing.assert_array_equal(np.asarray(idx), order)


def test_use_blockwise_routing_rule():
    """Exact-path routing: the CPU takes blockwise for any row >= 64k;
    the GPU only for a few such rows (XLA's top_k wins from B=256 up)."""
    from postgres_word2vec.ops.topk import _GPU_BLOCKWISE_ROWS, _use_blockwise

    # narrow rows and huge k never take blockwise
    assert not _use_blockwise(1, 4096, 10, on_gpu=False)
    assert not _use_blockwise(1, 3_072_000, 10_000, on_gpu=False)
    assert not _use_blockwise(1, 4096, 10, on_gpu=True)
    # CPU: any wide row
    assert _use_blockwise(256, 65_536, 5, on_gpu=False)
    assert _use_blockwise(1024, 3_072_000, 200, on_gpu=False)
    # GPU: a single query's wide row, never a full batch
    assert _use_blockwise(1, 3_072_000, 10, on_gpu=True)
    assert _use_blockwise(_GPU_BLOCKWISE_ROWS, 3_072_000, 200, on_gpu=True)
    assert not _use_blockwise(_GPU_BLOCKWISE_ROWS + 1, 3_072_000, 10,
                              on_gpu=True)
    assert not _use_blockwise(256, 3_072_000, 200, on_gpu=True)


@pytest.mark.parametrize("k", [1, 10, 200])
def test_approx_bins_meet_recall_target(k):
    """L strided bins give expected recall 1 − (k−1)/(2L) ≥ the target."""
    L = topk.approx_bins(k, 0.95)
    assert L >= k and L & (L - 1) == 0
    assert 1 - (k - 1) / (2 * L) >= 0.95


@pytest.mark.parametrize("k", [10, 200])
def test_binned_top_k_recall_and_consistency(rng, k):
    d = rng.random((8, 100_003)).astype(np.float32)
    vals, idx = topk._binned_top_k_smallest(jnp.asarray(d), k, 0.95)
    vals, idx = np.asarray(vals), np.asarray(idx)
    np.testing.assert_array_equal(np.take_along_axis(d, idx, -1), vals)
    want = np.argsort(d, -1)[:, :k]
    hits = np.mean([len(set(a) & set(b)) / k for a, b in
                    zip(idx.tolist(), want.tolist())])
    assert hits >= 0.9
    assert (np.diff(vals, axis=-1) >= 0).all()


def test_approx_dispatch(rng, monkeypatch):
    """approx=True is exact on the CPU reference and binned on the GPU;
    narrow rows fall back to exact either way."""
    from postgres_word2vec.ops import backend
    d = jnp.asarray(rng.random((2, 50_000)).astype(np.float32))
    exact = np.asarray(topk.top_k_smallest(d, 10)[1])
    np.testing.assert_array_equal(
        np.asarray(topk.top_k_smallest(d, 10, approx=True)[1]), exact)
    monkeypatch.setattr(backend, "use_kernels", lambda: True)
    calls = []
    orig = topk._binned_top_k_smallest
    monkeypatch.setattr(topk, "_binned_top_k_smallest",
                        lambda *a: calls.append(1) or orig(*a))
    topk.top_k_smallest(d, 10, approx=True)
    assert calls
    small = d[:, :200]
    np.testing.assert_array_equal(
        np.asarray(topk.top_k_smallest(small, 10, approx=True)[1]),
        np.argsort(np.asarray(small), -1)[:, :10])

import jax.numpy as jnp
import numpy as np
import pytest

from postgres_word2vec.models.exact import ExactIndex


def _brute(q, v, k):
    d = ((q[:, None, :] - v[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d, -1)[:, :k]
    return np.take_along_axis(d, idx, -1), idx


def test_exact_search_small(rng):
    v = rng.normal(size=(500, 16)).astype(np.float32)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    idx = ExactIndex(jnp.asarray(v))
    d, i = idx.search(jnp.asarray(q), 5)
    wd, wi = _brute(q, v, 5)
    np.testing.assert_allclose(np.asarray(d), wd, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), wi)


def test_exact_search_chunked(rng):
    # force the chunked path with a chunk smaller than n
    from postgres_word2vec.models.exact import exact_top_k
    v = rng.normal(size=(1000, 8)).astype(np.float32)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    d, i = exact_top_k(jnp.asarray(q), jnp.asarray(v), 7, chunk_size=128)
    wd, wi = _brute(q, v, 7)
    np.testing.assert_allclose(np.asarray(d), wd, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), wi)


def test_exact_search_in(rng):
    v = rng.normal(size=(200, 8)).astype(np.float32)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    idx = ExactIndex(jnp.asarray(v))
    targets = np.array([3, 77, 150, 42, 9], np.int32)
    d, i = idx.search_in(jnp.asarray(q), 3, jnp.asarray(targets))
    dt = ((q[:, None, :] - v[targets][None, :, :]) ** 2).sum(-1)
    order = np.argsort(dt, -1)[:, :3]
    np.testing.assert_array_equal(np.asarray(i), targets[order])


def test_exact_search_in_fewer_targets_than_k(rng):
    v = rng.normal(size=(50, 8)).astype(np.float32)
    q = rng.normal(size=(1, 8)).astype(np.float32)
    idx = ExactIndex(jnp.asarray(v))
    targets = np.array([3, 7], np.int32)
    d, i = idx.search_in(jnp.asarray(q), 5, jnp.asarray(targets))
    assert d.shape == (1, 5) and i.shape == (1, 5)
    assert set(np.asarray(i)[0, :2].tolist()) == {3, 7}
    assert (np.asarray(i)[0, 2:] == -1).all()


def test_bfloat16_mode_close_to_f32(rng):
    v = rng.normal(size=(400, 32)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    q = v[:2] + rng.normal(scale=0.01, size=(2, 32)).astype(np.float32)
    f32 = ExactIndex(jnp.asarray(v), "float32")
    bf16 = ExactIndex(jnp.asarray(v), "bfloat16")
    _, i32 = f32.search(jnp.asarray(q), 10)
    _, i16 = bf16.search(jnp.asarray(q), 10)
    # top-1 must agree; top-10 heavy overlap
    np.testing.assert_array_equal(np.asarray(i32)[:, 0], np.asarray(i16)[:, 0])
    overlap = len(set(np.asarray(i32).ravel()) & set(np.asarray(i16).ravel()))
    assert overlap >= 16


def test_scan_chunk_from_device_memory(rng, monkeypatch):
    """The default chunk comes from the device's memory limit: a small
    limit forces the chunked path, whose answer equals brute force."""
    from postgres_word2vec.models import exact as exact_mod
    from postgres_word2vec.ops import backend

    assert backend.scan_chunk(4, 10_000) == 10_000        # fits whole
    monkeypatch.setattr(backend, "memory_limit_bytes", lambda: 32 * 4096)
    assert backend.scan_chunk(4, 10_000, floor=64) == 256
    v = rng.normal(size=(1000, 16)).astype(np.float32)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    d, i = exact_mod.exact_top_k.__wrapped__(jnp.asarray(q), jnp.asarray(v),
                                             5)
    wd, wi = _brute(q, v, 5)
    np.testing.assert_array_equal(np.asarray(i), wi)


@pytest.mark.parametrize("impl,kernels,want", [
    (None, False, False), (None, True, True), ("xla", True, False),
    ("xla", False, False)])
def test_kernels_for_impl(monkeypatch, impl, kernels, want):
    """A search's ``impl`` resolves against the backend: None follows it,
    "xla" always takes the reference."""
    from postgres_word2vec.ops import backend

    monkeypatch.setattr(backend, "use_kernels", lambda: kernels)
    assert backend.kernels_for(impl) is want


def test_kernels_for_rejects_unknown_impl():
    from postgres_word2vec.ops import backend

    with pytest.raises(ValueError):
        backend.kernels_for("pallas")


def test_int8_mode_recall(rng):
    v = rng.normal(size=(2000, 32)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    q = v[:8] + rng.normal(scale=0.05, size=(8, 32)).astype(np.float32)
    f32 = ExactIndex(jnp.asarray(v), "float32")
    i8 = ExactIndex(jnp.asarray(v), "int8")
    _, want = f32.search(jnp.asarray(q), 10, approx=False)
    _, got = i8.search(jnp.asarray(q), 10, approx=False)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(np.asarray(got), np.asarray(want))])
    assert overlap > 0.9
    # top-1 (the query's true neighbor) must survive quantization
    np.testing.assert_array_equal(np.asarray(got)[:, 0],
                                  np.asarray(want)[:, 0])


def test_int8_quantization_roundtrip(rng):
    from postgres_word2vec.models.exact import quantize_rows_int8
    v = rng.normal(size=(50, 16)).astype(np.float32)
    q, s = quantize_rows_int8(jnp.asarray(v))
    assert q.dtype == jnp.int8
    back = np.asarray(q, np.float32) * np.asarray(s)[:, None]
    np.testing.assert_allclose(back, v, atol=np.abs(v).max() / 120)


def test_snap_chunk_divisor_selection():
    """_snap_chunk must return a dividing, 8-aligned chunk when one exists
    in [c/2, c] (no tail pad => no full-table copy), else pass through."""
    from postgres_word2vec.models.exact import _snap_chunk

    c = _snap_chunk(10_240_000, 1_048_576)
    assert 10_240_000 % c == 0 and c % 8 == 0 and 524_288 <= c <= 1_048_576
    c = _snap_chunk(3_072_000, 1_048_576)
    assert 3_072_000 % c == 0 and c % 8 == 0
    # prime n: no divisor in range -> unchanged (pad path)
    assert _snap_chunk(1_000_003, 4096) == 4096
    # already dividing or small n: unchanged
    assert _snap_chunk(8192, 2048) == 2048
    assert _snap_chunk(100, 4096) == 4096


def test_exact_top_k_snapped_chunk_matches_unchunked(rng):
    """A non-dividing chunk request (snap path) returns identical results
    to the single-chunk scan."""
    import jax.numpy as jnp

    from postgres_word2vec.models.exact import exact_top_k

    v = jnp.asarray(rng.normal(size=(1000, 16)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(4, 16)).astype(np.float32))
    want_v, want_i = exact_top_k(q, v, 5, chunk_size=4096)
    got_v, got_i = exact_top_k(q, v, 5, chunk_size=304)  # snaps to 500... or pads
    np.testing.assert_array_equal(np.asarray(want_i), np.asarray(got_i))
    np.testing.assert_allclose(np.asarray(want_v), np.asarray(got_v),
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_extended_matches_fresh_build(dtype):
    """O(batch) extended() must search exactly like an index built from
    scratch on the concatenated table (per-row quantization makes int8
    bitwise identical)."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(500, 32)).astype(np.float32)
    extra = rng.normal(size=(37, 32)).astype(np.float32)
    full = jnp.asarray(np.concatenate([base, extra], 0))
    idx = ExactIndex(jnp.asarray(base), dtype)
    idx2 = idx.extended(full, jnp.asarray(extra))
    fresh = ExactIndex(full, dtype)
    q = jnp.asarray(rng.normal(size=(6, 32)).astype(np.float32))
    d_e, i_e = idx2.search(q, 7)
    d_f, i_f = fresh.search(q, 7)
    np.testing.assert_array_equal(np.asarray(i_e), np.asarray(i_f))
    np.testing.assert_allclose(np.asarray(d_e), np.asarray(d_f),
                               rtol=1e-5, atol=1e-5)
    # capacity padding rows never leak into results
    assert (np.asarray(i_e) < 537).all()
    # repeated extension reuses capacity (amortized growth)
    idx3 = idx2.extended(full, jnp.asarray(extra[:4]))  # ids alias test only
    assert idx3._size == 537 + 4
    assert idx3._table.shape[0] == idx2._table.shape[0]  # no regrow
    # search_in gathers from the aliased full table
    tids = jnp.asarray(np.arange(500, 537, dtype=np.int32))
    d_in, i_in = idx2.search_in(q, 3, tids)
    assert (np.asarray(i_in) >= 500).all()


def test_approx_search_on_gpu_path_is_binned(rng, monkeypatch):
    """With the GPU dispatch, ``approx=True`` takes the binned partial
    reduction (not a full sort): recall stays high but is allowed to be
    approximate; on the CPU reference it equals the exact answer."""
    from postgres_word2vec.ops import backend

    v = rng.normal(size=(40_000, 8)).astype(np.float32)
    q = rng.normal(size=(4, 8)).astype(np.float32)
    idx = ExactIndex(jnp.asarray(v), "float32")
    _, exact_i = idx.search(jnp.asarray(q), 10, approx=False)
    _, cpu_i = idx.search(jnp.asarray(q), 10, approx=True)
    np.testing.assert_array_equal(np.asarray(cpu_i), np.asarray(exact_i))
    monkeypatch.setattr(backend, "use_kernels", lambda: True)
    idx2 = ExactIndex(jnp.asarray(v), "float32")
    _, gpu_i = idx2.search(jnp.asarray(q), 10, approx=True)
    hits = np.mean([len(set(a) & set(b)) / 10 for a, b in
                    zip(np.asarray(gpu_i).tolist(),
                        np.asarray(exact_i).tolist())])
    assert hits >= 0.8

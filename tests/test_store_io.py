import numpy as np
import pytest

from postgres_word2vec.store import VectorStore, _load_text_embeddings_py


def _write_text(path, words, vecs):
    with open(path, "w") as f:
        f.write(f"{len(words)} {vecs.shape[1]}\n")
        for w, v in zip(words, vecs):
            f.write(w + " " + " ".join(f"{x:.6f}" for x in v) + "\n")


def _write_binary(path, words, vecs):
    with open(path, "wb") as f:
        f.write(f"{len(words)} {vecs.shape[1]}\n".encode())
        for w, v in zip(words, vecs):
            f.write(w.encode() + b" " + v.astype(np.float32).tobytes()
                    + b"\n")


@pytest.fixture()
def sample(rng, tmp_path):
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    words = [f"tok{i}" for i in range(50)]
    return words, vecs, tmp_path


def test_text_python_parser(sample):
    words, vecs, tmp = sample
    _write_text(tmp / "e.txt", words, vecs)
    w, v = _load_text_embeddings_py(tmp / "e.txt", None)
    assert w == words
    np.testing.assert_allclose(v, vecs, atol=1e-5)


def test_store_from_text_native_and_python_agree(sample):
    words, vecs, tmp = sample
    _write_text(tmp / "e.txt", words, vecs)
    s_native = VectorStore.from_text_file(tmp / "e.txt", use_native=True)
    s_py = VectorStore.from_text_file(tmp / "e.txt", use_native=False)
    assert s_native.words == s_py.words == words
    np.testing.assert_allclose(np.asarray(s_native.vectors),
                               np.asarray(s_py.vectors), atol=1e-5)
    # normalized table is unit length
    norms = np.linalg.norm(np.asarray(s_native.vectors_norm), axis=-1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_store_from_binary(sample):
    words, vecs, tmp = sample
    _write_binary(tmp / "e.bin", words, vecs)
    s = VectorStore.from_binary_file(tmp / "e.bin")
    assert s.words == words
    np.testing.assert_array_equal(np.asarray(s.vectors), vecs)


def test_max_words(sample):
    words, vecs, tmp = sample
    _write_text(tmp / "e.txt", words, vecs)
    s = VectorStore.from_text_file(tmp / "e.txt", max_words=10)
    assert s.size == 10


def test_store_save_load_extend(sample, tmp_path):
    words, vecs, _ = sample
    s = VectorStore.from_arrays(words, vecs)
    s.save(tmp_path / "store.npz")
    s2 = VectorStore.load(tmp_path / "store.npz")
    assert s2.words == s.words
    np.testing.assert_allclose(np.asarray(s2.vectors),
                               np.asarray(s.vectors))
    s3 = s2.extend(["new1"], vecs[:1] * 2)
    assert s3.size == 51 and s3.get_id("new1") == 50
    with pytest.raises(ValueError):
        s3.extend(["tok0"], vecs[:1])


def test_native_long_slowpath_token(sample, tmp_path):
    """A >63-char slow-path token (hex float) must parse whole — a
    truncated strtof would silently shift every later column (round-2
    review of the SIGBUS guard)."""
    longtok = "0x1." + "0" * 70 + "p0"   # == 1.0, forces the strtof path
    p = tmp_path / "long.txt"
    p.write_text("2 3\n" f"w0 {longtok} 2.0 3.0\n" "w1 4.0 5.0 6.0\n")
    try:
        s = VectorStore.from_text_file(p, use_native=True)
    except OSError:
        pytest.skip("native fastio unavailable")
    np.testing.assert_allclose(np.asarray(s.vectors),
                               [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]],
                               atol=1e-6)


def test_extend_inplace_matches_extend(sample):
    words, vecs, _ = sample
    s1 = VectorStore.from_arrays(words, vecs)
    s2 = VectorStore.from_arrays(words, vecs)
    out_copy = s1.extend(["n1", "n2"], vecs[:2] * 3)
    ret = s2.extend_inplace(["n1", "n2"], vecs[:2] * 3)
    assert ret is s2
    assert s2.words == out_copy.words
    assert s2.word_to_id == out_copy.word_to_id
    np.testing.assert_allclose(np.asarray(s2.vectors),
                               np.asarray(out_copy.vectors), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s2.vectors_norm),
                               np.asarray(out_copy.vectors_norm), rtol=1e-6)
    # duplicate check fires BEFORE mutation
    n0 = s2.size
    import pytest
    with pytest.raises(ValueError, match="already present"):
        s2.extend_inplace(["fresh", "n1"], vecs[:2])
    assert s2.size == n0 and "fresh" not in s2


def test_extend_inplace_split_path_matches_fused(sample, monkeypatch):
    """When the fused program's old+new transient of BOTH tables would
    pass its share of device memory, the insert concat runs as two
    sequential per-table programs. Force the split on a small store (a
    tiny reported memory) and require parity with the fused path."""
    from postgres_word2vec.ops import backend
    words, vecs, _ = sample
    s_fused = VectorStore.from_arrays(words, vecs)
    s_split = VectorStore.from_arrays(words, vecs)
    s_fused.extend_inplace(["n1", "n2"], vecs[:2] * 3)
    monkeypatch.setattr(backend, "memory_limit_bytes", lambda: 1024)
    s_split.extend_inplace(["n1", "n2"], vecs[:2] * 3)
    np.testing.assert_allclose(np.asarray(s_split.vectors),
                               np.asarray(s_fused.vectors), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s_split.vectors_norm),
                               np.asarray(s_fused.vectors_norm), rtol=1e-6)

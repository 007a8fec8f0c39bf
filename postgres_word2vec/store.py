"""Vector store + vocabulary — the framework's L0.

Replaces the reference's Postgres tables ``google_vecs`` /
``google_vecs_norm`` (``(id, word, vector bytea)`` rows created by
index_creation/vec2database.py:25-60) with:

- a host-side vocabulary (word ↔ id dict; ids are dense row indices), and
- device-resident ``(N, d)`` float32 arrays for raw and L2-normalized vectors.

The bytea little-endian codec boundary (freddy.c:1660-1826 ``read_bytea*`` /
``vec_to_bytea``) disappears — arrays are the native format — but the
word2vec text/binary file parsers are kept (index_utils.py:8-40,
transform_vecs.py) with an optional C++ fast path (native/fastio.cpp).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from postgres_word2vec.ops import backend
from postgres_word2vec.ops.vector_ops import vec_normalize

Array = jax.Array


@jax.jit
def _extend_tables(vectors, vectors_norm, new_raw):
    """Append new rows to both tables in ONE compiled program (raw concat
    + normalize-and-concat) — one device dispatch per insert batch."""
    nv = new_raw.astype(jnp.float32)
    return (jnp.concatenate([vectors, nv], axis=0),
            jnp.concatenate([vectors_norm, vec_normalize(nv)], axis=0))


@jax.jit
def _append_rows(table, new_rows):
    return jnp.concatenate([table, new_rows.astype(jnp.float32)], axis=0)


@jax.jit
def _append_rows_norm(table, new_raw):
    return jnp.concatenate(
        [table, vec_normalize(new_raw.astype(jnp.float32))], axis=0)


#: the fused insert concat holds old+new of BOTH tables at once (2x their
#: combined size); it runs while that transient stays within this share
#: of the device's memory. Above it the concat splits into two sequential
#: per-table programs, capping the transient at 3x one table for one
#: extra dispatch.
_FUSED_EXTEND_SHARE = 4


@dataclasses.dataclass
class VectorStore:
    """Vocabulary + device-resident vector tables.

    ``id`` is the dense row index (0..N-1). The reference uses arbitrary
    serial ids and joins words back via SQL; here the join is an O(1) list
    index.
    """

    words: list[str]
    word_to_id: dict[str, int]
    vectors: Array        # (N, d) float32, raw
    vectors_norm: Array   # (N, d) float32, L2-normalized

    # ------------------------------------------------------------ creation
    @classmethod
    def from_arrays(cls, words: Sequence[str], vectors,
                    normalized: bool = False) -> "VectorStore":
        vecs = jnp.asarray(vectors, dtype=jnp.float32)
        if vecs.ndim != 2 or vecs.shape[0] != len(words):
            raise ValueError(
                f"vectors shape {vecs.shape} does not match {len(words)} words")
        norm = vecs if normalized else vec_normalize(vecs)
        word_to_id = {w: i for i, w in enumerate(words)}
        if len(word_to_id) != len(words):
            raise ValueError("duplicate words in vocabulary")
        return cls(list(words), word_to_id, vecs, norm)

    @classmethod
    def from_text_file(cls, path: str | Path, max_words: int | None = None,
                       use_native: bool = True) -> "VectorStore":
        """Parse word2vec text format (header line ``N d``, then
        ``word v1 … vd`` rows) — parity with index_utils.py:8-40.

        Uses the C++ parser (native/fastio.cpp) when built; falls back to
        numpy.
        """
        words, vecs = _load_text_embeddings(Path(path), max_words,
                                            use_native=use_native)
        return cls.from_arrays(words, vecs)

    @classmethod
    def from_binary_file(cls, path: str | Path,
                         max_words: int | None = None) -> "VectorStore":
        """Load word2vec .bin format directly via the native parser —
        replaces the reference's gensim conversion step
        (transform_vecs.py:1-9)."""
        from postgres_word2vec.utils import native_io
        words, vecs = native_io.load_binary_embeddings(Path(path), max_words)
        return cls.from_arrays(words, vecs)

    # ------------------------------------------------------------- lookups
    @property
    def size(self) -> int:
        return len(self.words)

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    def __len__(self) -> int:
        return len(self.words)

    def __contains__(self, word: str) -> bool:
        return word in self.word_to_id

    def get_id(self, word: str) -> int:
        return self.word_to_id[word]

    def get_ids(self, words: Iterable[str], *, strict: bool = True) -> list[int]:
        """Map words → ids. ``strict=False`` silently drops unknown words
        (the reference's SQL joins drop non-matching rows the same way)."""
        if strict:
            return [self.word_to_id[w] for w in words]
        return [self.word_to_id[w] for w in words if w in self.word_to_id]

    def get_words(self, ids: Iterable[int]) -> list[str]:
        return [self.words[i] if 0 <= i < len(self.words) else "" for i in ids]

    def vector_for(self, word: str, *, normalized: bool = True) -> Array:
        table = self.vectors_norm if normalized else self.vectors
        return table[self.word_to_id[word]]

    def vectors_for(self, words: Sequence[str], *,
                    normalized: bool = True) -> Array:
        ids = jnp.asarray(self.get_ids(words), dtype=jnp.int32)
        table = self.vectors_norm if normalized else self.vectors
        return jnp.take(table, ids, axis=0)

    # ------------------------------------------------------------ mutation
    def extend(self, words: Sequence[str], vectors) -> "VectorStore":
        """Append new (word, vector) rows, returning a new store.

        Backs ``insert_batch`` (freddy.c:1403-1658): new rows get the next
        dense ids. Duplicate words are rejected (the reference skips terms
        already present, freddy.c:1498-1514 — that filtering happens in
        :meth:`postgres_word2vec.api.Freddy.insert_batch`).
        """
        vecs = jnp.asarray(vectors, dtype=jnp.float32)
        for w in words:
            if w in self.word_to_id:
                raise ValueError(f"word already present: {w!r}")
        new_words = self.words + list(words)
        new_vecs = jnp.concatenate([self.vectors, vecs], axis=0)
        new_norm = jnp.concatenate([self.vectors_norm, vec_normalize(vecs)],
                                   axis=0)
        w2i = dict(self.word_to_id)
        for i, w in enumerate(words, start=len(self.words)):
            w2i[w] = i
        return VectorStore(new_words, w2i, new_vecs, new_norm)

    def extend_inplace(self, words: Sequence[str], vectors) -> "VectorStore":
        """O(batch) insert-path variant of :meth:`extend`: mutates THIS
        store and returns it.

        :meth:`extend`'s copy semantics duplicate the whole vocabulary per
        call (a 3M-entry dict copy is ~100s of ms on a 1-core host —
        O(N) host work per insert, where the reference's insert is
        O(batch), freddy.c:1403-1658). Here the host side is a pure append
        (list.extend + dict update) and the device side is ONE fused
        concat program (two table memcpys — bandwidth, no per-row
        recompute of existing rows). Duplicate checks happen BEFORE any
        mutation, so a raise leaves the store untouched."""
        for w in words:
            if w in self.word_to_id:
                raise ValueError(f"word already present: {w!r}")
        vecs = jnp.asarray(vectors, dtype=jnp.float32)
        if (2 * (self.vectors.nbytes + self.vectors_norm.nbytes)
                > backend.memory_limit_bytes() // _FUSED_EXTEND_SHARE):
            # capacity regime: two sequential programs — rebinding
            # self.vectors first lets the allocator free the old raw
            # table before the norm concat's output allocates.
            self.vectors = _append_rows(self.vectors, vecs)
            self.vectors_norm = _append_rows_norm(self.vectors_norm, vecs)
        else:
            self.vectors, self.vectors_norm = _extend_tables(
                self.vectors, self.vectors_norm, vecs)
        start = len(self.words)
        self.words.extend(words)
        for i, w in enumerate(words, start=start):
            self.word_to_id[w] = i
        return self

    # --------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        """Serialize to .npz (the analog of the reference's pickled index
        exports, index_manager.py:10-18)."""
        # Fixed-width unicode (never dtype=object): loading object arrays
        # needs allow_pickle=True, which executes arbitrary code on
        # untrusted files.
        np.savez_compressed(
            path,
            words=np.asarray(self.words, dtype=str),
            vectors=np.asarray(self.vectors),
        )

    @classmethod
    def load(cls, path: str | Path) -> "VectorStore":
        with np.load(path, allow_pickle=False) as f:
            words = [str(w) for w in f["words"]]
            vectors = f["vectors"]
        return cls.from_arrays(words, vectors)


# ---------------------------------------------------------------- parsing

def _load_text_embeddings(path: Path, max_words: int | None,
                          use_native: bool = True
                          ) -> tuple[list[str], np.ndarray]:
    if use_native:
        try:
            from postgres_word2vec.utils import native_io
            return native_io.load_text_embeddings(path, max_words)
        except Exception:
            pass  # fall back to numpy parser
    return _load_text_embeddings_py(path, max_words)


def _load_text_embeddings_py(path: Path, max_words: int | None
                             ) -> tuple[list[str], np.ndarray]:
    words: list[str] = []
    rows: list[np.ndarray] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        header = f.readline().split()
        dim = int(header[1]) if len(header) == 2 else None
        if dim is None:
            # No header: first line is a data row.
            f.seek(0)
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if dim is None:
                dim = len(parts) - 1
            if len(parts) < dim + 1:
                continue
            words.append(parts[0])
            rows.append(np.asarray(parts[1:dim + 1], dtype=np.float32))
            if max_words is not None and len(words) >= max_words:
                break
    return words, np.stack(rows) if rows else np.zeros((0, dim or 0),
                                                       np.float32)

"""Streaming ("pipeline") index construction with checkpoint/resume.

Parity targets: the reference's incremental build mode —
``VectorFeeder`` (vector_feeder.py:3-17, cursor-based batch iterator),
``PQIndexCreator.index_batch`` / ``IVFADCIndexCreator.index_batch``
(pq_index_creator.py:9-63, ivfadc_index_creator.py:9-81, faiss encode in
batches of 40), and the resilience story: per-batch artifacts plus a rolling
counts file so a partial build can be re-imported
(pq_index.py:237-258, index_manager.py:20-44, load_index.py pipeline types).

Device shape: the quantizers train once up front (on a training sample), then
arbitrarily large vector streams encode batch-by-batch on device with the
already-jitted encode kernels; codes accumulate host-side (they're tiny).
``checkpoint()`` writes a single resumable .npz; ``resume()`` restores the
builder mid-stream. ``finalize()`` assembles the normal index object.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from postgres_word2vec.models.ivfadc import CoarseQuantizer, IVFADCIndex
from postgres_word2vec.models.pq import (PQCodebook, PQIndex, recount,
                                             train_codebook)
from postgres_word2vec.ops import kmeans

Array = jax.Array


class VectorFeeder:
    """Batch iterator over a vector source (vector_feeder.py parity).

    Accepts any ``(n, d)`` array-like; yields ``(vectors, row_offset)``.
    """

    def __init__(self, vectors, batch_size: int = 4096):
        self._vectors = np.asarray(vectors, np.float32)
        self.batch_size = int(batch_size)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < self._vectors.shape[0]

    def next_batch(self) -> tuple[np.ndarray, int]:
        start = self._pos
        end = min(start + self.batch_size, self._vectors.shape[0])
        self._pos = end
        return self._vectors[start:end], start

    def __iter__(self) -> Iterator[tuple[np.ndarray, int]]:
        while self.has_next():
            yield self.next_batch()


class PQIndexCreator:
    """Streaming PQ builder (pq_index_creator.py parity)."""

    def __init__(self, codebook: PQCodebook):
        self.codebook = codebook
        self._codes: list[np.ndarray] = []
        self.rows_done = 0

    @classmethod
    def from_training(cls, key: Array, train_vectors, m: int = 12,
                      k: int = 256, iters: int = 10) -> "PQIndexCreator":
        cb = train_codebook(key, jnp.asarray(np.asarray(train_vectors,
                                                        np.float32)),
                            m, k, train_size=None, iters=iters)
        return cls(cb)

    def index_batch(self, vectors) -> np.ndarray:
        codes = np.asarray(kmeans.encode_subspaces(
            jnp.asarray(np.asarray(vectors, np.float32)),
            self.codebook.centroids))
        self._codes.append(codes)
        self.rows_done += codes.shape[0]
        return codes

    # ---------------------------------------------------- checkpoint/resume
    def checkpoint(self, path: str | Path) -> None:
        np.savez_compressed(
            path, kind="pq",
            centroids=np.asarray(self.codebook.centroids),
            counts=np.asarray(self.codebook.counts),
            codes=(np.concatenate(self._codes)
                   if self._codes else np.zeros((0, 0), np.uint8)))

    @classmethod
    def resume(cls, path: str | Path) -> "PQIndexCreator":
        with np.load(path, allow_pickle=False) as f:
            c = cls(PQCodebook(jnp.asarray(f["centroids"]),
                               jnp.asarray(f["counts"])))
            codes = f["codes"]
            if codes.size:
                c._codes = [codes]
                c.rows_done = codes.shape[0]
        return c

    def finalize(self) -> PQIndex:
        codes = jnp.asarray(np.concatenate(self._codes))
        return PQIndex(recount(self.codebook, codes), codes)


class IVFADCIndexCreator:
    """Streaming IVFADC builder (ivfadc_index_creator.py parity): coarse
    assignment + residual encode per batch, CSR assembly at finalize."""

    def __init__(self, coarse_centroids: Array, codebook: PQCodebook):
        self.coarse_centroids = jnp.asarray(coarse_centroids)
        self.codebook = codebook
        self._codes: list[np.ndarray] = []
        self._assign: list[np.ndarray] = []
        self.rows_done = 0

    @classmethod
    def from_training(cls, key: Array, train_vectors, m: int = 12,
                      k: int = 256, k_coarse: int = 1000,
                      iters: int = 10) -> "IVFADCIndexCreator":
        tv = jnp.asarray(np.asarray(train_vectors, np.float32))
        ck, rk = jax.random.split(key)
        coarse = kmeans.kmeans(ck, tv, k=k_coarse, iters=iters)
        assign = kmeans.assign(tv, coarse.centroids)
        resid = tv - jnp.take(coarse.centroids, assign, axis=0)
        sub = kmeans.split_subspaces(resid, m)
        cb = kmeans.kmeans_subspaces(rk, sub, k=k, iters=iters)
        return cls(coarse.centroids, PQCodebook(cb.centroids, cb.counts))

    def index_batch(self, vectors) -> tuple[np.ndarray, np.ndarray]:
        v = jnp.asarray(np.asarray(vectors, np.float32))
        assign = kmeans.assign(v, self.coarse_centroids)
        resid = v - jnp.take(self.coarse_centroids, assign, axis=0)
        codes = np.asarray(kmeans.encode_subspaces(resid,
                                                   self.codebook.centroids))
        self._codes.append(codes)
        self._assign.append(np.asarray(assign, np.int32))
        self.rows_done += codes.shape[0]
        return codes, np.asarray(assign)

    def checkpoint(self, path: str | Path) -> None:
        np.savez_compressed(
            path, kind="ivfadc",
            coarse=np.asarray(self.coarse_centroids),
            centroids=np.asarray(self.codebook.centroids),
            counts=np.asarray(self.codebook.counts),
            codes=(np.concatenate(self._codes)
                   if self._codes else np.zeros((0, 0), np.uint8)),
            assign=(np.concatenate(self._assign)
                    if self._assign else np.zeros((0,), np.int32)))

    @classmethod
    def resume(cls, path: str | Path) -> "IVFADCIndexCreator":
        with np.load(path, allow_pickle=False) as f:
            c = cls(jnp.asarray(f["coarse"]),
                    PQCodebook(jnp.asarray(f["centroids"]),
                               jnp.asarray(f["counts"])))
            if f["codes"].size:
                c._codes = [f["codes"]]
                c._assign = [f["assign"]]
                c.rows_done = f["codes"].shape[0]
        return c

    def finalize(self) -> IVFADCIndex:
        codes = np.concatenate(self._codes)
        assign = jnp.asarray(np.concatenate(self._assign))
        k_coarse = self.coarse_centroids.shape[0]
        counts = jnp.bincount(assign, length=k_coarse).astype(jnp.int32)
        return IVFADCIndex._assemble(
            CoarseQuantizer(self.coarse_centroids, counts), self.codebook,
            jnp.asarray(codes), assign)

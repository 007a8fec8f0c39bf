"""Product-quantization index: training, encoding, ADC search, online update.

Parity targets:
- build driver pq_index.py (codebook k-means + faiss encode + counts →
  ``pq_codebook`` / ``pq_quantization`` tables),
- search kernels ``pq_search`` (freddy.c:26-170), ``pq_search_in``
  (freddy.c:1026-1174), ``pq_search_in_batch`` (freddy.c:412-675),
- post-verified wrappers ``k_nearest_neighbour_pq_pv`` (sql:625-662),
- online codebook maintenance ``updateCodebook`` (index_utils.c:908-957,
  reimplemented without the reference's ``pos + code`` indexing bug —
  SURVEY §"quirks not to replicate").

Defaults follow the shipped configs (m=12, k=256 → uint8 codes,
pq_config.json) rather than the README's 1024-centroid claim; both noted in
BASELINE.md.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from postgres_word2vec.ops import adc, backend, kmeans, lut

Array = jax.Array


class PQCodebook(NamedTuple):
    """``(m, k, dsub)`` centroids + ``(m, k)`` assignment counts.

    The counts back the running-mean online update (parity:
    ``getCodebookWithCounts``, index_utils.c:684-736; counts computed at
    build by ``determine_counts``, pq_index.py:141-151).
    """
    centroids: Array  # (m, k, dsub) float32
    counts: Array     # (m, k) int32


def train_codebook(key: Array, vectors: Array, m: int, k: int, *,
                   train_size: int | None = None, iters: int = 10,
                   restarts: int = 1, init: str = "sample") -> PQCodebook:
    """Train an m×k product codebook on a (sampled) training set.

    ``restarts``/``init`` select quantizer quality: the reference's scipy
    ``kmeans(iter=10)`` is 10 restarts of converged Lloyd
    (quantizer_creation.py:25); ``init="kmeans++"`` with one restart
    reaches comparable distortion at a fraction of the cost.
    """
    n = vectors.shape[0]
    if train_size is not None and train_size < n:
        sel_key, key = jax.random.split(key)
        idx = jax.random.choice(sel_key, n, shape=(train_size,),
                                replace=False)
        train = jnp.take(vectors, idx, axis=0)
    else:
        train = vectors
    sub = kmeans.split_subspaces(train, m)
    res = kmeans.kmeans_subspaces(key, sub, k=k, iters=iters,
                                  restarts=restarts, init=init)
    return PQCodebook(res.centroids, res.counts)


def recount(codebook: PQCodebook, codes: Array) -> PQCodebook:
    """Recompute counts from a full code table (determine_counts parity)."""
    m, k, _ = codebook.centroids.shape
    one = jnp.ones((codes.shape[0],), jnp.int32)
    counts = jax.vmap(
        lambda cj: jax.ops.segment_sum(one, cj.astype(jnp.int32),
                                       num_segments=k))(codes.T)
    return PQCodebook(codebook.centroids, counts)


@jax.jit
def online_codebook_update(codebook: PQCodebook,
                           new_vectors: Array) -> tuple[PQCodebook, Array]:
    """Sequential running-mean update for a batch of inserted vectors.

    For each vector, per subspace: assign nearest centroid, ``count += 1``,
    ``c += (x − c)/count`` — the reference's incremental k-means semantics
    (index_utils.c:908-957), scanned over the batch so later vectors see
    earlier updates, exactly like the reference's per-row loop.

    Returns the updated codebook and the ``(n_new, m)`` assigned codes.
    """
    m, k, dsub = codebook.centroids.shape
    x_sub = new_vectors.astype(jnp.float32).reshape(-1, m, dsub)

    def step(carry, x):
        cents, counts = carry          # (m,k,dsub), (m,k)
        d = jnp.sum((x[:, None, :] - cents) ** 2, axis=-1)   # (m, k)
        code = jnp.argmin(d, axis=-1)                        # (m,)
        sel = jax.nn.one_hot(code, k, dtype=jnp.float32)     # (m, k)
        new_counts = counts + sel.astype(jnp.int32)
        inv = sel / jnp.maximum(new_counts.astype(jnp.float32), 1.0)
        cents = cents + inv[:, :, None] * (x[:, None, :] - cents)
        return (cents, new_counts), code.astype(jnp.int32)

    (cents, counts), codes = lax.scan(
        step, (codebook.centroids.astype(jnp.float32),
               codebook.counts.astype(jnp.int32)), x_sub)
    return PQCodebook(cents, counts), codes


def train_opq_rotation(key: Array, train: Array, m: int, k: int, *,
                       opq_iters: int = 8, kmeans_iters: int = 5
                       ) -> tuple[Array, PQCodebook]:
    """OPQ (non-parametric): alternate subspace k-means with the orthogonal
    Procrustes solve ``R = UVᵀ, USVᵀ = SVD(XᵀX̂)`` minimizing
    ``‖X·R − reconstruction‖²``. Rotations preserve L2, so search semantics
    are unchanged — only quantization error drops.

    (An optimization the reference does not have; its scipy pipeline quantizes
    in the raw basis, quantizer_creation.py:13-29. This is this framework's
    quantizer-quality edge: one extra 300×300 matmul per query.)

    Returns ``(rotation (d, d), codebook trained in the rotated basis)``.
    """
    n, d = train.shape
    x = train.astype(jnp.float32)
    rot = jnp.eye(d, dtype=jnp.float32)
    cb = None
    for it in range(opq_iters):
        y = jnp.dot(x, rot, preferred_element_type=jnp.float32)
        sub = kmeans.split_subspaces(y, m)
        if cb is None:
            res = kmeans.kmeans_subspaces(key, sub, k=k, iters=kmeans_iters,
                                          init="kmeans++")
        else:
            # warm-start Lloyd from the previous rotation's codebook.
            res = jax.vmap(
                lambda xs, c0: _warm_lloyd(xs, c0, kmeans_iters))(sub, cb)
        cb = res.centroids
        codes = kmeans.encode_subspaces(y, cb)
        recon = reconstruct(codes, cb)
        u, _, vt = jnp.linalg.svd(
            jnp.dot(x.T, recon, preferred_element_type=jnp.float32),
            full_matrices=False)
        rot = jnp.dot(u, vt, preferred_element_type=jnp.float32)
    y = jnp.dot(x, rot, preferred_element_type=jnp.float32)
    codes = kmeans.encode_subspaces(y, cb)
    counts = jax.vmap(lambda cj: jnp.bincount(
        cj.astype(jnp.int32), length=k))(codes.T)
    return rot, PQCodebook(cb, counts.astype(jnp.int32))


def _warm_lloyd(x: Array, c0: Array, iters: int) -> "kmeans.KMeansResult":
    def body(c, _):
        new_c, counts, dist = kmeans._lloyd_step_repair(x, c)
        return new_c, (counts, dist)
    c, (counts, dist) = lax.scan(body, c0.astype(jnp.float32), None,
                                 length=iters)
    return kmeans.KMeansResult(c, counts[-1], dist[-1])


def reconstruct(codes: Array, codebooks: Array) -> Array:
    """Decode PQ codes back to vectors: ``(n, m) × (m, k, dsub) → (n, d)``."""
    m, k, dsub = codebooks.shape
    parts = jax.vmap(lambda cb_j, cj: jnp.take(cb_j, cj, axis=0),
                     in_axes=(0, 1))(codebooks, codes.astype(jnp.int32))
    return jnp.moveaxis(parts, 0, 1).reshape(codes.shape[0], m * dsub)


@functools.partial(jax.jit, static_argnames=("k", "mode", "rotate",
                                             "approx"))
def _pq_search_program(queries: Array, rotation: Array, centroids: Array,
                       codes: Array, *, k: int, mode: str, rotate: bool,
                       approx: bool) -> tuple[Array, Array]:
    """The WHOLE exhaustive PQ search as one compiled program: optional OPQ
    rotation → LUT build → scan → top-k, one dispatch per call.

    ``mode`` (see :meth:`PQIndex._search_plan`): "binned" — the Triton
    scan with the fused per-bin reduction (approximate); "dense" — the
    Triton scan in memory-sized chunks with an exact running top-k;
    "xla" — the XLA gather reference."""
    from postgres_word2vec.ops import pallas_kernels as pk

    q = (jnp.dot(queries.astype(jnp.float32), rotation,
                 preferred_element_type=jnp.float32) if rotate else queries)
    luts = lut.build_luts(q, centroids)
    if mode == "binned":
        return pk.adc_top_k_binned(luts, codes, k)
    return adc.adc_top_k(luts, codes, k, approx=approx,
                         use_kernel=mode == "dense")


@functools.partial(jax.jit, static_argnames=("k", "pvf", "mode", "rotate",
                                             "approx"))
def _pq_search_pv_program(queries: Array, rotation: Array, centroids: Array,
                          codes: Array, vectors: Array, *, k: int, pvf: int,
                          mode: str, rotate: bool,
                          approx: bool) -> tuple[Array, Array]:
    """Fused ADC shortlist (k·pvf) + exact re-rank in one compiled program
    (one dispatch for the whole PV path). ``approx`` selects the binned
    shortlist (see :meth:`PQIndex.search_pv`)."""
    cd, ci = _pq_search_program(queries, rotation, centroids, codes,
                                k=k * pvf, mode=mode, rotate=rotate,
                                approx=approx)
    return adc.post_verify(queries, ci, cd, vectors, k)


#: Shortlists at least this wide take the binned scan under ``"auto"``;
#: narrower ones (the analogy path's pvf+3) stay exact.
_APPROX_SHORTLIST_MIN = 100


def _resolve_shortlist(shortlist: str, k: int, pvf: int,
                       impl: str | None = None) -> str:
    """Resolve the PV shortlist policy: "auto" → "approx" when the Triton
    scan runs and the shortlist is wide (k·pvf ≥ 100), "exact" otherwise.
    ``impl="xla"`` (the exact reference backend) keeps the exact
    shortlist."""
    if shortlist not in ("auto", "exact", "approx"):
        raise ValueError(f"shortlist must be auto|exact|approx, "
                         f"got {shortlist!r}")
    if shortlist != "auto":
        return shortlist
    if backend.kernels_for(impl) and k * pvf >= _APPROX_SHORTLIST_MIN:
        return "approx"
    return "exact"


@dataclasses.dataclass
class PQIndex:
    """Exhaustive-scan PQ index: packed codes + codebook, device-resident.

    On the GPU the exhaustive scan runs through the Triton ADC kernels
    (ops/pallas_kernels.py) straight over the ``(n, m)`` code table; the
    XLA gather path is the CPU/reference backend.

    ``rotation``: optional OPQ orthogonal basis (codes live in the rotated
    space; queries are rotated before LUT construction — L2 distances are
    invariant, recall improves).
    """

    codebook: PQCodebook
    codes: Array          # (n, m) uint8 (k ≤ 256) or int16
    rotation: Array | None = None   # (d, d) OPQ rotation or None

    @property
    def size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def m(self) -> int:
        return int(self.codebook.centroids.shape[0])

    @property
    def k(self) -> int:
        return int(self.codebook.centroids.shape[1])

    # ------------------------------------------------------------ building
    @classmethod
    def build(cls, key: Array, vectors: Array, *, m: int = 12, k: int = 256,
              train_size: int | None = 100_000, iters: int = 10,
              restarts: int = 1, init: str = "sample",
              opq_iters: int = 0, aniso_eta: float | None = None,
              aniso_iters: int = 4) -> "PQIndex":
        """Train + encode (pq_index.py ``main`` parity; defaults from
        pq_config.json: m=12, k=256, train_size=100k).

        ``opq_iters > 0`` enables OPQ: a learned orthogonal rotation that
        decorrelates subspaces before quantization (off by default for
        reference parity).

        ``aniso_eta`` (e.g. 2–4) enables anisotropic (score-aware)
        refinement: trained codebooks get ``aniso_iters`` rounds of
        weighted Lloyd that penalize the ranking-relevant PARALLEL
        residual η× (ops/kmeans.anisotropic_refine), and the table is
        encoded under the same metric. Stacks with OPQ. Training-time
        only — LUTs/search are unchanged; later ``add()`` rows encode
        plain-L2 (documented drift, same as the reference's incremental
        codebooks)."""
        if opq_iters > 0:
            n = vectors.shape[0]
            if train_size is not None and train_size < n:
                sk, key = jax.random.split(key)
                sel = jax.random.choice(sk, n, shape=(train_size,),
                                        replace=False)
                train = jnp.take(vectors, sel, axis=0)
            else:
                train = vectors
            rot, cb = train_opq_rotation(key, train, m, k,
                                         opq_iters=opq_iters,
                                         kmeans_iters=max(iters // 4, 3))
            cents = cb.centroids
            if aniso_eta is not None:
                # cap the refinement sample: the (n, dsub²) outer-product
                # table inside anisotropic_refine must never scale with the
                # full table (HBM rule, CLAUDE.md) — 100k rows bound it at
                # ~250 MB transient even with train_size=None.
                ref_tr = train
                if ref_tr.shape[0] > 100_000:
                    rsel = jax.random.choice(jax.random.fold_in(key, 11),
                                             ref_tr.shape[0],
                                             shape=(100_000,),
                                             replace=False)
                    ref_tr = jnp.take(ref_tr, rsel, axis=0)
                y = jnp.dot(ref_tr.astype(jnp.float32), rot,
                            preferred_element_type=jnp.float32)
                cents = kmeans.anisotropic_refine(
                    kmeans.split_subspaces(y, m), cents, aniso_eta,
                    aniso_iters)
                cb = PQCodebook(cents, cb.counts)
            codes = kmeans.encode_subspaces(vectors, cents, rotation=rot,
                                            aniso_eta=aniso_eta)
            return cls(recount(cb, codes), codes, rotation=rot)
        cb = train_codebook(key, vectors, m, k, train_size=train_size,
                            iters=iters, restarts=restarts, init=init)
        if aniso_eta is not None:
            n = vectors.shape[0]
            # same HBM cap as the OPQ branch: bound the refinement sample.
            cap = min(train_size or 100_000, 100_000)
            if cap < n:
                sel = jax.random.choice(jax.random.fold_in(key, 7), n,
                                        shape=(cap,), replace=False)
                train = jnp.take(vectors, sel, axis=0)
            else:
                train = vectors
            cents = kmeans.anisotropic_refine(
                kmeans.split_subspaces(train, m), cb.centroids, aniso_eta,
                aniso_iters)
            cb = PQCodebook(cents, cb.counts)
        codes = kmeans.encode_subspaces(vectors, cb.centroids,
                                        aniso_eta=aniso_eta)
        return cls(recount(cb, codes), codes)

    def _rotate(self, x: Array) -> Array:
        if self.rotation is None:
            return x
        return jnp.dot(x.astype(jnp.float32), self.rotation,
                       preferred_element_type=jnp.float32)

    def encode(self, vectors: Array) -> Array:
        # rotation fused into the chunked encode — never materializes a
        # full rotated copy of the table (3.6 GB at 3M×300).
        return kmeans.encode_subspaces(vectors, self.codebook.centroids,
                                       rotation=self.rotation)

    # ------------------------------------------------------------- search
    def _search_plan(self, approx: bool, impl: str | None) -> str:
        """Scan mode for the fused search program: on the GPU "binned" for
        approximate requests and "dense" (chunked, exact top-k) otherwise;
        "xla" elsewhere or when ``impl="xla"`` asks for the reference."""
        if not backend.kernels_for(impl):
            return "xla"
        return "binned" if approx else "dense"

    def _rot_args(self) -> tuple[Array, bool]:
        if self.rotation is None:
            # static `rotate=False` drops the dummy from the traced graph.
            return jnp.zeros((1, 1), jnp.float32), False
        return self.rotation, True

    def search(self, queries: Array, k: int, *, approx: bool = False,
               impl: str | None = None) -> tuple[Array, Array]:
        """Exhaustive ADC top-k (``pq_search`` parity) → (sqdists, ids).

        ``impl``: None selects the backend's path (:meth:`_search_plan`),
        "xla" the gather reference. ``approx=True`` takes the binned
        Triton scan on the GPU. The whole pipeline (rotation, LUTs, scan,
        top-k) runs as ONE compiled program (:func:`_pq_search_program`).
        """
        mode = self._search_plan(approx, impl)
        rot, rotate = self._rot_args()
        return _pq_search_program(queries, rot, self.codebook.centroids,
                                  self.codes, k=k, mode=mode, rotate=rotate,
                                  approx=approx)

    def search_pv(self, queries: Array, k: int, pvf: int,
                  vectors: Array, *, impl: str | None = None,
                  shortlist: str = "auto") -> tuple[Array, Array]:
        """ADC shortlist of k·pvf then exact re-rank, fused into one
        program (``k_nearest_neighbour_pq_pv`` parity, sql:625-662).

        ``shortlist``: how the k·pvf ADC shortlist is selected before the
        exact re-rank —

        - ``"exact"``: exact top-k over the whole scan.
        - ``"approx"``: the binned scan's survivors (one per strided bin
          of rows) and an exact top-k over them. The final re-rank is
          still exact L2 over raw vectors, so the only effect is a small
          chance per true neighbour of missing the shortlist. The CPU
          reference answers exactly.
        - ``"auto"`` (default): see :func:`_resolve_shortlist`.
        """
        approx_sl = _resolve_shortlist(shortlist, k, pvf, impl) == "approx"
        mode = self._search_plan(approx_sl, impl)
        rot, rotate = self._rot_args()
        return _pq_search_pv_program(queries, rot, self.codebook.centroids,
                                     self.codes, vectors, k=k, pvf=pvf,
                                     mode=mode, rotate=rotate,
                                     approx=approx_sl)

    def search_in(self, queries: Array, k: int, target_ids: Array,
                  target_mask: Array | None = None) -> tuple[Array, Array]:
        """Target-restricted ADC (``pq_search_in``/``pq_search_in_batch``
        parity — the kNN-join baseline)."""
        if target_mask is None:
            target_mask = jnp.ones(target_ids.shape, dtype=bool)
        luts = lut.build_luts(self._rotate(queries), self.codebook.centroids)
        return adc.adc_top_k_in(luts, self.codes, target_ids, target_mask, k)

    # ------------------------------------------------------------ mutation
    def add(self, new_vectors: Array) -> "PQIndex":
        """Online insert: running-mean codebook update + append codes
        (``insert_batch``'s PQ leg, freddy.c:1616-1629)."""
        cb, new_codes = online_codebook_update(self.codebook,
                                               self._rotate(new_vectors))
        codes = jnp.concatenate(
            [self.codes, new_codes.astype(self.codes.dtype)], axis=0)
        return PQIndex(cb, codes, rotation=self.rotation)

    # --------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        extra = {}
        if self.rotation is not None:
            extra["rotation"] = np.asarray(self.rotation)
        np.savez_compressed(path, centroids=np.asarray(self.codebook.centroids),
                            counts=np.asarray(self.codebook.counts),
                            codes=np.asarray(self.codes), **extra)

    @classmethod
    def load(cls, path: str | Path) -> "PQIndex":
        with np.load(path) as f:
            rot = jnp.asarray(f["rotation"]) if "rotation" in f else None
            return cls(PQCodebook(jnp.asarray(f["centroids"]),
                                  jnp.asarray(f["counts"])),
                       jnp.asarray(f["codes"]), rotation=rot)

"""k-means on the device — codebook training for all three index families.

The reference trains codebooks off-device with scipy/faiss
(``create_quantizer`` — scipy kmeans per subspace, quantizer_creation.py:13-29;
``create_coarse_quantizer`` quantizer_creation.py:31-33; residual variant
35-52) and encodes vectors with faiss 1-NN in micro-batches of 18
(pq_index.py:31-63). Here training and encoding are batched Lloyd iterations
built from matmuls:

- assignment is one matmul + argmin per chunk (``x·cᵀ`` dominates; the
  ``||x||²`` term is assignment-invariant and dropped),
- the update step is a ``segment_sum`` (a scatter-add XLA handles natively),
- the per-subspace product-quantizer trains all ``m`` subspaces at once via
  ``vmap`` — one (m·n·dsub × k) batched matmul per iteration instead of m
  sequential scipy runs.

Deterministic under a fixed PRNG key. All shapes static; the n axis is
chunked with ``lax.scan`` (or map) so 3M-row encodes never materialize an
(n, k) score matrix.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from postgres_word2vec.utils.shapes import snap_chunk

Array = jax.Array


class KMeansResult(NamedTuple):
    centroids: Array  # (k, d) float32
    counts: Array     # (k,) int32 — cluster sizes at the final assignment
    # plain-float default: a jnp scalar here would initialize the JAX
    # backend at import time (package import must stay backend-free).
    distortion: Array | float = 0.0  # mean point↔centroid distance


def pairwise_sqdist(x: Array, c: Array) -> Array:
    """Squared L2 distances ``(n, d) × (k, d) → (n, k)`` in float32.

    One matmul plus rank-1 corrections; clamped at 0 against cancellation.
    """
    x = x.astype(jnp.float32)
    c = c.astype(jnp.float32)
    xx = jnp.sum(x * x, axis=-1, keepdims=True)          # (n, 1)
    cc = jnp.sum(c * c, axis=-1)                          # (k,)
    xc = jnp.dot(x, c.T, preferred_element_type=jnp.float32,
                 precision=lax.Precision.HIGHEST)
    return jnp.maximum(xx - 2.0 * xc + cc[None, :], 0.0)


def assign(x: Array, centroids: Array, *, chunk_size: int = 65536) -> Array:
    """Nearest-centroid assignment ``(n, d) → (n,) int32``, chunked over n.

    The ``||x||²`` term doesn't affect the argmin, so the chunk body is a
    single matmul + bias + argmin.
    """
    n = x.shape[0]
    c = centroids.astype(jnp.float32)
    cc = jnp.sum(c * c, axis=-1)

    def chunk_fn(xc_chunk: Array) -> Array:
        scores = jnp.dot(xc_chunk.astype(jnp.float32), c.T,
                         preferred_element_type=jnp.float32,
                         precision=lax.Precision.HIGHEST)
        return jnp.argmin(cc[None, :] - 2.0 * scores, axis=-1).astype(jnp.int32)

    if n <= chunk_size:
        return chunk_fn(x)
    chunk_size = snap_chunk(n, chunk_size)
    pad = (-n) % chunk_size
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
    xp = xp.reshape(-1, chunk_size, x.shape[1])
    out = lax.map(chunk_fn, xp)
    return out.reshape(-1)[:n]


def assign_with_dist(x: Array, centroids: Array, *,
                     chunk_size: int = 65536) -> tuple[Array, Array]:
    """Nearest-centroid assignment + true squared distance, chunked over n."""
    n = x.shape[0]
    c = centroids.astype(jnp.float32)
    cc = jnp.sum(c * c, axis=-1)

    def chunk_fn(xc_chunk: Array) -> tuple[Array, Array]:
        xf = xc_chunk.astype(jnp.float32)
        xx = jnp.sum(xf * xf, axis=-1, keepdims=True)
        scores = jnp.dot(xf, c.T, preferred_element_type=jnp.float32,
                         precision=lax.Precision.HIGHEST)
        d = jnp.maximum(xx - 2.0 * scores + cc[None, :], 0.0)
        a = jnp.argmin(d, axis=-1).astype(jnp.int32)
        return a, jnp.min(d, axis=-1)

    if n <= chunk_size:
        return chunk_fn(x)
    chunk_size = snap_chunk(n, chunk_size)
    pad = (-n) % chunk_size
    xp = (jnp.pad(x, ((0, pad), (0, 0))) if pad else x
          ).reshape(-1, chunk_size, x.shape[1])
    a, d = lax.map(chunk_fn, xp)
    return a.reshape(-1)[:n], d.reshape(-1)[:n]


def _lloyd_step(x: Array, centroids: Array) -> tuple[Array, Array]:
    k = centroids.shape[0]
    a = assign(x, centroids)
    sums = jax.ops.segment_sum(x.astype(jnp.float32), a, num_segments=k)
    counts = jax.ops.segment_sum(jnp.ones((x.shape[0],), jnp.float32), a,
                                 num_segments=k)
    # Empty clusters keep their previous centroid (deterministic; matches the
    # effective behavior of repeated Lloyd passes over a fixed sample).
    new_c = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None],
                                                              1.0), centroids)
    return new_c, counts.astype(jnp.int32)


def _lloyd_step_repair(x: Array, centroids: Array
                       ) -> tuple[Array, Array, Array]:
    """Lloyd step that reseeds EMPTY clusters onto the worst-fit points
    (largest distance to their assigned centroid) — the standard repair;
    without it a dead centroid stays dead forever and the codebook wastes
    codes (the reference's converged scipy runs rarely leave empties at its
    sample sizes, but our one-shot Lloyd at k=256/1024 does).

    Returns (new centroids, counts, mean distance distortion).
    """
    k = centroids.shape[0]
    a, dmin = assign_with_dist(x, centroids)
    sums = jax.ops.segment_sum(x.astype(jnp.float32), a, num_segments=k)
    counts = jax.ops.segment_sum(jnp.ones((x.shape[0],), jnp.float32), a,
                                 num_segments=k)
    new_c = jnp.where(counts[:, None] > 0,
                      sums / jnp.maximum(counts[:, None], 1.0), centroids)
    empty = counts <= 0
    # rank each empty cluster; empty #r takes the r-th worst-fit point.
    from postgres_word2vec.ops import topk as topk_ops
    _, worst_idx = topk_ops.top_k_largest(dmin, min(k, dmin.shape[0]))
    rank = jnp.cumsum(empty.astype(jnp.int32)) - 1
    rank = jnp.clip(rank, 0, worst_idx.shape[0] - 1)
    reseed = jnp.take(x, jnp.take(worst_idx, rank), axis=0).astype(
        jnp.float32)
    new_c = jnp.where(empty[:, None], reseed, new_c)
    # distortion matches scipy's: mean (non-squared) distance.
    distortion = jnp.mean(jnp.sqrt(dmin))
    return new_c, counts.astype(jnp.int32), distortion


@functools.partial(jax.jit, static_argnames=("k", "iters", "init"))
def _kmeans_single(key: Array, x: Array, k: int, iters: int,
                   init: str) -> KMeansResult:
    n = x.shape[0]
    if init == "kmeans++":
        init_c = kmeans_plus_plus_init(key, x, k)
    else:
        init_idx = jax.random.choice(key, n, shape=(k,), replace=False)
        init_c = x[init_idx].astype(jnp.float32)

    def body(c, _):
        new_c, counts, distortion = _lloyd_step_repair(x, c)
        return new_c, (counts, distortion)

    centroids, (counts_hist, dist_hist) = lax.scan(body, init_c, None,
                                                   length=iters)
    return KMeansResult(centroids, counts_hist[-1], dist_hist[-1])


def kmeans(key: Array, x: Array, k: int, iters: int = 10, *,
           restarts: int = 1, init: str = "sample") -> KMeansResult:
    """Lloyd's k-means: ``(n, d) → (k, d)`` with final-assignment counts.

    Parity: ``scipy.cluster.vq.kmeans(…, iter=10)`` as used by
    quantizer_creation.py:25 — note scipy's ``iter`` is the number of
    RESTARTS (best distortion wins), each run converging internally; pass
    ``restarts=10, iters≈30`` here for the reference-equivalent quantizer.
    ``init="kmeans++"`` enables D²-sampling initialization; empty clusters
    always reseed onto worst-fit points.
    """
    if restarts <= 1:
        return _kmeans_single(key, x, k, iters, init)
    best: KMeansResult | None = None
    for r, kk in enumerate(jax.random.split(key, restarts)):
        res = _kmeans_single(kk, x, k, iters, init)
        if best is None or float(res.distortion) < float(best.distortion):
            best = res
    return best


@functools.partial(jax.jit, static_argnames=("k",))
def kmeans_plus_plus_init(key: Array, x: Array, k: int) -> Array:
    """k-means++ (D² sampling) initialization: ``(n, d) → (k, d)``.

    A lax.scan over k draws; each step is one (n, d) distance update — total
    O(k·n·d), about one extra Lloyd iteration's cost.
    """
    n, d = x.shape
    xf = x.astype(jnp.float32)
    xx = jnp.sum(xf * xf, axis=-1)
    k0, krest = jax.random.split(key)
    first = jnp.take(xf, jax.random.randint(k0, (), 0, n), axis=0)

    def dist_to(c):
        s = jnp.dot(xf, c, preferred_element_type=jnp.float32,
                    precision=lax.Precision.HIGHEST)
        return jnp.maximum(xx - 2.0 * s + jnp.sum(c * c), 0.0)

    def body(carry, kk):
        dmin = carry
        # Gumbel-top-1 over log weights == sampling ∝ dmin.
        logw = jnp.log(jnp.maximum(dmin, 1e-30))
        g = jax.random.gumbel(kk, (n,), jnp.float32)
        idx = jnp.argmax(logw + g)
        c = jnp.take(xf, idx, axis=0)
        return jnp.minimum(dmin, dist_to(c)), c

    _, rest = lax.scan(body, dist_to(first), jax.random.split(krest, k - 1))
    return jnp.concatenate([first[None], rest], axis=0)


def kmeans_subspaces(key: Array, x_sub: Array, k: int, iters: int = 10, *,
                     restarts: int = 1, init: str = "sample") -> KMeansResult:
    """Product-quantizer training: ``(m, n, dsub) → (m, k, dsub)``.

    All m subspace k-means runs execute as one vmapped batch — parity with
    ``create_quantizer``'s per-subspace loop (quantizer_creation.py:13-29).
    With ``restarts > 1`` each subspace independently keeps its own best
    restart (scipy ``kmeans(iter=R)`` semantics).
    """
    m = x_sub.shape[0]
    if restarts <= 1:
        keys = jax.random.split(key, m)
        return jax.vmap(
            lambda kk, xs: _kmeans_single(kk, xs, k, iters, init))(keys,
                                                                   x_sub)
    best: KMeansResult | None = None
    for r, kk in enumerate(jax.random.split(key, restarts)):
        keys = jax.random.split(kk, m)
        res = jax.vmap(
            lambda kk_, xs: _kmeans_single(kk_, xs, k, iters, init))(keys,
                                                                     x_sub)
        if best is None:
            best = res
        else:
            take_new = res.distortion < best.distortion       # (m,)
            best = KMeansResult(
                jnp.where(take_new[:, None, None], res.centroids,
                          best.centroids),
                jnp.where(take_new[:, None], res.counts, best.counts),
                jnp.minimum(res.distortion, best.distortion))
    return best


def split_subspaces(x: Array, m: int) -> Array:
    """``(n, d) → (m, n, d/m)`` — subspace view used by PQ training/encoding."""
    n, d = x.shape
    if d % m != 0:
        raise ValueError(f"dimension {d} not divisible by m={m}")
    return jnp.moveaxis(x.reshape(n, m, d // m), 1, 0)


def encode_residual_subspaces(x: Array, coarse_centroids: Array,
                              assignments: Array, codebooks: Array, *,
                              chunk_size: int = 65536) -> Array:
    """Fused residual PQ encode: ``codes[i] = encode(x[i] − coarse[a[i]])``
    without ever materializing the full residual table (3.6 GB at 3M×300 —
    the IVFADC build OOM). One chunked pass: gather coarse centroid,
    subtract, batched subspace matmul + argmin.
    """
    m, k, dsub = codebooks.shape
    n, d = x.shape
    cb = codebooks.astype(jnp.float32)
    cc = jnp.sum(cb * cb, axis=-1)
    coarse = coarse_centroids.astype(jnp.float32)
    dtype = jnp.uint8 if k <= 256 else jnp.int16

    def chunk_fn(args):
        # per-subspace dots over the chunk's residuals; see
        # tests/test_kmeans.py chunk-boundary cases.
        xc, ac = args
        resid = xc.astype(jnp.float32) - jnp.take(coarse, ac, axis=0)
        outs = []
        for j in range(m):
            s = jnp.dot(resid[:, j * dsub:(j + 1) * dsub], cb[j].T,
                        preferred_element_type=jnp.float32,
                        precision=lax.Precision.HIGHEST)
            outs.append(jnp.argmin(cc[j][None] - 2.0 * s,
                                   axis=-1).astype(dtype))
        return jnp.stack(outs, axis=-1)

    if n <= chunk_size:
        return chunk_fn((x, assignments))
    # fori + dynamic_slice on the ORIGINAL buffer: lax.map over a
    # reshaped view can materialize a second full copy of the table.
    chunk_size = snap_chunk(n, chunk_size)
    pad = (-n) % chunk_size
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
    ap = jnp.pad(assignments, (0, pad)) if pad else assignments
    out = jnp.zeros((n + pad, m), dtype)

    def body(i, acc):
        start = i * chunk_size
        xc = lax.dynamic_slice(xp, (start, 0), (chunk_size, d))
        ac = lax.dynamic_slice(ap, (start,), (chunk_size,))
        return lax.dynamic_update_slice(acc, chunk_fn((xc, ac)), (start, 0))

    out = lax.fori_loop(0, (n + pad) // chunk_size, body, out)
    return out[:n]


def encode_subspaces(x: Array, codebooks: Array, *,
                     chunk_size: int = 65536,
                     rotation: Array | None = None,
                     aniso_eta: float | None = None) -> Array:
    """PQ-encode: ``(n, d) × (m, k, dsub) → (n, m)`` small-int codes.

    Replaces the faiss per-subspace 1-NN encode loop (pq_index.py:31-63).
    Chunked over rows *before* the subspace split, so no transposed copy of
    the full table is ever materialized (at 3M×300 that copy alone is
    3.6 GB and OOMs the chip alongside the resident tables). Each chunk is
    one batched-over-subspaces matmul + argmin.

    ``rotation``: optional (d, d) OPQ basis applied per chunk (fused here
    for the same no-full-copy reason).

    ``aniso_eta``: assign by the ANISOTROPIC metric
    ``‖x−c‖² + (η−1)((x−c)·x̂)²`` instead of plain L2 — pairs with
    codebooks trained by :func:`anisotropic_refine` (the (x−c)·x̂ term
    needs no extra matmul: x̂·c = (x·c)/‖x‖).

    Code dtype is uint8 when k ≤ 256 (the shipped-config regime), else int16
    — parity note: the reference stores int2 codes either way
    (pq_index.py:106; SURVEY §2.3).
    """
    m, k, dsub = codebooks.shape
    n, d = x.shape
    if d != m * dsub:
        raise ValueError(f"dim {d} != m·dsub = {m}·{dsub}")
    cb = codebooks.astype(jnp.float32)
    cc = jnp.sum(cb * cb, axis=-1)                        # (m, k)
    dtype = jnp.uint8 if k <= 256 else jnp.int16

    def chunk_fn(xc: Array) -> Array:
        # per-subspace dots (see encode_residual_subspaces for why not a
        # batched einsum inside lax.map).
        xf = xc.astype(jnp.float32)
        if rotation is not None:
            xf = jnp.dot(xf, rotation.astype(jnp.float32),
                         preferred_element_type=jnp.float32)
        outs = []
        for j in range(m):
            xj = xf[:, j * dsub:(j + 1) * dsub]
            s = jnp.dot(xj, cb[j].T,
                        preferred_element_type=jnp.float32,
                        precision=lax.Precision.HIGHEST)
            d = cc[j][None] - 2.0 * s
            if aniso_eta is not None and aniso_eta != 1.0:
                nx = jnp.sqrt(jnp.maximum(jnp.sum(xj * xj, axis=-1),
                                          1e-24))[:, None]
                d = d + (aniso_eta - 1.0) * (nx - s / nx) ** 2
            outs.append(jnp.argmin(d, axis=-1).astype(dtype))
        return jnp.stack(outs, axis=-1)

    if n <= chunk_size:
        return chunk_fn(x)
    # fori + dynamic_slice (see encode_residual_subspaces: a reshaped
    # lax.map view can double the table in HBM).
    chunk_size = snap_chunk(n, chunk_size)
    pad = (-n) % chunk_size
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
    out = jnp.zeros((n + pad, m), dtype)

    def body(i, acc):
        start = i * chunk_size
        xc = lax.dynamic_slice(xp, (start, 0), (chunk_size, d))
        return lax.dynamic_update_slice(acc, chunk_fn(xc), (start, 0))

    out = lax.fori_loop(0, (n + pad) // chunk_size, body, out)
    return out[:n]


@functools.partial(jax.jit, static_argnames=("iters",))
def _aniso_refine_single(x: Array, c0: Array, eta: float,
                         iters: int) -> Array:
    """Anisotropic (score-aware) Lloyd refinement for ONE subspace.

    Minimizes ``Σᵢ ‖xᵢ−c‖² + (η−1)·((xᵢ−c)·ûᵢ)²`` (ûᵢ = xᵢ/‖xᵢ‖): the
    residual component PARALLEL to the datapoint — the part that perturbs
    query·point scores and near-neighbor ranking — is weighted η× against
    the orthogonal remainder (the ScaNN insight, arXiv:1908.10396,
    restated for L2-on-normalized-vectors retrieval). η=1 is plain Lloyd.

    Assignment uses the same anisotropic metric; the update solves the
    per-centroid normal equations, which simplify elegantly:
        [|I_c|·I + (η−1)·Σ ûûᵀ] c = η·Σ x      (since (û·x)û‖x‖ = x)
    one (dsub, dsub) PD solve per centroid. Empty clusters keep their
    previous centroid (refinement starts from trained, repaired codebooks).
    """
    n, dsub = x.shape
    k = c0.shape[0]
    xf = x.astype(jnp.float32)
    nx = jnp.sqrt(jnp.maximum(jnp.sum(xf * xf, axis=-1), 1e-24))   # (n,)
    u = xf / nx[:, None]
    w = jnp.float32(eta - 1.0)
    xx = nx * nx
    sum_outer_flat = (u[:, :, None] * u[:, None, :]).reshape(n, dsub * dsub)
    eye = jnp.eye(dsub, dtype=jnp.float32)

    def body(c, _):
        cc = jnp.sum(c * c, axis=-1)                              # (k,)
        s = jnp.dot(xf, c.T, preferred_element_type=jnp.float32,
                    precision=lax.Precision.HIGHEST)              # (n, k)
        d = (xx[:, None] - 2.0 * s + cc[None]
             + w * (nx[:, None] - s / nx[:, None]) ** 2)
        a = jnp.argmin(d, axis=-1)
        cnt = jax.ops.segment_sum(jnp.ones((n,), jnp.float32), a,
                                  num_segments=k)                 # (k,)
        sx = jax.ops.segment_sum(xf, a, num_segments=k)           # (k, dsub)
        mflat = jax.ops.segment_sum(sum_outer_flat, a, num_segments=k)
        big_a = (cnt[:, None, None] * eye[None]
                 + w * mflat.reshape(k, dsub, dsub))
        # empty clusters: solve against I (harmless) and keep old c below.
        big_a = jnp.where(cnt[:, None, None] > 0, big_a, eye[None])
        c_new = jax.vmap(jnp.linalg.solve)(big_a, (1.0 + w) * sx)
        return jnp.where(cnt[:, None] > 0, c_new, c), None

    c, _ = lax.scan(body, c0.astype(jnp.float32), None, length=iters)
    return c


def anisotropic_refine(x_sub: Array, centroids: Array, eta: float,
                       iters: int = 4) -> Array:
    """Per-subspace anisotropic refinement: ``(m, n, dsub) codebooks →
    (m, k, dsub)``. Subspaces loop in Python (one compiled program, m
    dispatches) so the (n, dsub²) outer-product intermediate never scales
    with m."""
    outs = [_aniso_refine_single(x_sub[j], centroids[j], float(eta), iters)
            for j in range(x_sub.shape[0])]
    return jnp.stack(outs, axis=0)

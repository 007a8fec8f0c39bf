"""Elementwise / small-vector algebra exported by the SQL layer of the reference.

Capability parity with the reference's scalar C UDFs
(/root/reference/freddy_extension/core_functions.c:23-383 and
cosine_similarity.c:12-45): cosine similarity (full and normalized/dot-only
variants), vector plus/minus/normalize, centroid (mean of a set of vectors).

The reference computes these one pair at a time in scalar C loops; here every
op is a jittable jnp expression that batches freely (leading axes broadcast),
and the "bytea" codec boundary disappears — vectors are device arrays.
Accumulation is float32 (the reference uses double for cosine; float32 is
bit-adequate for 300-d unit vectors and keeps the fast matmul path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

_EPS = 1e-12


@jax.jit
def cosine_similarity(a: Array, b: Array) -> Array:
    """Full cosine similarity (normalizes both sides).

    Parity: ``cosine_similarity`` (core_functions.c:23-42, cosine_similarity.c:12-37).
    Works on single vectors ``(d,)`` or batches ``(..., d)``.
    """
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    dot = jnp.sum(a * b, axis=-1)
    na = jnp.sqrt(jnp.sum(a * a, axis=-1))
    nb = jnp.sqrt(jnp.sum(b * b, axis=-1))
    return dot / jnp.maximum(na * nb, _EPS)


@jax.jit
def cosine_similarity_norm(a: Array, b: Array) -> Array:
    """Dot product only — assumes normalized inputs.

    Parity: ``cosine_similarity_norm`` / ``cosine_similarity_bytea``
    (core_functions.c:44-81).
    """
    return jnp.sum(a.astype(jnp.float32) * b.astype(jnp.float32), axis=-1)


@jax.jit
def vec_plus(a: Array, b: Array) -> Array:
    """Parity: ``vec_plus`` (core_functions.c:146-178)."""
    return a + b


@jax.jit
def vec_minus(a: Array, b: Array) -> Array:
    """Parity: ``vec_minus`` (core_functions.c:83-115)."""
    return a - b


@jax.jit
def vec_normalize(a: Array) -> Array:
    """L2-normalize along the last axis.

    Parity: ``vec_normalize`` (core_functions.c:211-243).
    """
    a = a.astype(jnp.float32)
    norm = jnp.sqrt(jnp.sum(a * a, axis=-1, keepdims=True))
    return a / jnp.maximum(norm, _EPS)


@jax.jit
def centroid(vectors: Array) -> Array:
    """Mean over the second-to-last axis: ``(..., n, d) -> (..., d)``.

    Parity: ``centroid`` / ``centroid_bytea`` (core_functions.c:271-383).
    """
    return jnp.mean(vectors.astype(jnp.float32), axis=-2)


@jax.jit
def squared_l2(a: Array, b: Array) -> Array:
    """Squared L2 distance along the last axis.

    Parity: ``squareDistance`` (index_utils.c:500-508).
    """
    d = a.astype(jnp.float32) - b.astype(jnp.float32)
    return jnp.sum(d * d, axis=-1)


def sim_from_sqdist(sqdist: Array) -> Array:
    """Map squared-L2 distance between unit vectors to cosine similarity.

    The reference reports ``1.0 - distance/2.0`` for its ADC paths, valid for
    normalized vectors where ``||a-b||² = 2 - 2·a·b``
    (freddy--0.0.1.sql:511,526,547). Note the reference's ADC "distance" is
    the squared L2 (never rooted), so this is the exact inverse map.
    """
    return 1.0 - sqdist / 2.0


def sqdist_from_sim(sim: Array) -> Array:
    """Inverse of :func:`sim_from_sqdist`."""
    return 2.0 - 2.0 * sim

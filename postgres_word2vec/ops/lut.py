"""ADC lookup-table construction.

Parity targets: ``getPrecomputedDistances`` (index_utils.c:445-455) building
the per-query m×k table of squared subspace distances, and
``getPrecomputedDistancesDouble`` (index_utils.c:457-475) — the "short codes"
variant that fuses pairs of subquantizers into an (m/2)×k² table, enabled in
the reference when ``alpha·k > long_codes_threshold`` (ivpq_search_in.c:262-291).

The reference builds one LUT per query in scalar loops; here the whole query
batch builds in one shot: the cross term is a single batched matmul
``q_sub · Cᵀ`` (a batched matmul), the norm terms are rank-1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def build_luts(queries: Array, codebooks: Array) -> Array:
    """Per-subspace squared-distance tables: ``(B, d) × (m, k, dsub) → (B, m, k)``.

    ``luts[b, j, i] = ||q_b[j·dsub:(j+1)·dsub] − codebooks[j, i]||²``
    """
    m, k, dsub = codebooks.shape
    B = queries.shape[0]
    q = queries.astype(jnp.float32).reshape(B, m, dsub)
    c = codebooks.astype(jnp.float32)
    qq = jnp.sum(q * q, axis=-1)                    # (B, m)
    cc = jnp.sum(c * c, axis=-1)                    # (m, k)
    # (B, m, dsub) × (m, k, dsub) → (B, m, k): one matmul batched over m.
    qc = jnp.einsum("bmd,mkd->bmk", q, c, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(qq[:, :, None] - 2.0 * qc + cc[None, :, :], 0.0)


def build_double_luts(luts: Array) -> Array:
    """Fuse adjacent subspace pairs: ``(B, m, k) → (B, m/2, k²)``.

    ``double[b, p, i₁·k + i₂] = luts[b, 2p, i₁] + luts[b, 2p+1, i₂]`` —
    halves the gathers per code row at k²-sized tables (the reference's
    "double codes", index_utils.c:457-475). Requires even m.
    """
    B, m, k = luts.shape
    if m % 2 != 0:
        raise ValueError(f"double LUTs require even m, got {m}")
    a = luts[:, 0::2, :]                            # (B, m/2, k)
    b = luts[:, 1::2, :]                            # (B, m/2, k)
    return (a[:, :, :, None] + b[:, :, None, :]).reshape(B, m // 2, k * k)


def fuse_codes(codes: Array, k: int) -> Array:
    """Pair-fuse codes to index double LUTs: ``(n, m) → (n, m/2)`` int32.

    ``fused[:, p] = codes[:, 2p]·k + codes[:, 2p+1]``.
    """
    c = codes.astype(jnp.int32)
    return c[:, 0::2] * k + c[:, 1::2]

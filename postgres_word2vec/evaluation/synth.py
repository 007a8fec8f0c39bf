"""Synthetic embedding generators for benchmarking (zero-egress stand-in
for GoogleNews word2vec, the reference's dataset — README.md:151-156).

Two generators:

- :func:`generate_mixture` — round-1's flat cluster mixture with planted
  eval neighbors. Kept for the recall-ceiling control's "before" condition.
- :func:`generate_wordlike` — GoogleNews-like geometry: anisotropic
  (power-law) spectrum, topic→concept→variant hierarchy so every row has a
  handful of true near-neighbors (near-synonyms/inflections) separated from
  topic-level distractors, in a randomly rotated basis so no PQ subspace is
  axis-aligned with the spectrum.

The default parameters (v3) are CALIBRATED so a *reference-equivalent*
quantizer (scipy-style best-of-10 converged Lloyd, m=12, k=256 — see
evaluation/recall_ceiling.py) clears FREDDY's published operating points
on GoogleNews (PQ@5 0.38, PQ+PV@5 0.87, /root/reference/README.md:118-123)
at 3M×300: control pq@5 0.43 / pq_pv@5 0.91. That calibration is what
makes recall numbers measured on this data comparable to the reference's.

Calibration history (evaluation/synth_calibrate.py, 26 configs at 3M):
the round-2 "v2" parameters hit the scan
point exactly (0.399 vs 0.38) but capped PV@20 at 0.80 — and a 4-round
3M sweep showed no (group, sigma_v, sigma_c) choice hits both published
points at once; the family's frontier passes through (0.48, 0.88). The
fringe tier (``fringe_frac``/``sigma_f``: same-concept distractors in the
band between true siblings and the topic shell) decouples the two — it
contests the ADC top-5 without leaving the top-k·pvf shortlist — moving
the frontier to (0.43, 0.91), where v3 sits. Both published bars are now
cleared by the control; the residual +0.05 scan offset vs GoogleNews'
0.38 is the documented data-difficulty difference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

Array = jax.Array

#: round-2 calibration (scan-point parity only; PV ceiling 0.80) — kept
#: for the recall-ceiling control's "before" comparison. fringe_frac=0.0
#: is EXPLICIT: the v3 defaults turned the fringe tier on, and inheriting
#: them silently would stop reproducing the recorded v2 geometry.
V2_PARAMS = dict(group=8, beta=0.55, sigma_c=0.7, sigma_v=0.55,
                 fringe_frac=0.0)

#: round-3 calibration (= generate_wordlike defaults): fringe-tier
#: geometry whose ref-equivalent control clears both published PQ points.
V3_PARAMS = dict(group=64, beta=0.55, sigma_c=0.7, sigma_v=0.5,
                 fringe_frac=0.875, sigma_f=0.65)


@functools.partial(jax.jit, static_argnames=("n", "d", "eval_q"))
def generate_mixture(key: Array, n: int, d: int = 300,
                     eval_q: int = 256) -> Array:
    """Round-1 generator: 1024-cluster isotropic mixture + planted
    neighbors for the first ``eval_q`` rows. Hard for PQ (isotropic
    within-cluster noise ⇒ quantization error swamps neighbor gaps)."""
    kc, ka, kn, kp, ks = jax.random.split(key, 5)
    centers = jax.random.normal(kc, (1024, d), jnp.float32)
    assign = jax.random.randint(ka, (n,), 0, 1024)
    v = (jnp.take(centers, assign, axis=0)
         + 0.7 * jax.random.normal(kn, (n, d), jnp.float32))
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    n_plant = 16
    plant_ids = (jax.random.choice(ks, n - eval_q,
                                   (eval_q * n_plant,), replace=False)
                 + eval_q)
    src = jnp.repeat(v[:eval_q], n_plant, axis=0)
    planted = src + 0.25 * jax.random.normal(kp, src.shape, jnp.float32)
    planted = planted / jnp.linalg.norm(planted, axis=-1, keepdims=True)
    return v.at[plant_ids].set(planted)


@functools.partial(
    jax.jit,
    static_argnames=("n", "d", "n_topics", "group", "chunk_size",
                     "fringe_frac"))
def generate_wordlike(key: Array, n: int, d: int = 300, *,
                      n_topics: int = 1024, group: int = 64,
                      beta: float = 0.55, sigma_c: float = 0.7,
                      sigma_v: float = 0.5, fringe_frac: float = 0.875,
                      sigma_f: float = 0.65,
                      chunk_size: int = 262144) -> Array:
    """GoogleNews-like synthetic embeddings → ``(n, d)`` float32, L2-normed.

    Construction (all in a "spectral" basis, then rotated):

    1. per-dim scales ``s_i ∝ (i+1)^-beta`` (power-law spectrum, normalized
       to mean-square 1) — word2vec embeddings have most variance in a few
       dozen directions, which is what makes PQ/IVFADC viable on them;
    2. ``n_topics`` topic centers ``t = z ⊙ s``;
    3. ``n/group`` concepts ``c = t[topic] + sigma_c·(z ⊙ s)``;
    4. each row picks a random concept: ``v = c + sigma_v·(z ⊙ s)`` — so a
       row's true near-neighbors are its ~``group`` sibling variants
       (near-synonyms), well separated from same-topic distractors;
    5. rows are rotated by a random orthogonal Q (so the anisotropy is not
       axis-aligned with PQ's contiguous subspace split) and normalized.

    Rows are generated in fixed-size chunks (``lax.map``) so the transient
    noise tensors never exceed chunk_size×d. Concept membership is random,
    not strided — regular stride layouts collide with ``approx_min_k``'s
    bins (see CLAUDE.md).
    """
    n_concepts = max(n // group, 1)
    kt, ktof, kc, ka, kq, kv = jax.random.split(key, 6)

    s = jnp.arange(1, d + 1, dtype=jnp.float32) ** (-beta)
    s = s / jnp.sqrt(jnp.mean(s * s))

    topics = jax.random.normal(kt, (n_topics, d), jnp.float32) * s
    topic_of = jax.random.randint(ktof, (n_concepts,), 0, n_topics)
    concepts = (jnp.take(topics, topic_of, axis=0)
                + sigma_c * jax.random.normal(kc, (n_concepts, d),
                                              jnp.float32) * s)
    concept_of = jax.random.randint(ka, (n,), 0, n_concepts)
    q_rot = jax.random.orthogonal(kq, d)

    def chunk_fn(args):
        cof, idx = args
        kchunk = jax.random.fold_in(kv, idx[0])
        noise = jax.random.normal(kchunk, (cof.shape[0], d), jnp.float32)
        sig = sigma_v
        if fringe_frac > 0.0:
            # FRINGE tier: a fraction of each concept's variants sit at a
            # wider radius (sigma_f > sigma_v). They densely fill the
            # distance band between true siblings and the topic shell, so
            # ADC quantization noise swaps them into the top-5 (scan
            # confusion) while the much-closer core siblings stay inside
            # the top-k·pvf shortlist (PV recall) — the decoupling that
            # lets the calibration hit FREDDY's scan AND PV points at
            # once (README.md:118-123).
            u = jax.random.uniform(jax.random.fold_in(kchunk, 1),
                                   (cof.shape[0],))
            sig = jnp.where(u < fringe_frac, sigma_f, sigma_v)[:, None]
        v = jnp.take(concepts, cof, axis=0) + sig * noise * s
        v = jnp.dot(v, q_rot, preferred_element_type=jnp.float32)
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    if n <= chunk_size:
        return chunk_fn((concept_of, jnp.zeros((1,), jnp.int32)))
    pad = (-n) % chunk_size
    cof_p = jnp.pad(concept_of, (0, pad)).reshape(-1, chunk_size)
    idxs = jnp.arange(cof_p.shape[0], dtype=jnp.int32)[:, None]
    out = jax.lax.map(chunk_fn, (cof_p, idxs))
    return out.reshape(-1, d)[:n]

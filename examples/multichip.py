#!/usr/bin/env python3
"""Multi-chip walkthrough on a virtual device mesh.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/multichip.py

Shows the four sharded paths: data-parallel codebook training, rows-sharded
exact and PQ-ADC search, cell-partitioned IVFADC probing, and the
target-sharded IVPQ join. On a multi-GPU host the same code runs unchanged
over NVLink-connected cards.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from postgres_word2vec.utils.config import init_compile_cache

init_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

from postgres_word2vec.models import ivpq as ivpq_mod
from postgres_word2vec.models.ivfadc import IVFADCIndex
from postgres_word2vec.models.ivpq import IVPQIndex
from postgres_word2vec.models.pq import PQIndex
from postgres_word2vec.ops import lut
from postgres_word2vec.parallel import sharding


def main() -> None:
    n_dev = len(jax.devices())
    q_axis = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = sharding.make_mesh(rows=n_dev // q_axis, q=q_axis)
    rows = mesh.shape["rows"]
    print(f"mesh: {dict(mesh.shape)} over {n_dev} devices")

    rng = np.random.default_rng(0)
    n, d, k = 1024 * rows, 32, 5
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    vj = jnp.asarray(vecs)
    queries = jnp.asarray(vecs[:8])

    # 1. data-parallel codebook training
    xs = sharding.shard_rows(vj, mesh)
    cents, counts = sharding.sharded_kmeans(mesh, jax.random.PRNGKey(0), xs,
                                            k=16, iters=5)
    print(f"sharded k-means: {cents.shape} centroids, "
          f"{int(counts.sum())} rows assigned")

    # 2. rows-sharded exact search
    d1, i1 = sharding.sharded_exact_top_k(mesh, queries, xs, k)
    print(f"sharded exact:   self-match@1 = "
          f"{float((np.asarray(i1)[:, 0] == np.arange(8)).mean()):.2f}")

    # 3. rows-sharded PQ ADC scan
    pq = PQIndex.build(jax.random.PRNGKey(1), vj, m=4, k=16,
                       train_size=None, iters=5)
    luts = lut.build_luts(queries, pq.codebook.centroids)
    d2, i2 = sharding.sharded_adc_top_k(
        mesh, luts, sharding.shard_rows(pq.codes, mesh), k)
    print(f"sharded PQ ADC:  self-match@1 = "
          f"{float((np.asarray(i2)[:, 0] == np.arange(8)).mean()):.2f}")

    # 4. cell-partitioned IVFADC probe
    ivf = IVFADCIndex.build(jax.random.PRNGKey(2), vj, m=4, k=16,
                            k_coarse=12, train_size=None, iters=5)
    bundle = sharding.shard_ivfadc(ivf, mesh)
    d3, i3 = sharding.sharded_ivfadc_probe(mesh, queries, bundle, w=3, k=k)
    print(f"sharded IVFADC:  self-match@1 = "
          f"{float((np.asarray(i3)[:, 0] == np.arange(8)).mean()):.2f}")

    # 5. target-sharded IVPQ join round
    iv = IVPQIndex.build(jax.random.PRNGKey(3), vj, m=4, k=8, k_coarse=4,
                         train_size=None, iters=5)
    t = (n // rows) * rows
    tids = jnp.arange(t, dtype=jnp.int32)
    d4, i4, retrieved = sharding.sharded_ivpq_join_round(
        mesh, queries, iv.coarse.centroids, iv.codebook.centroids,
        jnp.take(iv.codes, tids, axis=0), jnp.take(iv.cell_of, tids), tids,
        jnp.ones((t,), bool),
        ivpq_mod.uniform_statistics(iv.coarse.cell_counts),
        jnp.take(vj, tids, axis=0), k=k, alpha=20)
    print(f"sharded IVPQ:    self-match@1 = "
          f"{float((np.asarray(i4)[:, 0] == np.arange(8)).mean()):.2f}, "
          f"mean retrieved = {float(np.asarray(retrieved).mean()):.0f}")


if __name__ == "__main__":
    main()

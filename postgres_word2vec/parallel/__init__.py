"""Multi-chip execution: meshes, sharded search, sharded codebook training."""

from postgres_word2vec.parallel.sharding import (
    make_mesh,
    shard_rows,
    replicate,
    sharded_exact_top_k,
    sharded_adc_top_k,
    sharded_kmeans_step,
    sharded_kmeans,
)

__all__ = [
    "make_mesh",
    "shard_rows",
    "replicate",
    "sharded_exact_top_k",
    "sharded_adc_top_k",
    "sharded_kmeans_step",
    "sharded_kmeans",
]

"""Device-side compute primitives (JAX/XLA reference paths + Pallas kernels)."""

from postgres_word2vec.ops import vector_ops
from postgres_word2vec.ops import topk
from postgres_word2vec.ops import kmeans
from postgres_word2vec.ops import lut
from postgres_word2vec.ops import adc

__all__ = ["vector_ops", "topk", "kmeans", "lut", "adc"]

"""postgres_word2vec — a word-embedding search engine in JAX, on the GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of FREDDY
(guenthermi/postgres-word2vec, SIGMOD'18): cosine/L2 exact k-NN, product
quantization (PQ) with asymmetric distance computation, IVFADC inverted-file
search, inverted multi-index PQ (IVPQ) batched kNN-joins with
statistics-driven adaptive probing, post-verification re-ranking, analogy,
grouping, k-means clustering, tokenization, and online index maintenance.

Where the reference runs C UDF kernels inside a Postgres backend and moves
data through SPI queries per call (see /root/reference/freddy_extension/),
this framework keeps all index state resident in device memory as packed
arrays and expresses every hot loop as batched matmuls, XLA gathers, or
Pallas kernels on the Triton route.
"""

from postgres_word2vec.store import VectorStore
from postgres_word2vec.models.exact import ExactIndex
from postgres_word2vec.models.pq import PQIndex, PQCodebook
from postgres_word2vec.models.ivfadc import IVFADCIndex
from postgres_word2vec.models.ivpq import IVPQIndex
from postgres_word2vec.api import Freddy, RuntimeParams

__version__ = "0.1.0"

__all__ = [
    "VectorStore",
    "ExactIndex",
    "PQIndex",
    "PQCodebook",
    "IVFADCIndex",
    "IVPQIndex",
    "Freddy",
    "RuntimeParams",
    "__version__",
]

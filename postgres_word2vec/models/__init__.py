"""Index model families: exact, PQ, IVFADC, IVPQ."""

from postgres_word2vec.models.exact import ExactIndex
from postgres_word2vec.models.pq import PQIndex, PQCodebook
from postgres_word2vec.models.ivfadc import IVFADCIndex
from postgres_word2vec.models.ivpq import IVPQIndex

__all__ = ["ExactIndex", "PQIndex", "PQCodebook", "IVFADCIndex", "IVPQIndex"]

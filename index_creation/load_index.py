#!/usr/bin/env python3
"""Re-import previously built index artifacts and sanity-check them against
a store (reference ``load_index.py`` parity — re-import a pickled index
without recomputation).

    python index_creation/load_index.py <store.npz> <index.npz> <type>

``type`` ∈ {pq, ivfadc, ivpq}. Prints a small self-query check.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from postgres_word2vec.models.ivfadc import IVFADCIndex
from postgres_word2vec.models.ivpq import IVPQIndex
from postgres_word2vec.models.pq import PQIndex
from postgres_word2vec.store import VectorStore

LOADERS = {"pq": PQIndex.load, "ivfadc": IVFADCIndex.load,
           "ivpq": IVPQIndex.load}


def main(store_path: str, index_path: str, index_type: str) -> None:
    store = VectorStore.load(store_path)
    index = LOADERS[index_type](index_path)
    if index.size != store.size:
        raise SystemExit(f"index rows ({index.size}) != store rows "
                         f"({store.size})")
    q = store.vectors_norm[:4]
    if index_type == "pq":
        _, ids = index.search(q, 3)
    elif index_type == "ivfadc":
        _, ids = index.search_adaptive(q, 3)
    else:
        import jax.numpy as jnp
        _, ids = index.search_join(q, 3, jnp.arange(
            min(store.size, 1000), dtype=jnp.int32), alpha=100)
    import numpy as np
    hit = float((np.asarray(ids)[:, 0] == np.arange(4)).mean())
    print(f"loaded {index_type} index: {index.size} rows; "
          f"self-match@1 on 4 probes: {hit:.2f}")


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) != 4:
        print(__doc__)
        sys.exit(1)
    main(*sys.argv[1:4])

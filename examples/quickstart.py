#!/usr/bin/env python3
"""Quickstart: build an engine from an embedding file and query it.

    JAX_PLATFORMS=cpu python examples/quickstart.py [embeddings.txt]

Without an argument, generates a small synthetic vocabulary so the example
is runnable anywhere.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from postgres_word2vec.utils.config import init_compile_cache

init_compile_cache()

import numpy as np

from postgres_word2vec import Freddy, VectorStore


def main() -> None:
    if len(sys.argv) > 1:
        store = VectorStore.from_text_file(sys.argv[1])
    else:
        rng = np.random.default_rng(0)
        vecs = rng.normal(size=(2000, 64)).astype(np.float32)
        words = [f"word{i}" for i in range(2000)]
        store = VectorStore.from_arrays(words, vecs)

    print(f"store: {store.size} words × {store.dim}d")
    eng = Freddy.build(store, seed=0,
                       pq_m=8, pq_k=32, ivfadc_m=8, ivfadc_k=32,
                       k_coarse=max(8, store.size // 200),
                       ivpq_m=8, ivpq_k=16, ivpq_k_coarse=8,
                       train_size=min(100_000, store.size), iters=8)

    w = store.words[0]
    print(f"\nknn({w!r}, 5):")
    for word, sim in eng.knn(w, 5):
        print(f"  {word:20s} {sim:.4f}")

    eng.set_knn_function("k_nearest_neighbour_pq_pv")
    print(f"\nsame query through PQ + post-verification:")
    for word, sim in eng.knn(w, 5):
        print(f"  {word:20s} {sim:.4f}")

    targets = store.words[: store.size // 2]
    rows = eng.knn_join(store.words[:3], 2, targets)
    print(f"\nknn_join (3 queries × {len(targets)} targets, k=2):")
    for q, t, sim in rows:
        print(f"  {q:12s} -> {t:12s} {sim:.4f}")

    report = eng.autotune(target_recall=0.9, k=5, sample=32)
    best = next(r for r in report if r.get("chosen"))
    print(f"\nautotune -> {best['name']} {best['params']} "
          f"(recall {best['recall']:.2f}, {best['seconds'] * 1e3:.1f} ms)")

    print(f"\ncluster 20 tokens into 3: "
          f"{eng.cluster(store.words[:20], 3)[:6]} …")
    eng.insert_batch([f"{store.words[0]} {store.words[1]}"])
    print(f"inserted compound term; vocab now {eng.store.size}")


if __name__ == "__main__":
    main()

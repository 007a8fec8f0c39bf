#!/usr/bin/env python3
"""Offline loader: embedding file → vector store artifact.

Parity with the reference's ``vec2database.py`` (parses text embeddings,
L2-normalizes, bulk-inserts into the vector tables): here the "database" is
an .npz store artifact holding the vocabulary plus raw vectors; normalized
vectors are derived at load. Usage:

    python index_creation/vec2database.py config/vecs_config.json

Config keys: ``vec_file_path`` (text or .bin), ``store_path`` (output .npz),
optional ``max_words``, ``normalized`` (ignored — both tables are always
available, matching the reference keeping google_vecs and google_vecs_norm).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from postgres_word2vec.store import VectorStore
from postgres_word2vec.utils.config import Configuration, INFO, Logger


def main(config_path: str) -> None:
    cfg = Configuration(config_path)
    log = Logger()
    src = Path(cfg.get_value("vec_file_path"))
    out = Path(cfg.get_value("store_path"))
    max_words = cfg.get_value_or("max_words", None)
    t0 = time.perf_counter()
    if src.suffix == ".bin":
        store = VectorStore.from_binary_file(src, max_words)
    else:
        store = VectorStore.from_text_file(src, max_words)
    log.log(INFO, f"parsed {store.size} x {store.dim} vectors in "
                  f"{time.perf_counter() - t0:.1f}s")
    store.save(out)
    log.log(INFO, f"store written to {out}")


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) != 2:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1])

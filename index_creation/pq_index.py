#!/usr/bin/env python3
"""PQ index build driver (reference ``pq_index.py`` parity).

    python index_creation/pq_index.py config/pq_config.json

Config keys (matching the reference's pq_config.json where meaningful):
``m``, ``k``, ``train_size``, ``store_path`` (input store .npz),
``export_filename`` (output index .npz), optional ``seed``, ``iters``.
Codebook training and encoding run on the accelerator (scipy/faiss in the
reference, batched Lloyd's here).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

from postgres_word2vec.models.pq import PQIndex
from postgres_word2vec.store import VectorStore
from postgres_word2vec.utils.config import Configuration, INFO, Logger


def main(config_path: str) -> None:
    cfg = Configuration(config_path)
    log = Logger()
    store = VectorStore.load(cfg.get_value("store_path"))
    t0 = time.perf_counter()
    index = PQIndex.build(
        jax.random.PRNGKey(cfg.get_value_or("seed", 0)),
        store.vectors_norm,
        m=cfg.get_value_or("m", 12), k=cfg.get_value_or("k", 256),
        train_size=cfg.get_value_or("train_size", 100_000),
        iters=cfg.get_value_or("iters", 10))
    log.log(INFO, f"PQ index built ({index.size} codes, m={index.m}, "
                  f"k={index.k}) in {time.perf_counter() - t0:.1f}s")
    out = cfg.get_value("export_filename")
    index.save(out)
    log.log(INFO, f"index written to {out}")


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) != 2:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1])

#!/usr/bin/env python3
"""IVFADC index build driver (reference ``ivfadc.py`` parity).

    python index_creation/ivfadc.py config/ivfadc_config.json

Config keys: ``m``, ``k``, ``k_coarse``, ``train_size_coarse`` (used as the
shared training-sample size, like the reference's 100k), ``store_path``,
``export_filename``, optional ``seed``, ``iters``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

from postgres_word2vec.models.ivfadc import IVFADCIndex
from postgres_word2vec.store import VectorStore
from postgres_word2vec.utils.config import Configuration, INFO, Logger


def main(config_path: str) -> None:
    cfg = Configuration(config_path)
    log = Logger()
    store = VectorStore.load(cfg.get_value("store_path"))
    t0 = time.perf_counter()
    index = IVFADCIndex.build(
        jax.random.PRNGKey(cfg.get_value_or("seed", 0)),
        store.vectors_norm,
        m=cfg.get_value_or("m", 12), k=cfg.get_value_or("k", 256),
        k_coarse=cfg.get_value_or("k_coarse", 1000),
        train_size=cfg.get_value_or("train_size_coarse", 100_000),
        iters=cfg.get_value_or("iters", 10))
    log.log(INFO, f"IVFADC index built ({index.size} codes, "
                  f"{index.num_cells} cells, list_cap={index.list_cap}) "
                  f"in {time.perf_counter() - t0:.1f}s")
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

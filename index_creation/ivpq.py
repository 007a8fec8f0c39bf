#!/usr/bin/env python3
"""IVPQ (multi-index) build driver (reference ``ivpq.py`` parity).

    python index_creation/ivpq.py config/ivpq_config.json

Config keys: ``m``, ``k``, ``k_coarse`` (per position; 2 positions →
k_coarse² cells, COARSE_TYPE='MULTI_INDEX' parity), ``train_size_coarse``,
``store_path``, ``export_filename``, optional ``statistic_words_path`` — a
newline-separated word list to build the per-cell frequency statistics from
(the reference's ``statistic_table``/``statistic_column`` pair).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from postgres_word2vec.models.ivpq import IVPQIndex, build_statistics
from postgres_word2vec.store import VectorStore
from postgres_word2vec.utils.config import Configuration, INFO, Logger


def main(config_path: str) -> None:
    cfg = Configuration(config_path)
    log = Logger()
    store = VectorStore.load(cfg.get_value("store_path"))
    t0 = time.perf_counter()
    index = IVPQIndex.build(
        jax.random.PRNGKey(cfg.get_value_or("seed", 0)),
        store.vectors_norm,
        m=cfg.get_value_or("m", 30), k=cfg.get_value_or("k", 32),
        k_coarse=cfg.get_value_or("k_coarse", 32),
        train_size=cfg.get_value_or("train_size_coarse", 100_000),
        iters=cfg.get_value_or("iters", 10))
    log.log(INFO, f"IVPQ index built ({index.size} codes, "
                  f"{index.num_cells} cells) in "
                  f"{time.perf_counter() - t0:.1f}s")
    out = cfg.get_value("export_filename")
    index.save(out)
    log.log(INFO, f"index written to {out}")

    stats_words = cfg.get_value_or("statistic_words_path", "")
    if stats_words:
        words = [w for w in Path(stats_words).read_text().split("\n") if w]
        ids = jnp.asarray(store.get_ids(words, strict=False), jnp.int32)
        stats = build_statistics(index.cell_of, ids, index.num_cells)
        stats_out = str(out) + ".stats.npy"
        np.save(stats_out, np.asarray(stats))
        log.log(INFO, f"statistics ({len(words)} domain words) written to "
                      f"{stats_out}")


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) != 2:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1])

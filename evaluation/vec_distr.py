#!/usr/bin/env python3
"""Dataset geometry study (reference ``vec_distr.py`` parity): distribution
of angles to nearest and farthest neighbors, computed with the engine's own
exact search instead of faiss + brute force.

    python evaluation/vec_distr.py config/time_measurement.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import engine_from_config, sample_words

import numpy as np

from postgres_word2vec.utils.config import Configuration


def main(config_path: str) -> None:
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg)
    sample = sample_words(eng, cfg.get_value_or("query_sample", 100),
                          cfg.get_value_or("seed", 0))
    q = eng._query_matrix(sample)
    # nearest (excluding self) and farthest cosine per sampled word
    d, i = eng.exact.search(q, 2)
    sims = 1.0 - np.asarray(d) / 2.0
    nearest = sims[:, 1]                       # rank 0 is the word itself
    import jax.numpy as jnp
    scores = jnp.dot(q, eng.store.vectors_norm.T)
    farthest = np.asarray(jnp.min(scores, axis=-1))
    out = {
        "sample": len(sample),
        "nearest_cos": {"mean": float(nearest.mean()),
                        "p10": float(np.percentile(nearest, 10)),
                        "p90": float(np.percentile(nearest, 90))},
        "farthest_cos": {"mean": float(farthest.mean()),
                         "p10": float(np.percentile(farthest, 10)),
                         "p90": float(np.percentile(farthest, 90))},
        "nearest_angle_deg": float(np.degrees(
            np.arccos(np.clip(nearest, -1, 1))).mean()),
        "farthest_angle_deg": float(np.degrees(
            np.arccos(np.clip(farthest, -1, 1))).mean()),
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) != 2:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1])

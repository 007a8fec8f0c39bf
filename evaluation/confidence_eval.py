#!/usr/bin/env python3
"""Confidence-model validation (reference ``confidence_eval.py`` parity):
sweep the configured confidence and report the fraction of queries whose
probed cells actually held ≥ k·alpha targets.

    python evaluation/confidence_eval.py config/confidence_eval.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import engine_from_config, sample_words

from postgres_word2vec.evaluation import confidence_eval
from postgres_word2vec.utils.config import Configuration


def main(config_path: str) -> None:
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg)
    eng.set_alpha(cfg.get_value_or("alpha", 10))
    queries = sample_words(eng, cfg.get_value_or("query_sample", 50),
                           cfg.get_value_or("seed", 0))
    targets = sample_words(eng, cfg.get_value_or("target_sample", 5000),
                           cfg.get_value_or("seed", 0) + 1)
    out = confidence_eval(
        eng, queries, cfg.get_value_or("k", 5), targets,
        confidences=tuple(cfg.get_value_or(
            "confidences", [0.05, 0.2, 0.4, 0.6, 0.8, 0.95])))
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) != 2:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1])

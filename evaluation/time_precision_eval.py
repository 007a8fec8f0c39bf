#!/usr/bin/env python3
"""The README kNN-join time/precision figure driver (reference
``time_precision_eval.py`` parity: Baseline / PQ / Exact / PQ+PV over
alphas, pvf sweep).

    python evaluation/time_precision_eval.py config/time_precision_eval.json

Config: ``k``, ``query_sample``, ``target_sample``, ``alphas``, ``pvfs``,
``methods`` + engine keys (see _common). Emits JSON records; also measures
the PQ ``pq_search_in_batch`` baseline the reference plots.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import engine_from_config, sample_words

from postgres_word2vec.evaluation import (calculate_precision,
                                              get_exact_results,
                                              time_precision_sweep)
from postgres_word2vec.utils.config import Configuration


def main(config_path: str) -> None:
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg)
    k = cfg.get_value_or("k", 5)
    queries = sample_words(eng, cfg.get_value_or("query_sample", 100),
                           cfg.get_value_or("seed", 0))
    targets = sample_words(eng, cfg.get_value_or("target_sample", 10_000),
                           cfg.get_value_or("seed", 0) + 1)
    if cfg.get_value_or("statistics_domain", False):
        # per-cell frequency statistics over the target domain — the
        # reference's create_statistics + set_statistics_table setup
        # (freddy--0.0.1.sql:150-186) its figure ran with.
        eng.create_statistics("targets", targets)

    records = time_precision_sweep(
        eng, queries, k, targets,
        alphas=tuple(cfg.get_value_or("alphas", [50, 100, 150, 200])),
        pvfs=tuple(cfg.get_value_or("pvfs", [3, 5, 10, 15])),
        methods=tuple(cfg.get_value_or("methods", [0, 1, 2])))

    # the PQ in-set baseline curve (pq_search_in_batch)
    exact = get_exact_results(eng, queries, k, targets)
    t0 = time.perf_counter()
    rows = eng.knn_in_pq_batch(queries, k, targets)
    records.append({"method": "baseline_pq_in_batch",
                    "time_s": time.perf_counter() - t0,
                    "precision": calculate_precision(rows, exact)})
    plot_path = cfg.get_value_or("plot_path", "")
    if plot_path:
        from postgres_word2vec.evaluation.plots import plot_time_precision
        Path(plot_path).parent.mkdir(parents=True, exist_ok=True)
        plot_time_precision(records, plot_path)
        # interactive twin (reference evaluation_utils.py:240-344 emits
        # plotly-offline HTML; ours is the self-contained SVG report)
        from postgres_word2vec.evaluation.html_report import (
            figure_from_records, write_html_report)
        html_path = str(Path(plot_path).with_suffix(".html"))
        write_html_report(
            html_path,
            [figure_from_records(records)],
            title="kNN-join time / precision trade-off",
            subtitle=f"k={k}, {len(targets)} targets — one curve per "
                     "method; hover for the per-point config")
    print(json.dumps(records, indent=2))


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) != 2:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1])

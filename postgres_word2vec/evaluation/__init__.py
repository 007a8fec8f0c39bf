"""Evaluation harness — the reference's evaluation/ directory, in-process.

Precision-vs-exact methodology, stage timing ("TRACK"), time/precision
sweeps, confidence validation, target-count prediction.
"""

from postgres_word2vec.evaluation.harness import (
    calculate_precision,
    get_exact_results,
    measurement,
    batch_measurement,
    create_track_statistics,
    time_precision_sweep,
    confidence_eval,
    target_count_eval,
)

__all__ = [
    "calculate_precision",
    "get_exact_results",
    "measurement",
    "batch_measurement",
    "create_track_statistics",
    "time_precision_sweep",
    "confidence_eval",
    "target_count_eval",
]

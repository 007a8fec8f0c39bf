"""Stage-timing instrumentation — the reference's ``TRACK`` notices.

The reference brackets kernel stages with ``clock()`` and emits
``elog(INFO, "TRACK <metric> <value>")`` (freddy.c:527-651,
ivpq_search_in.c:233-697); the Python side scrapes psycopg2 notices
(evaluation/tracking.py:6-17). Here the emitter and scraper collapse into
one in-process recorder with the same metric names, so the reference's
step-wise evaluation methodology ports directly:

    precomputation_time, query_construction_time, data_retrieval_time,
    computation_time, total_time, retrieved, target_count

``data_retrieval_time`` here means host→device transfer + gathers (the
SPI analog); it is usually ~0 because index state is device-resident.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Tracker:
    """Metric recorder with the reference Tracker's query surface
    (evaluation/tracking.py: ``get_results`` → dict of metric → [values])."""

    def __init__(self) -> None:
        self._values: dict[str, list[float]] = defaultdict(list)

    def track(self, metric: str, value: float) -> None:
        self._values[metric].append(float(value))

    @contextlib.contextmanager
    def stage(self, metric: str):
        """Time a stage (seconds, matching the reference's CLOCKS unit
        choice of seconds-as-float)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.track(metric, time.perf_counter() - t0)

    def get_results(self) -> dict[str, list[float]]:
        return {k: list(v) for k, v in self._values.items()}

    def clear_track(self) -> None:
        self._values.clear()


#: Process-global tracker the engine reports into (mirrors the reference's
#: connection-scoped notice stream).
GLOBAL_TRACKER = Tracker()

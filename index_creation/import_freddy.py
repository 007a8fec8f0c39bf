#!/usr/bin/env python3
"""FREDDY database migration CLI: Postgres dump ↔ engine directory.

The reference's index state lives in 10 Postgres tables (schemas:
vec2database.py:25, pq_index.py:24-29, ivfadc.py:26-34, ivpq.py:20-58;
writers: database_export.py:19-77). Dump them with ``COPY <table> TO
'<dir>/<table>.copy'`` and this tool loads everything — vocabulary,
vectors, all three quantizers' codebooks and code tables, statistics
tables — VERBATIM (no retraining) into a saved engine directory:

    python index_creation/import_freddy.py import <dump_dir> <engine_dir>

The reverse writes an engine back out as COPY files a FREDDY instance
restores with ``COPY <table> FROM``:

    python index_creation/import_freddy.py export <engine_dir> <dump_dir>

Custom table names: pass ``role=table`` pairs after the directories (roles:
see ``postgres_word2vec.utils.migrate.DEFAULT_TABLES``).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from postgres_word2vec.utils.config import INFO, Logger


def main(argv: list[str]) -> None:
    from postgres_word2vec.api import Freddy
    from postgres_word2vec.utils import migrate

    mode, src, dst = argv[0], Path(argv[1]), Path(argv[2])
    tables = dict(pair.split("=", 1) for pair in argv[3:])
    log = Logger()
    t0 = time.perf_counter()
    if mode == "import":
        eng = migrate.import_engine(src, tables=tables or None)
        built = [n for n, i in (("pq", eng.pq), ("ivfadc", eng.ivfadc),
                                ("ivpq", eng.ivpq)) if i is not None]
        log.log(INFO, f"imported {eng.store.size} x {eng.store.dim} "
                      f"vectors, indexes: {built or 'none'}, statistics: "
                      f"{sorted(eng.statistics) or 'none'} in "
                      f"{time.perf_counter() - t0:.1f}s")
        eng.save(dst)
        log.log(INFO, f"engine written to {dst}")
    elif mode == "export":
        eng = Freddy.load(src)
        migrate.export_engine(eng, dst, tables=tables or None)
        log.log(INFO, f"dump written to {dst} in "
                      f"{time.perf_counter() - t0:.1f}s")
    else:
        raise SystemExit(f"unknown mode {mode!r} (import|export)")


if __name__ == "__main__":
    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) < 4:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1:])

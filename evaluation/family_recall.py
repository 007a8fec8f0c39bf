#!/usr/bin/env python
"""recall@10 of every family (the IVPQ join: recall@5) on ``chip_smoke.py``'s
engine — 3,072,000 × 300 word vectors, ``Freddy.build`` defaults — on
whatever backend JAX starts. Under ``JAX_PLATFORMS=cpu`` every family takes
its plain-XLA reference path, and that run sets ``chip_smoke.RECALL_FLOOR``.

    JAX_PLATFORMS=cpu python evaluation/family_recall.py [--seed 0]

Prints one JSON line per phase and writes
``chiprun_out/family_recall_<platform>.json``. The full-size build needs
tens of GiB of host memory on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    import jax

    import chip_smoke as smoke

    platform = jax.default_backend()
    out = dict(platform=platform, seed=args.seed, n=smoke.N_ROWS,
               jax=jax.__version__)
    t0 = time.perf_counter()
    eng, words = smoke.build_engine(args.seed)
    out["build_s"] = time.perf_counter() - t0
    print(json.dumps(dict(phase="build", s=out["build_s"])), flush=True)
    t0 = time.perf_counter()
    ev = smoke.eval_set(eng, words, args.seed)
    out["truth_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["recall"] = smoke.engine_recalls(eng, ev)
    out["recall_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    dest = ROOT / "chiprun_out" / f"family_recall_{platform}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

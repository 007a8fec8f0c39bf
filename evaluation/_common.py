"""Shared setup for the evaluation CLI scripts: build or load an engine
from a JSON experiment config.

Config keys: ``store_path`` (store .npz) or ``synthetic`` {n, d, seed} to
generate data in-process; optional ``pq_index`` / ``ivfadc_index`` /
``ivpq_index`` artifact paths (missing families are trained on the fly with
``build`` hyperparameters); ``query_sample``/``target_sample`` counts; plus
per-script keys documented in each script.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from postgres_word2vec import Freddy, VectorStore
from postgres_word2vec.models.ivfadc import IVFADCIndex
from postgres_word2vec.models.ivpq import IVPQIndex
from postgres_word2vec.models.pq import PQIndex
from postgres_word2vec.utils.config import Configuration


def engine_from_config(cfg: Configuration) -> Freddy:
    if cfg.has_key("store_path"):
        store = VectorStore.load(cfg.get_value("store_path"))
    else:
        syn = cfg.get_value_or("synthetic",
                               {"n": 20000, "d": 300, "seed": 0})
        if syn.get("generator") == "wordlike":
            # the calibrated GoogleNews-like generator (the bench dataset).
            import jax

            from postgres_word2vec.evaluation import synth
            vecs = np.asarray(synth.generate_wordlike(
                jax.random.PRNGKey(syn.get("seed", 0)), syn["n"],
                syn.get("d", 300)))
            store = VectorStore.from_arrays(
                [f"word{i}" for i in range(syn["n"])], vecs,
                normalized=True)
        else:
            rng = np.random.default_rng(syn.get("seed", 0))
            vecs = rng.normal(size=(syn["n"], syn["d"])).astype(np.float32)
            words = [f"word{i}" for i in range(syn["n"])]
            store = VectorStore.from_arrays(words, vecs)

    build = cfg.get_value_or("build", {})
    indexes = {}
    for name, loader in (("pq_index", PQIndex.load),
                         ("ivfadc_index", IVFADCIndex.load),
                         ("ivpq_index", IVPQIndex.load)):
        path = cfg.get_value_or(name, "")
        if path:
            indexes[name.split("_")[0]] = loader(path)

    if indexes.keys() >= {"pq", "ivfadc", "ivpq"}:
        return Freddy(store, pq=indexes["pq"], ivfadc=indexes["ivfadc"],
                      ivpq=indexes["ivpq"])
    eng = Freddy.build(
        store, seed=build.get("seed", 0),
        pq_m=build.get("pq_m", 12), pq_k=build.get("pq_k", 256),
        ivfadc_m=build.get("ivfadc_m", 12),
        ivfadc_k=build.get("ivfadc_k", 256),
        k_coarse=build.get("k_coarse", 1000),
        ivpq_m=build.get("ivpq_m", 30), ivpq_k=build.get("ivpq_k", 32),
        ivpq_k_coarse=build.get("ivpq_k_coarse", 32),
        ivpq_coarse_positions=build.get("ivpq_coarse_positions", 2),
        train_size=build.get("train_size", 100_000),
        iters=build.get("iters", 10),
        init=build.get("init", "sample"),
        restarts=build.get("restarts", 1),
        opq_iters=build.get("opq_iters", 0),
        with_pq=build.get("with_pq", True),
        with_ivfadc=build.get("with_ivfadc", True),
        with_ivpq=build.get("with_ivpq", True))
    for fam, idx in indexes.items():
        setattr(eng, fam, idx)
    return eng


def sample_words(engine: Freddy, count: int, seed: int = 0,
                 offset: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    n = engine.store.size
    ids = rng.choice(n - offset, size=min(count, n - offset),
                     replace=False) + offset
    return [engine.store.words[int(i)] for i in ids]

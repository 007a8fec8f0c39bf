import json
import time

import pytest

from postgres_word2vec.utils.config import (Configuration, Logger,
                                                init_compile_cache)
from postgres_word2vec.utils.tracker import Tracker
from postgres_word2vec.utils import profiling


def test_configuration(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"m": 12, "name": "x"}))
    cfg = Configuration(p)
    assert cfg.get_value("m") == 12
    assert cfg.get_value_or("missing", 7) == 7
    assert cfg.has_key("name") and not cfg.has_key("nope")
    with pytest.raises(KeyError):
        cfg.get_value("nope")


def test_logger_to_file(tmp_path):
    p = tmp_path / "log.txt"
    log = Logger(log_to_file=True, path=p)
    log.log("INFO", "hello world")
    log.close()
    text = p.read_text()
    assert "INFO: hello world" in text


def test_tracker_stages():
    t = Tracker()
    with t.stage("total_time"):
        time.sleep(0.01)
    t.track("retrieved", 42)
    res = t.get_results()
    assert res["total_time"][0] >= 0.01
    assert res["retrieved"] == [42.0]
    t.clear_track()
    assert t.get_results() == {}


def test_profiling_helpers(tmp_path):
    import jax.numpy as jnp

    with profiling.device_trace(tmp_path / "trace"):
        with profiling.annotate("unit-test-span"):
            jnp.ones((8, 8)).sum().block_until_ready()
    # trace directory created with profiler artifacts
    assert any((tmp_path / "trace").rglob("*"))
    stats = profiling.device_memory_stats()
    assert isinstance(stats, dict)


@pytest.mark.parametrize("env_set", [True, False])
def test_init_compile_cache(monkeypatch, tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set the helper leaves JAX's own
    setting alone; without it the cache goes to <repo>/.jax_cache."""
    import jax
    from pathlib import Path

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert init_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = init_compile_cache()
        repo = Path(__file__).resolve().parents[1]
        assert got == str(repo / ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", got)]

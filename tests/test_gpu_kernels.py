"""Compiled Triton kernels on the GPU against the XLA references.

Skipped on the CPU (marker ``gpu``). On a GPU host:
``PW2V_GPU_TESTS=1 python -m pytest tests/test_gpu_kernels.py -q``;
``chip_smoke.py`` runs this file in its own process before its main
phases. Interpret-mode twins of these checks are in ``test_pallas.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from postgres_word2vec.ops import adc, backend, topk
from postgres_word2vec.ops import pallas_kernels as pk

pytestmark = pytest.mark.gpu

REGIMES = [(12, 256, np.uint8), (60, 16, np.uint8), (30, 32, np.uint8),
           (12, 1024, np.int16)]


def _case(m, k, dt, n=70_001, B=37):
    rng = np.random.default_rng(m * 1000 + k)
    luts = jnp.asarray(rng.random((B, m, k)).astype(np.float32))
    codes = jnp.asarray(rng.integers(0, k, size=(n, m)).astype(dt))
    return luts, codes


def test_runs_compiled_on_gpu():
    assert jax.default_backend() == "gpu"
    assert backend.use_kernels()
    assert pk._interpret(None) is False


@pytest.mark.parametrize("m,k,dt", REGIMES)
@pytest.mark.parametrize("B", [1, 37])
def test_adc_scan_compiled_matches_xla(m, k, dt, B):
    luts, codes = _case(m, k, dt, B=B)
    want = np.asarray(adc.adc_distances(luts, codes))
    got = np.asarray(pk.adc_scan(luts, codes))
    # f32 LUT entries ≤ 1 summed in another order
    np.testing.assert_allclose(got, want, atol=m * 2e-6, rtol=0)


@pytest.mark.parametrize("m,k,dt", REGIMES)
def test_adc_binned_compiled_matches_dense(m, k, dt):
    luts, codes = _case(m, k, dt)
    dense = np.asarray(pk.adc_scan(luts, codes))
    mins, ids = map(np.asarray, pk.adc_scan_binned(luts, codes))
    fin = np.isfinite(mins)
    assert (ids[fin] < codes.shape[0]).all()
    np.testing.assert_array_equal(
        np.take_along_axis(dense, np.where(fin, ids, 0), -1)[fin],
        mins[fin])
    np.testing.assert_array_equal(mins.min(-1), dense.min(-1))


@pytest.mark.parametrize("m,k,dt", [(12, 256, np.uint8), (30, 32, np.uint8),
                                    (15, 1024, np.int32)])
def test_budget_adc_compiled_matches_xla(m, k, dt):
    rng = np.random.default_rng(1)
    bt, nt, B, P = 256, 40, 70, 12
    na = (nt + 1) * bt
    codes = jnp.asarray(rng.integers(0, k, size=(na, m)).astype(dt))
    rt = rng.random(na).astype(np.float32)
    rt[nt * bt:] = np.inf
    rt[5 * bt + 17:6 * bt] = np.inf
    rt = jnp.asarray(rt)
    luts = jnp.asarray(rng.random((B, m, k)).astype(np.float32))
    tiles = rng.integers(0, nt + 1, size=(B, P)).astype(np.int32)
    tiles = jnp.asarray(tiles)
    want = np.asarray(adc.budget_adc_xla(luts, codes, rt, tiles, block_t=bt))
    got = np.asarray(pk.budget_adc(luts, codes, rt, tiles, block_t=bt))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], atol=m * 2e-6, rtol=0)


def test_binned_top_k_recall_on_gpu():
    rng = np.random.default_rng(3)
    d = jnp.asarray(rng.random((64, 300_000)).astype(np.float32))
    _, want = jax.lax.top_k(-d, 10)
    vals, got = topk.top_k_smallest(d, 10, approx=True)
    hits = np.mean([len(set(a) & set(b)) / 10 for a, b in
                    zip(np.asarray(got).tolist(), np.asarray(want).tolist())])
    assert hits >= 0.9
    np.testing.assert_array_equal(
        np.take_along_axis(np.asarray(d), np.asarray(got), -1),
        np.asarray(vals))

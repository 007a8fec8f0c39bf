"""Triton ADC kernels in Pallas interpret mode against the XLA references,
plus a lowering of each kernel to Triton IR for the CUDA platform (what the
GPU compiles, checked here without a GPU). Compiled-on-GPU parity is in
``test_gpu_kernels.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from postgres_word2vec.ops import adc
from postgres_word2vec.ops import pallas_kernels as pk

# (m, k, code dtype): the PQ/IVFADC default, the 4-bit quality preset, the
# IVPQ fine codebook, and a 1024-centroid int16 table.
REGIMES = [(12, 256, np.uint8), (60, 16, np.uint8), (30, 32, np.uint8),
           (12, 1024, np.int16)]


def _tol(m):
    """Absolute bound for a sum of m f32 lookups of magnitude ≤ 1 taken in
    another order."""
    return m * 2e-6


def _case(rng, m, k, dt, n=1100, B=5):
    """N and B deliberately not multiples of any block size."""
    luts = rng.random((B, m, k)).astype(np.float32)
    codes = rng.integers(0, k, size=(n, m)).astype(dt)
    return jnp.asarray(luts), jnp.asarray(codes)


@pytest.mark.parametrize("m,k,dt", REGIMES)
@pytest.mark.parametrize("B", [1, 5])
def test_adc_scan_pallas_matches_gather_path(rng, m, k, dt, B):
    luts, codes = _case(rng, m, k, dt, B=B)
    want = np.asarray(adc.adc_distances(luts, codes))
    got = np.asarray(pk.adc_scan(luts, codes))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=_tol(m), rtol=0)


@pytest.mark.parametrize("m,k,dt", REGIMES)
def test_adc_binned_scan_interpret(rng, m, k, dt):
    """Every bin's survivor is its true minimum; ids point at rows whose
    distance equals it; bins past N are +inf."""
    luts, codes = _case(rng, m, k, dt)
    n = codes.shape[0]
    dense = np.asarray(pk.adc_scan(luts, codes))
    mins, ids = map(np.asarray, pk.adc_scan_binned(luts, codes))
    bb, w, sub = pk._block(5, binned=True)
    n_tiles = -(-n // (sub * w))
    assert mins.shape == ids.shape == (5, n_tiles * w)
    padded = np.full((5, n_tiles * sub * w), np.inf, np.float32)
    padded[:, :n] = dense
    want = padded.reshape(5, n_tiles, sub, w).min(axis=2).reshape(5, -1)
    np.testing.assert_array_equal(mins, want)
    fin = np.isfinite(mins)
    assert (ids[fin] < n).all()
    np.testing.assert_array_equal(np.take_along_axis(
        dense, np.where(fin, ids, 0), axis=-1)[fin], mins[fin])


@pytest.mark.parametrize("n", [300, 5000])
def test_adc_top_k_binned_wrapper(rng, n):
    """k=1 is the exact argmin; k beyond the survivors pads +inf / −1."""
    luts, codes = _case(rng, 6, 16, np.uint8, n=n)
    dense = np.asarray(pk.adc_scan(luts, codes))
    v1, i1 = pk.adc_top_k_binned(luts, codes, 1)
    np.testing.assert_array_equal(np.asarray(i1)[:, 0], dense.argmin(-1))
    bb, w, sub = pk._block(5, binned=True)
    survivors = min(n, -(-n // (sub * w)) * w)
    kk = survivors + 7
    vals, ids = map(np.asarray, pk.adc_top_k_binned(luts, codes, kk))
    assert vals.shape == (5, kk)
    assert np.isinf(vals[:, -7:]).all() and (ids[:, -7:] == -1).all()
    fin = np.isfinite(vals)
    for b in range(5):
        row = ids[b][fin[b]]
        assert len(set(row.tolist())) == len(row)
        assert (np.diff(vals[b][fin[b]]) >= 0).all()


@pytest.mark.parametrize("n,chunk", [(1024, 256), (1000, 256),
                                     (300, 4096)])
def test_adc_top_k_kernel_chunks_match_reference(rng, n, chunk):
    """Chunked exact top-k through the kernel: the clamped last chunk
    (n not a multiple of chunk) neither drops nor repeats rows."""
    luts, codes = _case(rng, 12, 256, np.uint8, n=n)
    dense = np.asarray(adc.adc_distances(luts, codes))
    vals, ids = adc.adc_top_k(luts, codes, 10, chunk_size=chunk,
                              use_kernel=True)
    np.testing.assert_array_equal(np.asarray(ids),
                                  np.argsort(dense, -1, kind="stable")[:, :10])
    np.testing.assert_allclose(np.asarray(vals),
                               np.sort(dense, -1)[:, :10], rtol=1e-6)


def test_adc_top_k_more_than_rows(rng):
    """k larger than the table: the tail is +inf with id −1, on both the
    kernel and the reference path."""
    luts, codes = _case(rng, 6, 16, np.uint8, n=40)
    for use_kernel in (False, True):
        vals, ids = map(np.asarray, adc.adc_top_k(luts, codes, 50,
                                                  use_kernel=use_kernel))
        assert np.isfinite(vals[:, :40]).all()
        assert np.isinf(vals[:, 40:]).all() and (ids[:, 40:] == -1).all()
        assert sorted(ids[0, :40].tolist()) == list(range(40))


def _budget_case(rng, m=6, k=32, block_t=128, nt=5, B=12, P=4,
                 dt=np.uint8):
    na = (nt + 1) * block_t
    codes = rng.integers(0, k, size=(na, m)).astype(dt)
    rowterm = rng.normal(size=(na,)).astype(np.float32)
    rowterm[2 * block_t + 100:3 * block_t] = np.inf   # padding in a tile
    rowterm[nt * block_t:] = np.inf                   # the inf tile
    luts = rng.random((B, m, k)).astype(np.float32)
    tiles = rng.integers(0, nt, size=(B, P)).astype(np.int32)
    tiles[3, 2] = nt                                  # unused slots
    tiles[7, :] = nt
    return (jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(rowterm),
            jnp.asarray(tiles), block_t)


@pytest.mark.parametrize("m,k,dt", [(6, 32, np.uint8), (12, 256, np.uint8),
                                    (3, 1024, np.int16)])
def test_budget_adc_interpret_matches_xla(rng, m, k, dt):
    luts, codes, rowterm, tiles, bt = _budget_case(rng, m=m, k=k, dt=dt)
    want = np.asarray(adc.budget_adc_xla(luts, codes, rowterm, tiles,
                                         block_t=bt))
    got = np.asarray(pk.budget_adc(luts, codes, rowterm, tiles, block_t=bt))
    assert got.shape == (12, 4 * bt)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert not fin[7].any()                           # all slots unused
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


def test_adc_distances_auto_cpu_fallback(rng):
    """The CPU backend takes the XLA reference; forcing the kernel runs it
    interpreted with the same result."""
    luts, codes = _case(rng, 4, 256, np.uint8, n=200)
    want = np.asarray(adc.adc_distances(luts, codes))
    np.testing.assert_array_equal(
        np.asarray(adc.adc_distances_auto(luts, codes)), want)
    np.testing.assert_allclose(
        np.asarray(adc.adc_distances_auto(luts, codes, True)), want,
        atol=1e-5)


@pytest.mark.parametrize("dt,k", [(np.uint8, 256), (np.int16, 1024)])
def test_narrow_code_dtypes_match_int32(rng, dt, k):
    """Codes are read in their storage dtype: a uint8/int16 table scores
    exactly like the same table widened to int32, dense and probed."""
    luts, codes = _case(rng, 5, k, dt, n=700)
    wide = codes.astype(jnp.int32)
    np.testing.assert_array_equal(np.asarray(pk.adc_scan(luts, codes)),
                                  np.asarray(pk.adc_scan(luts, wide)))
    luts, codes, rowterm, tiles, bt = _budget_case(rng, m=4, k=k, dt=dt)
    np.testing.assert_array_equal(
        np.asarray(pk.budget_adc(luts, codes, rowterm, tiles, block_t=bt)),
        np.asarray(pk.budget_adc(luts, codes.astype(jnp.int32), rowterm,
                                 tiles, block_t=bt)))


def _lower_for_cuda(fn, *specs):
    """Lower through the Triton route for CUDA on the CPU host: every
    Pallas lowering rule runs and the kernel becomes Triton IR inside a
    ``__gpu$xla.gpu.triton`` custom call."""
    exp = jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*specs)
    return exp.mlir_module()


S = jax.ShapeDtypeStruct
LOWERINGS = {
    "adc_12x256": (functools.partial(pk.adc_scan, interpret=False),
                   S((256, 12, 256), jnp.float32), S((3_072_000, 12),
                                                     jnp.uint8)),
    "adc_60x16_b1": (functools.partial(pk.adc_scan, interpret=False),
                     S((1, 60, 16), jnp.float32), S((3_072_000, 60),
                                                    jnp.uint8)),
    "adc_binned": (functools.partial(pk.adc_top_k_binned, k=10,
                                     interpret=False),
                   S((1024, 12, 1024), jnp.float32), S((3_072_000, 12),
                                                       jnp.int16)),
    "budget_adc": (functools.partial(pk.budget_adc, block_t=1024,
                                     interpret=False),
                   S((256, 12, 256), jnp.float32), S((4096 * 1024, 12),
                                                     jnp.uint8),
                   S((4096 * 1024,), jnp.float32), S((256, 16), jnp.int32)),
    "budget_adc_double": (functools.partial(pk.budget_adc, block_t=256,
                                            interpret=False),
                          S((1024, 15, 1024), jnp.float32),
                          S((400 * 256, 15), jnp.int32),
                          S((400 * 256,), jnp.float32),
                          S((1024, 16), jnp.int32)),
}


@pytest.mark.parametrize("name", sorted(LOWERINGS))
def test_kernel_lowers_for_cuda(name):
    fn, *specs = LOWERINGS[name]
    txt = _lower_for_cuda(fn, *specs)
    assert "__gpu$xla.gpu.triton" in txt

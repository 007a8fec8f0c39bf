"""Pallas kernels for the ADC hot loops, on the Triton route (NVIDIA GPU).

Two kernels, each the compiled twin of a plain-XLA reference in
``ops/adc.py``:

- :func:`adc_scan` / :func:`adc_scan_binned` — exhaustive ADC over an
  ``(N, m)`` code table: ``out[b, i] = Σ_j luts[b, j, codes[i, j]]`` (the
  ADC sum of ``pq_search``, freddy.c:117-132 / ``computePQDistanceInt16``,
  index_utils.c:1126-1133). The binned variant reduces each program's
  ``(bb, sub·w)`` distance tile to one survivor per strided bin in
  registers, so the ``(B, N)`` matrix never reaches device memory.
- :func:`budget_adc` — the selectivity-proportional probe behind IVFADC and
  the IVPQ join: each (query, slot) program loads its own tile id and scans
  only that tile of code rows.

Codes are read once per tile and every lookup is a gather from the f32 LUT,
which stays cache-resident (the Faiss-GPU shape, arXiv:1702.05911): exact
up to summation order. A one-hot tensor-core design (bf16 LUT × one-hot
code tile) and a raw-vector probe kernel were measured against these and
XLA on an H100 and lost; see PERF.md.

All kernels read codes in their storage dtype (uint8/int16) and mask the
ragged tails, so callers pass tables as they are: no padded or transposed
copies. ``interpret=None`` compiles for the GPU on a GPU backend and runs
Pallas interpret mode anywhere else (the CPU tests); which path a search
takes is decided in ``ops/backend.py``, not here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

Array = jax.Array

#: queries per program (at most; a smaller batch shrinks it), rows per
#: chunk, chunks per program in the dense scan
_BB, _W, _SUB = 16, 128, 8
#: binned scans keep one survivor per strided bin of this many rows
_BINNED_SUB = 16


def _interpret(flag: bool | None) -> bool:
    return jax.default_backend() != "gpu" if flag is None else flag


def _compiler_params(num_warps: int = 4, num_stages: int = 2):
    return plgpu.CompilerParams(num_warps=num_warps, num_stages=num_stages)


def _full2(x: Array, shape: tuple[int, int]) -> Array:
    return jnp.broadcast_to(x, shape)


def _adc_chunk(codes_ref, luts_ref, b0, n0, *, n: int, m: int, k: int,
               bb: int, w: int) -> Array:
    """ADC sums of queries ``[b0, b0+bb)`` over rows ``[n0, n0+w)`` →
    ``(bb, w)`` f32; rows at or past ``n`` come out +inf."""
    rows = n0 + jnp.arange(w, dtype=jnp.int32)
    valid = rows < n
    acc = jnp.zeros((bb, w), jnp.float32)
    bro = _full2((b0 + jnp.arange(bb, dtype=jnp.int32))[:, None], (bb, w))
    for j in range(m):
        c = plgpu.load(codes_ref.at[pl.ds(n0, w), j], mask=valid,
                       other=0).astype(jnp.int32)
        acc += luts_ref[bro, _full2((j * k + c)[None, :], (bb, w))]
    return jnp.where(valid[None, :], acc, jnp.inf)


def _adc_dense_kernel(codes_ref, luts_ref, out_ref, *, n, m, k, bb, w, sub):
    b0 = pl.program_id(0) * bb
    t0 = pl.program_id(1) * (sub * w)

    def body(s, carry):
        n0 = t0 + s * w
        acc = _adc_chunk(codes_ref, luts_ref, b0, n0, n=n, m=m, k=k, bb=bb,
                         w=w)
        cols = n0 + jnp.arange(w, dtype=jnp.int32)
        plgpu.store(out_ref.at[pl.ds(b0, bb), pl.ds(n0, w)], acc,
                    mask=_full2((cols < n)[None, :], (bb, w)))
        return carry

    lax.fori_loop(0, sub, body, 0)


def _adc_binned_kernel(codes_ref, luts_ref, mins_ref, ids_ref, *, n, m, k,
                       bb, w, sub):
    """Per program: ``sub`` chunks of ``w`` rows; bin ``j`` holds rows
    ``{t0 + s·w + j}``, reduced to its minimum and that row's global id."""
    b0 = pl.program_id(0) * bb
    t = pl.program_id(1)
    t0 = t * (sub * w)

    def body(s, carry):
        best, arg = carry
        acc = _adc_chunk(codes_ref, luts_ref, b0, t0 + s * w, n=n, m=m, k=k,
                         bb=bb, w=w)
        upd = acc < best
        return jnp.where(upd, acc, best), jnp.where(upd, s, arg)

    best, arg = lax.fori_loop(
        0, sub, body, (jnp.full((bb, w), jnp.inf, jnp.float32),
                       jnp.zeros((bb, w), jnp.int32)))
    lane = _full2(jnp.arange(w, dtype=jnp.int32)[None, :], (bb, w))
    mins_ref[pl.ds(b0, bb), pl.ds(t * w, w)] = best
    ids_ref[pl.ds(b0, bb), pl.ds(t * w, w)] = t0 + arg * w + lane


def _block(batch: int, binned: bool) -> tuple[int, int, int]:
    """(queries, rows, chunks) per program: the query block shrinks to the
    batch (a single query runs 1 × w tiles)."""
    bb = min(_BB, 1 << max(batch - 1, 0).bit_length())
    return bb, _W, (_BINNED_SUB if binned else _SUB)


def _prep_luts(luts: Array, bb: int) -> Array:
    """Pad the query batch to ``bb`` and flatten to ``(Bp, m·k)`` f32."""
    B, m, k = luts.shape
    pad_b = (-B) % bb
    lf = luts.astype(jnp.float32)
    if pad_b:
        lf = jnp.pad(lf, ((0, pad_b), (0, 0), (0, 0)))
    return lf.reshape(B + pad_b, m * k)


@functools.partial(jax.jit, static_argnames=("interpret",))
def adc_scan(luts: Array, codes: Array, *,
             interpret: bool | None = None) -> Array:
    """Dense ADC distances ``(B, m, k) × (N, m) → (B, N)`` float32."""
    B, m, k = luts.shape
    n = codes.shape[0]
    bb, w, sub = _block(B, binned=False)
    lf = _prep_luts(luts, bb)
    out = pl.pallas_call(
        functools.partial(_adc_dense_kernel, n=n, m=m, k=k, bb=bb, w=w,
                          sub=sub),
        out_shape=jax.ShapeDtypeStruct((lf.shape[0], n), jnp.float32),
        grid=(lf.shape[0] // bb, -(-n // (sub * w))),
        backend="triton", compiler_params=_compiler_params(),
        interpret=_interpret(interpret), name="adc_scan",
    )(codes, lf)
    return out[:B]


@functools.partial(jax.jit, static_argnames=("interpret",))
def adc_scan_binned(luts: Array, codes: Array, *,
                    interpret: bool | None = None) -> tuple[Array, Array]:
    """Binned ADC scan → ``(mins, ids)``, each ``(B, n_tiles·w)``: one
    survivor per strided bin of ``sub`` rows (the partial reduction of an
    approximate top-k, fused into the scan). Bins past ``N`` are +inf."""
    B, m, k = luts.shape
    n = codes.shape[0]
    bb, w, sub = _block(B, binned=True)
    lf = _prep_luts(luts, bb)
    n_tiles = -(-n // (sub * w))
    shape = (lf.shape[0], n_tiles * w)
    mins, ids = pl.pallas_call(
        functools.partial(_adc_binned_kernel, n=n, m=m, k=k, bb=bb, w=w,
                          sub=sub),
        out_shape=(jax.ShapeDtypeStruct(shape, jnp.float32),
                   jax.ShapeDtypeStruct(shape, jnp.int32)),
        grid=(lf.shape[0] // bb, n_tiles),
        backend="triton", compiler_params=_compiler_params(),
        interpret=_interpret(interpret), name="adc_scan_binned",
    )(codes, lf)
    return mins[:B], ids[:B]


@functools.partial(jax.jit, static_argnames=("k", "interpret"))
def adc_top_k_binned(luts: Array, codes: Array, k: int, *,
                     interpret: bool | None = None) -> tuple[Array, Array]:
    """Approximate exhaustive ADC top-k: binned scan, then an exact top-k
    over the survivors (the global minimum always survives). Slots past
    the number of finite survivors hold +inf and id −1."""
    mins, ids = adc_scan_binned(luts, codes, interpret=interpret)
    kk = min(k, mins.shape[1])
    neg, pos = lax.top_k(-mins, kk)
    vals = -neg
    sel = jnp.where(jnp.isinf(vals), -1,
                    jnp.take_along_axis(ids, pos, axis=-1))
    if kk < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        sel = jnp.pad(sel, ((0, 0), (0, k - kk)), constant_values=-1)
    return vals, sel


def _budget_adc_kernel(tiles_ref, codes_ref, rt_ref, luts_ref, out_ref, *,
                       m: int, k: int, bt: int):
    """One (query, slot) program: ADC sums over the slot's tile of ``bt``
    code rows plus the row term (+inf on padding rows)."""
    b = pl.program_id(0)
    p = pl.program_id(1)
    r0 = tiles_ref[b, p] * bt
    acc = rt_ref[pl.ds(r0, bt)]
    bro = jnp.full((bt,), b, jnp.int32)
    for j in range(m):
        c = codes_ref[pl.ds(r0, bt), j].astype(jnp.int32)
        acc += luts_ref[bro, j * k + c]
    out_ref[b, pl.ds(p * bt, bt)] = acc


@functools.partial(jax.jit, static_argnames=("block_t", "interpret"))
def budget_adc(luts: Array, codes: Array, rowterm: Array, tiles: Array, *,
               block_t: int, interpret: bool | None = None) -> Array:
    """Budgeted tile-gather ADC → ``(B, P·block_t)`` float32: query ``b``
    scans the ``P`` tiles ``tiles[b]`` of ``block_t`` rows each.

    ``codes`` is the row-major ``(NA, m)`` cell-aligned table (NA a
    multiple of ``block_t``; one trailing all-padding tile absorbs unused
    slots) and ``rowterm`` its ``(NA,)`` additive term, +inf on padding
    rows. Cost is the B·P probed tiles, not ``w × max_cell`` padding (the
    reference fetches only probed cells' rows through SPI,
    freddy.c:325-338 / ivpq_search_in.c:355-401)."""
    B, m, k = luts.shape
    na = codes.shape[0]
    if na % block_t:
        raise ValueError(f"NA={na} not a multiple of block_t={block_t}")
    P = tiles.shape[1]
    return pl.pallas_call(
        functools.partial(_budget_adc_kernel, m=m, k=k, bt=block_t),
        out_shape=jax.ShapeDtypeStruct((B, P * block_t), jnp.float32),
        grid=(B, P), backend="triton", compiler_params=_compiler_params(),
        interpret=_interpret(interpret), name="budget_adc",
    )(tiles.astype(jnp.int32), codes, rowterm.astype(jnp.float32),
      luts.astype(jnp.float32).reshape(B, m * k))

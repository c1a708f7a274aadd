"""Launching wrapper of the band-staged average pooling in ``csrc/avgpool.cu``.

Replaces ``repro/kernels/avgpool/kernel.py::avgpool_call``.  The source
note in ``avgpool.cu`` says what bounds the kernel and how a block stages
its band and walks it.  How the planes are cut into bands and column tiles,
and how a block's threads share a band, is decided here, in
``avgpool_plan``, from the shapes alone, so the wrapper reads nothing back
from the device and the CPU tests can reach it.  The library builds at
first use (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import build, dtypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P] + [_I] * 11 + [_P]
SMEM_BUDGET = 32 * 1024     # bytes a block stages when the plan picks
SMEM_MAX = 227 * 1024       # a block's dynamic shared memory on the H100
MAX_THREADS = 256           # a block's threads (the kernel's launch bound)
MIN_FULL_ROWS = 4           # a full-width band must hold this many rows
TILE_ROWS = 16              # band height of a column-tiled plan
MIN_GROUP_ROWS = 8          # output rows a thread group walks, at least
BAND_SWEEP = (4, 8, 16, 24, 32, 48, 64)     # band heights a tuning sweeps


@dataclass(frozen=True)
class AvgpoolPlan:
    """A block takes a band of ``rows`` output rows (``bands`` a plane, the
    last one ragged) and a tile of ``cols`` output columns (``tiles`` a
    row; ``full``: one tile of the whole width, the band one contiguous
    span of the plane).  Its ``tx`` × ``groups`` threads take columns
    ``j, j + tx, ...`` (``cols_per_thread`` of them) and ``group_rows`` rows
    each.  ``smem``: bytes of input and output staged; ``grid``: (bands ×
    tiles, planes, capped at 65535 and strided past)."""
    rows: int
    bands: int
    cols: int
    tiles: int
    full: bool
    tx: int
    groups: int
    group_rows: int
    cols_per_thread: int
    smem: int
    grid: tuple


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def _row_step(span: int, width: int, ve: int) -> int:
    """The least pitch that holds a row's ``span`` staged from its 16-byte
    line and agrees with ``width`` modulo ``ve``: each staged row then sits
    at its own offset within 16 bytes (``avgpool.cu``'s ``row_step``)."""
    least = span + ve - 1
    return least + (width - least) % ve


def _smem_bytes(rows: int, cols: int, full: bool, w: int, ow: int, kh: int,
                kw: int, itemsize: int) -> int:
    """Shared memory of a block: the staged input band and the output band,
    rows stepping by W and OW for the full width, else by ``_row_step``
    pitches; ``avgpool.cu``'s ``stage_of`` computes the same."""
    ve = 16 // itemsize
    in_step = w if full else _row_step(cols + kw - 1, w, ve)
    out_step = ow if full else _row_step(cols, ow, ve)
    xs = _round_up((rows + kh - 1) * in_step + ve - 1, ve)
    ys = _round_up(rows * out_step + ve - 1, ve)
    return (xs + ys) * itemsize


def _tallest(fits, most: int) -> int:
    """The largest r in [1, most] with fits(r) (fits falls as r grows), or
    0 where none fits."""
    lo, hi = 0, most
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def avgpool_plan(n: int, c: int, h: int, w: int, kh: int, kw: int,
                 itemsize: int, rows: int = 0) -> AvgpoolPlan:
    """The cut of a pooling call, from its shapes alone.  A band spans the
    whole width where ``MIN_FULL_ROWS`` rows of it fit ``SMEM_BUDGET``;
    else the plane is cut into column tiles (multiples of 32 outputs, a
    kw − 1 halo each) whose ``TILE_ROWS``-row bands fit.  The band is the
    tallest that fits the budget, then evened out over the bands a plane
    needs; ``rows`` forces a band height (up to ``SMEM_MAX``: the plans
    sweep), taking column tiles where a whole row's band would not fit.  A
    block has up to ``MAX_THREADS`` threads: a warp-multiple across the
    tile's columns, then groups of at least ``MIN_GROUP_ROWS`` rows.  Raises
    ``ValueError`` for a window whose band cannot fit a block's shared
    memory."""
    oh, ow = h - kh + 1, w - kw + 1
    if oh < 1 or ow < 1 or kh < 1 or kw < 1:
        raise ValueError(f"avgpool_plan: window {kh}x{kw} does not fit "
                         f"{h}x{w}")

    def smem(r, cols):
        return _smem_bytes(r, cols, cols >= ow, w, ow, kh, kw, itemsize)

    limit = SMEM_MAX if rows else SMEM_BUDGET
    cols = ow
    if smem(min(oh, MIN_FULL_ROWS), ow) > SMEM_BUDGET or \
            smem(min(oh, rows), ow) > limit:
        tile_rows = min(oh, rows or TILE_ROWS)
        widest = _tallest(lambda k: smem(tile_rows, 32 * k) <= limit,
                          _cdiv(ow, 32))
        tiles = _cdiv(ow, 32 * max(1, widest))
        cols = min(ow, _round_up(_cdiv(ow, tiles), 32))
    if rows:
        band = min(rows, oh)
    else:
        band = _tallest(lambda r: smem(r, cols) <= limit, oh)
        band = _cdiv(oh, _cdiv(oh, max(1, band)))
    if band < 1 or smem(band, cols) > SMEM_MAX:
        raise ValueError(f"avgpool_plan: a band of the {kh}x{kw} window over "
                         f"{h}x{w} needs more than a block's shared memory")
    full = cols >= ow
    tiles = 1 if full else _cdiv(ow, cols)
    bands = _cdiv(oh, band)
    tx = min(MAX_THREADS, _round_up(cols, 32))
    groups = max(1, min(MAX_THREADS // tx, band // MIN_GROUP_ROWS))
    group_rows = _cdiv(band, groups)
    groups = _cdiv(band, group_rows)
    planes = n * c
    return AvgpoolPlan(band, bands, cols, tiles, full, tx, groups, group_rows,
                       _cdiv(cols, tx), smem(band, cols),
                       (bands * tiles, max(1, min(planes, 65535))))


def avgpool_cuda(x: torch.Tensor, kh: int = 3, kw: int = 3, *,
                 rows: int = 0) -> torch.Tensor:
    """Stride-1 VALID kh×kw mean.  x: (N, C, H, W) in float32, bfloat16
    or float16, contiguous, on a CUDA device → (N, C, H-kh+1, W-kw+1) in
    x's dtype; each input row's kw taps summed in f32, then the kh row
    sums, divided, then rounded once.  The cut comes from ``avgpool_plan``;
    ``rows`` forces its band height (the plans sweep and the card tests)."""
    if not x.is_cuda:
        raise ValueError("avgpool_cuda wants x on a CUDA device")
    sfx = dtypes.suffix("avgpool_cuda", x)
    if x.dim() != 4:
        raise ValueError(f"avgpool_cuda wants (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("avgpool_cuda wants a contiguous x")
    n, c, h, w = x.shape
    if not (1 <= kh <= h and 1 <= kw <= w):
        raise ValueError(f"avgpool_cuda: window {kh}x{kw} does not fit "
                         f"{h}x{w}")
    p = avgpool_plan(n, c, h, w, kh, kw, x.element_size(), rows)
    y = torch.empty(n, c, h - kh + 1, w - kw + 1, dtype=x.dtype,
                    device=x.device)
    name = f"sol_avgpool_{sfx}"
    lib, fn = build.entry("avgpool", name, _ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), n, c, h, w, kh, kw, p.rows, p.cols,
             p.tx, p.groups, p.group_rows,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, name)
    avgpool_cuda.launches += 1
    return y


avgpool_cuda.launches = 0

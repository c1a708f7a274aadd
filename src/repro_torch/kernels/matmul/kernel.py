"""Launching wrapper of the matrix products in ``csrc/matmul.cu``, in
float32, bfloat16 and float16.

Replaces ``repro/kernels/matmul/kernel.py::matmul_call`` with a
tensor-core kernel for the large products (3xTF32 ``wgmma`` for f32, the
16-bit ``wgmma`` for bf16 and f16) and a bandwidth-bound kernel for the
skinny ones (M or N up to ``SKINNY``).  The accumulator is
f32 and the output is rounded once to the operands' dtype.  The source
note in ``matmul.cu`` says what bounds each and how it is built.  Which
kernel runs, with which split of K, grid and copy width, is decided here,
in ``plan``, from the shapes, the strides, the element size and the
pointers' alignment, so the CPU tests can reach it.  The library builds at
first use (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from .. import build, dtypes

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TC_ARGS = [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _I, _I, _I, _P]
_SKINNY_ARGS = [_P, _L, _L, _I, _P, _L, _L, _I, _P, _P, _L, _L, _I, _I, _I,
                _I, _I, _I, _I, _I, _I, _P]

SM_COUNT = 132
SKINNY = 16             # M or N up to which the skinny kernel runs
TC_TILE = (128, 128, 32)    # BM, BN, BK of the f32 tensor-core kernel
TC_BK_16BIT = 64            # BK of the bf16 and f16 one
TC_MIN_K_CHUNK = 256    # K per split of the tensor-core kernel, at least
SKINNY_ROWS = (1, 2, 4, 8, 16)  # the small operand's rows, padded
SKINNY_S_FLOATS = 8192  # the small operand's K range in shared memory
SKINNY_BLOCKS = 8 * SM_COUNT    # skinny blocks in flight, at most
# K per split of the skinny kernel, at least: a K-contiguous operand is
# read 128 floats a warp step, a column-contiguous one a row per warp
SKINNY_MIN_K_CHUNK = {True: 256, False: 64}


@dataclass(frozen=True)
class Plan:
    """How one product runs.  ``kernel`` is ``"tensor_core"`` or
    ``"skinny"``; ``vec`` the values per copy: 16 bytes (4 f32 or 8 bf16 or
    f16 values), 4 bytes (1 or 2) or, for bf16 and f16, 2 bytes (1);
    K is cut in ``splits`` chunks of ``k_chunk``; the grid is ``grid``.
    Tensor core: ``b_kmajor`` reads w K-contiguous (an (out,in) weight).
    Skinny: ``small`` is the operand held in shared memory (``"x"``, or
    ``"w"`` for N <= SKINNY, which runs as the transposed product),
    ``rows`` its rows padded to one of ``SKINNY_ROWS``, and
    ``big_kmajor`` says whether the streamed operand is K-contiguous."""
    kernel: str
    vec: int
    splits: int
    k_chunk: int
    grid: Tuple[int, int]
    b_kmajor: bool = False
    small: str = ""
    rows: int = 0
    big_kmajor: bool = False


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _unit(stride: int, size: int) -> bool:
    return stride == 1 or size == 1


def _vec(ptr: int, row_stride: int, rows: int, itemsize: int) -> int:
    """Values per copy of an operand whose rows run along the copies: 16
    bytes where the base and, with more than one row, the row stride
    (in elements) are 16-byte aligned, else 4 bytes where they are 4-byte
    aligned, else one value."""
    for nbytes in (16, 4):
        if ptr % nbytes == 0 and (rows == 1
                                  or row_stride * itemsize % nbytes == 0):
            return nbytes // itemsize
    return 1


def plan(m: int, n: int, k: int, lda: int, ldb_k: int, ldb_n: int,
         x_ptr: int = 0, w_ptr: int = 0, sms: int = SM_COUNT,
         itemsize: int = 4) -> Plan:
    """The launch plan of x (M, K; row stride ``lda``, unit column stride)
    @ w (K, N; element (k, n) at ``k*ldb_k + n*ldb_n``) with x and w at
    the addresses ``x_ptr`` and ``w_ptr`` and elements of ``itemsize``
    bytes (4 for float32, 2 for bfloat16 and float16).  w must be K- or
    N-contiguous.
    """
    return _plan(m, n, k, lda, ldb_k, ldb_n, x_ptr % 16, w_ptr % 16, sms,
                 itemsize)


@functools.lru_cache(maxsize=4096)
def _plan(m, n, k, lda, ldb_k, ldb_n, x_mod, w_mod, sms, itemsize) -> Plan:
    w_nmajor, w_kmajor = _unit(ldb_n, n), _unit(ldb_k, k)
    if not (w_nmajor or w_kmajor):
        raise ValueError(f"matmul: w needs a unit stride along K or N, got "
                         f"strides ({ldb_k}, {ldb_n})")
    # an N-contiguous w is read so where its stride is really 1
    b_kmajor = w_kmajor and not (ldb_n == 1 and n > 1)
    w_row_stride, w_rows = (ldb_n, n) if b_kmajor else (ldb_k, k)
    if m <= SKINNY or n <= SKINNY:
        return _skinny_plan(m, n, k, lda, b_kmajor, w_row_stride, w_rows,
                            x_mod, w_mod, sms, itemsize)
    bm, bn, bk = TC_TILE
    if itemsize == 2:
        bk = TC_BK_16BIT
    vec = min(_vec(x_mod, lda, m, itemsize),
              _vec(w_mod, w_row_stride, w_rows, itemsize))
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    splits = 1
    if tiles < sms:             # tiles alone leave SMs idle: split K
        splits = max(1, min(sms // tiles, k // TC_MIN_K_CHUNK))
    k_chunk = max(bk, _cdiv(_cdiv(k, splits), bk) * bk)
    splits = max(1, _cdiv(k, k_chunk))
    return Plan("tensor_core", vec, splits, k_chunk, (tiles, splits),
                b_kmajor=b_kmajor)


def _skinny_plan(m, n, k, lda, b_kmajor, w_row_stride, w_rows, x_mod,
                 w_mod, sms, itemsize) -> Plan:
    if m <= SKINNY:             # x in shared memory, w streamed
        small, rows, cols, big_kmajor = "x", m, n, b_kmajor
        vec = _vec(w_mod, w_row_stride, w_rows, itemsize)
    else:                       # C^T = w^T x^T: w in shared memory
        small, rows, cols, big_kmajor = "w", n, m, True
        vec = _vec(x_mod, lda, m, itemsize)
    r_pad = next(r for r in SKINNY_ROWS if r >= rows)
    # columns per block step: 8 warps of 1-4 columns each on K-contiguous
    # L (2 below 8 rows for 16-byte loads of 2-byte values), else 32 lanes
    # of ``vec`` columns each
    cpw = 4 if r_pad >= 16 else 2 if (r_pad >= 8 or vec > 4) else 1
    per_group = 8 * cpw if big_kmajor else 32 * vec
    groups = max(1, _cdiv(cols, per_group))
    kc_max = SKINNY_S_FLOATS // r_pad
    splits = _cdiv(k, kc_max) if k else 1      # S's K range must fit
    if groups < sms:            # the columns alone leave SMs idle: split K
        splits = max(splits, min(_cdiv(2 * sms, groups),
                                 k // SKINNY_MIN_K_CHUNK[big_kmajor]))
    step = 32 if big_kmajor else 8     # K per lane step, or per 8 warps
    k_chunk = min(kc_max, max(step, _cdiv(_cdiv(k, splits), step) * step))
    splits = max(1, _cdiv(k, k_chunk))
    grid_x = max(1, min(groups, _cdiv(SKINNY_BLOCKS, splits)))
    return Plan("skinny", vec, splits, k_chunk, (grid_x, splits),
                small=small, rows=r_pad, big_kmajor=big_kmajor)


class _Count:
    """Launches of one kernel: a run reads it to show it went through the
    kernel."""

    def __init__(self) -> None:
        self.launches = 0


KERNELS = {"tensor_core": _Count(), "skinny": _Count()}


def matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) → (M, N) on the card, x and w of one dtype
    (float32, bfloat16 or float16), accumulated in f32 and rounded once to
    that dtype.  ``x`` must have a unit column stride.  ``w`` is read in
    place where it has a unit stride along K (a transposed (N, K) weight)
    or along N; a view with neither (a strided slice) is made contiguous
    first."""
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("matmul_cuda wants x and w on one CUDA device")
    sfx = dtypes.suffix("matmul_cuda", x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_cuda wants (M,K) @ (K,N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if not _unit(x.stride(1), x.shape[1]):
        raise ValueError("matmul_cuda wants x with unit column stride")
    m, k = x.shape
    n = w.shape[1]
    if not (_unit(w.stride(0), k) or _unit(w.stride(1), n)):
        w = w.contiguous()
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    if m == 0 or n == 0:
        return out
    lda, ldb_k, ldb_n = x.stride(0), w.stride(0), w.stride(1)
    p = plan(m, n, k, lda, ldb_k, ldb_n, x.data_ptr(), w.data_ptr(),
             itemsize=x.element_size())
    ws = (torch.empty((p.splits, m, n), device=x.device, dtype=torch.float32)
          if p.splits > 1 else None)
    ws_ptr = ws.data_ptr() if ws is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p.kernel == "tensor_core":
        what = f"sol_matmul_tc_{sfx}"
        lib, fn = build.entry("matmul", what, _TC_ARGS)
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), ws_ptr, m, n, k,
                 lda, ldb_n if p.b_kmajor else ldb_k, int(p.b_kmajor), p.vec,
                 p.splits, p.k_chunk, p.grid[0], stream)
    else:
        if p.small == "x":      # S = x (M rows), L = w (N columns)
            s_args = (x.data_ptr(), lda, 1, m)
            l_args = (w.data_ptr(), ldb_n, ldb_k, n)
            o_strides = (n, 1)
        else:                   # S = w^T (N rows), L = x (M columns)
            s_args = (w.data_ptr(), ldb_n, ldb_k, n)
            l_args = (x.data_ptr(), lda, 1, m)
            o_strides = (1, n)
        what = f"sol_matmul_skinny_{sfx}"
        lib, fn = build.entry("matmul", what, _SKINNY_ARGS)
        err = fn(*s_args, *l_args, out.data_ptr(), ws_ptr, *o_strides, m, n,
                 k, p.rows, p.vec, int(p.big_kmajor), p.splits, p.k_chunk,
                 p.grid[0], stream)
    build.check(lib, err, what)
    KERNELS[p.kernel].launches += 1
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0

"""Launching wrapper of the chunked RWKV6 WKV scan in ``csrc/rwkv6_scan.cu``.

Replaces ``repro/kernels/rwkv6_scan/kernel.py::rwkv6_scan_call``.  The
source note in ``rwkv6_scan.cu`` says what bounds the kernel and how its
three passes cut T into chunks.  The chunks, the staged tile and the f32
workspace are decided here, in ``rwkv6_plan``, from the shapes alone, so
the wrapper reads nothing back from the device and the CPU tests can
reach it.  The library builds at first use (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import build, dtypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] + [_P] * 4 + [_I] * 8 + [_P]
MAX_HEAD_DIM = 128      # one thread per state column, the column in registers
SM_COUNT = 132          # H100 SXM, when no card is given
BLOCKS_PER_SM = 4       # chunk blocks the plan aims at
STEP = 16               # chunks and staged tiles are multiples of this
MAX_CHUNK = 48          # steps of a chunk where T has several, at most
STAGE_BYTES = 20 << 10  # shared memory of one staged tile, at most


@dataclass(frozen=True)
class Rwkv6Plan:
    """Chunk c of every (sequence, head) takes steps ``[c * chunk,
    (c + 1) * chunk)`` and stages them ``tile`` steps at a time in
    ``smem`` bytes of shared memory (the output pass's; the chunk-state
    pass takes less), with ``threads`` threads, one per state column
    (the head dim rounded up to 32, 64 or 128).  ``grid`` is the output
    pass's (chunks, H, B); the chunk-state pass takes the first
    ``chunks - 1``.  ``workspace``: f32 values of the chunk states and
    decays, (B, H, chunks - 1, hd, hd) and (B, H, chunks - 1, hd)."""
    chunk: int
    chunks: int
    tile: int
    threads: int
    smem: int
    grid: tuple
    workspace: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def head_threads(hd: int) -> int:
    """Threads of a block: one per state column, 32, 64 or 128."""
    return next(n for n in (32, 64, 128) if hd <= n)


def stage_bytes(tile: int, threads: int) -> int:
    """Shared memory of the output pass, f32: r, k and exp(w) rows of
    ``tile`` steps (``threads`` + 16 values each, the source's
    RowLayout), v rows (``threads`` values) and the steps' bonus, then
    u."""
    return 4 * (tile * (3 * (threads + 16) + threads + 1) + threads)


def max_tile(hd: int) -> int:
    """The most steps one block stages at once: a multiple of ``STEP``,
    at most ``MAX_CHUNK``, in ``STAGE_BYTES``."""
    n = head_threads(hd)
    per_step = 3 * (n + 16) + n + 1
    fit = STEP * ((STAGE_BYTES // 4 - n) // per_step // STEP)
    return max(STEP, min(MAX_CHUNK, fit))


def rwkv6_plan(b: int, t: int, h: int, hd: int, itemsize: int,
               sm_count: int = SM_COUNT) -> Rwkv6Plan:
    """The chunks of a scan call, from its shapes alone.  One chunk where
    B·H alone fills ``BLOCKS_PER_SM`` blocks per SM or T fits one staged
    tile; else the longest chunk (a multiple of ``STEP``, at most
    ``MAX_CHUNK``) with which B·H·chunks blocks fill them, and ``STEP``
    where even that does not.  A chunk longer than a tile is staged a
    tile at a time.  Every step lies in exactly one chunk.  The staged
    rows are f32 in every storage type, so ``itemsize`` changes only the
    loads, not the plan."""
    n = head_threads(hd)
    cap = max_tile(hd)
    want = BLOCKS_PER_SM * max(1, sm_count)
    if b * h >= want or t <= cap:
        chunk = max(t, 1)
    else:
        chunk = max(STEP, min(MAX_CHUNK, STEP * (t * b * h // want // STEP)))
    chunks = max(1, _cdiv(t, chunk))
    tile = min(cap, STEP * _cdiv(chunk, STEP))
    return Rwkv6Plan(chunk, chunks, tile, n, stage_bytes(tile, n),
                     (chunks, h, b), b * h * (chunks - 1) * hd * (hd + 1))


def rwkv6_scan_cuda(r, k, v, logw, u, s0, *, sm_count: int = 0):
    """r, k, v, logw: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd); all
    contiguous, on one CUDA device, hd ≤ 128.  r, k, v, logw and u share
    one dtype (float32, bfloat16 or float16); s0 is in it or in float32 →
    (o (B, T, H, hd) in r's dtype, s_last (B, H, hd, hd) float32): the
    state is f32 throughout, as the JAX kernel's.  The chunks come from
    ``rwkv6_plan`` with the card's SM count, or ``sm_count`` where it is
    given (the tests force one chunk and many that way)."""
    ts = (r, k, v, logw, u, s0)
    if not all(t.is_cuda and t.device == r.device for t in ts):
        raise ValueError("rwkv6_scan_cuda wants every operand on one CUDA "
                         "device")
    sfx = dtypes.suffix("rwkv6_scan_cuda", r, k, v, logw, u)
    s0_f32 = s0.dtype == torch.float32
    if not s0_f32 and s0.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan_cuda takes s0 in {r.dtype} or "
                        f"float32, got {s0.dtype}")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan_cuda wants (B,T,H,hd), got "
                         f"{tuple(r.shape)}")
    bsz, t_len, h, hd = r.shape
    if any(t.shape != r.shape for t in (k, v, logw)) or \
            u.shape != (h, hd) or s0.shape != (bsz, h, hd, hd):
        raise ValueError(f"rwkv6_scan_cuda: incompatible shapes "
                         f"{[tuple(t.shape) for t in ts]}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan_cuda takes hd ≤ {MAX_HEAD_DIM}, "
                         f"got {hd}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rwkv6_scan_cuda wants contiguous operands")
    size = r.element_size()
    p = rwkv6_plan(bsz, t_len, h, hd, size,
                   sm_count or build.sm_count(r.device))
    o = torch.empty_like(r)
    s_last = torch.empty_like(s0, dtype=torch.float32)
    ws = torch.empty(p.workspace, device=r.device, dtype=torch.float32)
    dec = ws[bsz * h * (p.chunks - 1) * hd * hd:]
    # 16-byte loads and stores of a step's hd values
    vec = (hd * size) % 16 == 0 and all(x.data_ptr() % 16 == 0
                                        for x in (r, k, v, logw, o))
    name = f"sol_rwkv6_scan_{sfx}"
    lib, fn = build.entry("rwkv6_scan", name, _ARGTYPES)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
             u.data_ptr(), s0.data_ptr(), int(s0_f32), o.data_ptr(),
             s_last.data_ptr(), ws.data_ptr(), dec.data_ptr(), bsz, t_len, h,
             hd, p.chunk, p.chunks, p.tile, int(vec),
             torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, err, name)
    rwkv6_scan_cuda.launches += 1
    return o, s_last


rwkv6_scan_cuda.launches = 0

"""Launching wrapper of the chunked RG-LRU scan in ``csrc/rglru_scan.cu``.

Replaces ``repro/kernels/rglru_scan/kernel.py::rglru_scan_call``.  The
source note in ``rglru_scan.cu`` says what bounds the kernel and how a
block splits T across its warps.  How the channels and T are cut is
decided here, in ``rglru_plan``, from the shapes alone, so the wrapper
reads nothing back from the device and the CPU tests can reach it.  The
library builds at first use (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import build, dtypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P]
SM_COUNT = 132          # H100 SXM, when no card is given
# blocks the plan aims at: at Griffin's shapes 2 a SM give rows of 8 lanes
# (128 bytes in f32), which read faster than 4 a SM at 4 lanes on the H100
BLOCKS_PER_SM = 2
VEC = 4                 # channels a thread takes: one 16-byte load in f32
CHUNK = 8               # steps a thread holds in registers and walks
LANES = (32, 16, 8, 4)  # channel lanes of a warp, widest first
MAX_CHUNKS = 16         # chunks a tile holds (one per warp at 32 lanes)


@dataclass(frozen=True)
class RglruPlan:
    """A block takes ``channels`` (= ``lanes`` · VEC) channels of one
    sequence and walks T in tiles of ``chunks`` chunks of ``chunk`` steps:
    each warp holds 32 / ``lanes`` chunks side by side, ``warps`` warps a
    block.  ``grid`` is (channel blocks, B)."""
    chunk: int
    lanes: int
    chunks: int
    warps: int
    channels: int
    grid: tuple


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rglru_plan(b: int, t: int, d: int, itemsize: int,
               sm_count: int = SM_COUNT) -> RglruPlan:
    """The cut of a scan call, from its shapes alone: the widest warp of
    channel lanes (coalesced rows of lanes · 4 · ``itemsize`` bytes) whose
    blocks still fill ``BLOCKS_PER_SM`` per SM, else the narrowest; as
    many chunks of ``CHUNK`` steps a tile as T needs, at most
    ``MAX_CHUNKS``, rounded up to whole warps.  Every step lies in exactly
    one chunk of one tile."""
    want = BLOCKS_PER_SM * max(1, sm_count)
    lanes = next((n for n in LANES if _cdiv(d, n * VEC) * b >= want),
                 LANES[-1])
    per_warp = 32 // lanes
    need = min(MAX_CHUNKS, max(1, _cdiv(t, CHUNK)))
    warps = _cdiv(need, per_warp)
    return RglruPlan(CHUNK, lanes, warps * per_warp, warps, lanes * VEC,
                     (_cdiv(d, lanes * VEC), b))


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
                    sm_count: int = 0):
    """h_t = a_t·h_{t-1} + b_t.  a, b: (B, T, D); h0: (B, D); all of one
    dtype (float32, bfloat16 or float16), contiguous, on one CUDA device →
    (h (B, T, D), h_last (B, D)) in that dtype, the state held in f32.
    The cut comes from ``rglru_plan`` with the card's SM count, or
    ``sm_count`` where it is given (the tests force wide and narrow warps
    that way)."""
    ts = (a, b, h0)
    if not all(t.is_cuda and t.device == a.device for t in ts):
        raise ValueError("rglru_scan_cuda wants a, b, h0 on one CUDA device")
    sfx = dtypes.suffix("rglru_scan_cuda", *ts)
    if a.dim() != 3 or b.shape != a.shape or \
            h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan_cuda wants a, b (B,T,D) and h0 (B,D), "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rglru_scan_cuda wants contiguous operands")
    bsz, t_len, d = a.shape
    size = a.element_size()
    p = rglru_plan(bsz, t_len, d, size,
                   sm_count or build.sm_count(a.device))
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    # one load of VEC values a thread: rows of D values keep every
    # thread's VEC channels aligned when the bases are
    vec = d % VEC == 0 and all(x.data_ptr() % (VEC * size) == 0
                               for x in (a, b, h, h_last))
    name = f"sol_rglru_scan_{sfx}"
    lib, fn = build.entry("rglru_scan", name, _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
             h_last.data_ptr(), bsz, t_len, d, p.chunk, p.lanes, p.chunks,
             int(vec), torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, name)
    rglru_scan_cuda.launches += 1
    return h, h_last


rglru_scan_cuda.launches = 0

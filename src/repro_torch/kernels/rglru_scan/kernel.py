"""Launching wrapper of the RG-LRU scan in ``csrc/rglru_scan.cu``.

Replaces ``repro/kernels/rglru_scan/kernel.py::rglru_scan_call``.  The
source note in ``rglru_scan.cu`` says what bounds the kernel and how its
threads map to channels.  The library builds at first use
(``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build, dtypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 3 + [_P]


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t·h_{t-1} + b_t.  a, b: (B, T, D); h0: (B, D); all of one
    dtype (float32, bfloat16 or float16), contiguous, on one CUDA device →
    (h (B, T, D), h_last (B, D)) in that dtype, the state held in f32."""
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
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    name = f"sol_rglru_scan_{sfx}"
    lib, fn = build.entry("rglru_scan", name, _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
             h_last.data_ptr(), bsz, t_len, d,
             torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, name)
    rglru_scan_cuda.launches += 1
    return h, h_last


rglru_scan_cuda.launches = 0

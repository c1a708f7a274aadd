"""Launching wrapper of the RWKV6 WKV scan in ``csrc/rwkv6_scan.cu``.

Replaces ``repro/kernels/rwkv6_scan/kernel.py::rwkv6_scan_call``.  The
source note in ``rwkv6_scan.cu`` says what bounds the kernel and why each
thread keeps one column of the state.  The library builds at first use
(``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build, dtypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I, _P, _P] + [_I] * 4 + [_P]
MAX_HEAD_DIM = 128      # one thread per state column, the column in registers


def rwkv6_scan_cuda(r, k, v, logw, u, s0):
    """r, k, v, logw: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd); all
    contiguous, on one CUDA device, hd ≤ 128.  r, k, v, logw and u share
    one dtype (float32, bfloat16 or float16); s0 is in it or in float32 →
    (o (B, T, H, hd) in r's dtype, s_last (B, H, hd, hd) float32): the
    state is f32 throughout, as the JAX kernel's."""
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
    o = torch.empty_like(r)
    s_last = torch.empty_like(s0, dtype=torch.float32)
    name = f"sol_rwkv6_scan_{sfx}"
    lib, fn = build.entry("rwkv6_scan", name, _ARGTYPES)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
             u.data_ptr(), s0.data_ptr(), int(s0_f32), o.data_ptr(),
             s_last.data_ptr(), bsz, t_len, h, hd,
             torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, err, name)
    rwkv6_scan_cuda.launches += 1
    return o, s_last


rwkv6_scan_cuda.launches = 0

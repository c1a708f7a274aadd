"""Launching wrapper of the decode attention in
``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention/kernel.py::decode_attention_call``.
The kernel reads the node's model-layout operands through their strides;
see the source note for its design.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build, dtypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 5 + [_L] * 12 + [_I, ctypes.c_float, _P]
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16          # query heads per kv head the shared memory holds


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          lens: torch.Tensor, *, window: int = 0,
                          cap: float = 0.0) -> torch.Tensor:
    """q (B,1,H,hd); cache k, v (B,S,KV,hd); k_new, v_new (B,1,KV,hd), all
    of one dtype (float32, bfloat16 or float16); lens (B,) int32 →
    (B,1,H,hd) in q's dtype, on the card; the softmax and accumulator are
    f32."""
    fl = (q, k, v, k_new, v_new)
    if not all(t.is_cuda and t.device == q.device for t in fl + (lens,)):
        raise ValueError("decode_attention_cuda wants every operand on one "
                         "CUDA device")
    sfx = dtypes.suffix("decode_attention_cuda", *fl)
    if lens.dtype != torch.int32 or lens.dim() != 1 or not \
            lens.is_contiguous():
        raise TypeError("decode_attention_cuda wants contiguous int32 lens")
    if any(t.dim() != 4 for t in fl):
        raise ValueError("decode_attention_cuda wants 4-d operands")
    b, one, h, hd = q.shape
    _, s, kv, _ = k.shape
    if one != 1 or k.shape != v.shape or k_new.shape != (b, 1, kv, hd) \
            or v_new.shape != (b, 1, kv, hd) or k.shape[0] != b \
            or k.shape[3] != hd or lens.shape[0] != b or h % kv:
        raise ValueError(f"incompatible decode shapes q {tuple(q.shape)}, "
                         f"cache {tuple(k.shape)}, new "
                         f"{tuple(k_new.shape)}, lens {tuple(lens.shape)}")
    if hd not in HEAD_DIMS or h // kv > MAX_GROUP:
        raise ValueError(f"decode_attention_cuda takes hd in {HEAD_DIMS} "
                         f"and at most {MAX_GROUP} query heads per kv head")
    if any(t.stride(3) != 1 for t in fl):
        raise ValueError("decode_attention_cuda wants a unit stride along hd")
    o = torch.empty((b, 1, h, hd), device=q.device, dtype=q.dtype)
    name = f"sol_decode_attention_{sfx}"
    lib, fn = build.entry("decode_attention", name, _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), lens.data_ptr(), o.data_ptr(), b, s, h, kv, hd,
             q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
             k_new.stride(0), k_new.stride(2), v_new.stride(0),
             v_new.stride(2), int(window), float(cap),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, name)
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0

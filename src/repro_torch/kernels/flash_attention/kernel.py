"""Launching wrapper of the flash-attention forward in
``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_call``.
The kernel reads the node's BSHD tensors through their strides (the JAX
wrapper transposes to BHSD first), with 16-byte copies where every base
and row stride is 16-byte aligned; see the source note for its design.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build, dtypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = ([_P] * 4 + [_I] * 5 + [_L] * 12
             + [_I, _I, ctypes.c_float, _I, _I, _P])
HEAD_DIMS = (16, 32, 64, 128)
BLOCK_Q = 64            # query rows a block: 4 warps of 16
BLOCK_QS = (64, 32)     # the instances the source holds (4 and 2 warps)


def flash_smem_bytes(hd: int, itemsize: int, block_q: int = BLOCK_Q) -> int:
    """Shared memory of a block: the Q tile and two stages of K and V
    tiles of 64 keys (16-bit types) or 32 (f32), rows padded by 16 bytes
    (``flash_attention.cu``'s ``launch``)."""
    bkv = 64 if itemsize == 2 else 32
    return itemsize * (hd + 16 // itemsize) * (block_q + 4 * bkv)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         cap: float = 0.0,
                         block_q: int = BLOCK_Q) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) → (B, S, H, hd), on the card,
    all of one dtype (float32, bfloat16 or float16); the scores, softmax
    and accumulator are f32, the products run on the tensor cores (16-bit
    operands; 3xTF32 in f32).  Every operand needs a unit stride along
    hd.  ``block_q``: query rows a block, one of ``BLOCK_QS``."""
    ts = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("flash_attention_cuda wants q, k, v on one CUDA "
                         "device")
    sfx = dtypes.suffix("flash_attention_cuda", *ts)
    if any(t.dim() != 4 for t in ts) or k.shape != v.shape:
        raise ValueError("flash_attention_cuda wants q (B,S,H,hd) and k, v "
                         "(B,S,KV,hd)")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd or h % kv:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda has no kernel for head "
                         f"dim {hd}; it takes {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("flash_attention_cuda wants a unit stride along hd")
    if block_q not in BLOCK_QS:
        raise ValueError(f"flash_attention_cuda takes block_q in "
                         f"{BLOCK_QS}, got {block_q}")
    o = torch.empty((b, s, h, hd), device=q.device, dtype=q.dtype)
    size = q.element_size()
    vec = all(t.data_ptr() % 16 == 0
              and all((st * size) % 16 == 0 for st in t.stride()[:3])
              for t in ts)
    name = f"sol_flash_attention_{sfx}"
    lib, fn = build.entry("flash_attention", name, _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
             h, kv, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *o.stride()[:3], int(bool(causal)), int(window), float(cap),
             int(block_q), int(vec),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, name)
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0

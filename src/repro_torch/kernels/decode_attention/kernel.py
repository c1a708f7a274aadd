"""Launching wrapper of the split-KV decode attention in
``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention/kernel.py::decode_attention_call``.
The kernels read the node's model-layout operands through their strides;
see the source note for the design.  How the cache is cut into splits is
decided here, in ``decode_plan``, from the shapes alone, so the wrapper
reads nothing back from the device and the CPU tests can reach it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import build, dtypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = ([_P] * 8 + [_I] * 7 + [_L] * 12
             + [_I, ctypes.c_float, _I, _P])
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16          # query heads per kv head a block's warps take
MAX_SPLITS = 128        # splits the combine kernel merges, at most
SM_COUNT = 132          # H100 SXM, when no card is given
BLOCKS_PER_SM = 2       # split blocks the plan aims at


@dataclass(frozen=True)
class DecodePlan:
    """Split s of every (sequence, kv head) reads cache rows
    ``[s * chunk, (s + 1) * chunk)``; ``grid`` is the split kernel's
    (splits, KV, B)."""
    splits: int
    chunk: int
    grid: tuple


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_rows(hd: int, itemsize: int) -> int:
    """Cache rows one warp of the split kernel walks per tile: eight steps
    of 32 lanes, each row taking hd * itemsize / 16 lanes (16-byte loads)."""
    return 8 * 32 // max(1, hd * itemsize // 16)


def decode_plan(b: int, kv: int, cache: int, hd: int, itemsize: int,
                sm_count: int = SM_COUNT) -> DecodePlan:
    """Splits and chunk of a decode call, from its shapes alone: enough
    splits that B·KV·splits blocks fill ``BLOCKS_PER_SM`` per SM, each
    chunk a multiple of one warp tile (``tile_rows``) and at least one, at
    most ``MAX_SPLITS`` splits; every cache row lies in exactly one
    chunk."""
    rows = tile_rows(hd, itemsize)
    want = max(1, _cdiv(BLOCKS_PER_SM * max(1, sm_count), max(1, b * kv)))
    chunk = rows * max(1, _cdiv(_cdiv(max(cache, 1), want), rows))
    chunk = max(chunk, rows * _cdiv(_cdiv(max(cache, 1), MAX_SPLITS), rows))
    splits = max(1, _cdiv(cache, chunk))
    return DecodePlan(splits, chunk, (splits, kv, b))


def _aligned(t: torch.Tensor, dims) -> bool:
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(d) * size) % 16 == 0 or t.shape[d] == 1 for d in dims)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          lens: torch.Tensor, *, window: int = 0,
                          cap: float = 0.0, sm_count: int = 0
                          ) -> torch.Tensor:
    """q (B,1,H,hd); cache k, v (B,S,KV,hd); k_new, v_new (B,1,KV,hd), all
    of one dtype (float32, bfloat16 or float16); lens (B,) int32 →
    (B,1,H,hd) in q's dtype, on the card; the softmax, partials and
    accumulator are f32.  The splits come from ``decode_plan`` with the
    card's SM count, or ``sm_count`` where it is given (the tests force
    one split and many that way)."""
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
    p = decode_plan(b, kv, s, hd, q.element_size(),
                    sm_count or build.sm_count(q.device))
    o = torch.empty((b, 1, h, hd), device=q.device, dtype=q.dtype)
    ws = torch.empty(b * kv * p.splits * (h // kv) * (hd + 2),
                     device=q.device, dtype=torch.float32)
    vec = _aligned(q, (0, 2)) and _aligned(k, (0, 1, 2)) \
        and _aligned(v, (0, 1, 2))
    name = f"sol_decode_attention_{sfx}"
    lib, fn = build.entry("decode_attention", name, _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), lens.data_ptr(), o.data_ptr(), ws.data_ptr(),
             b, s, h, kv, hd, p.splits, p.chunk, q.stride(0), q.stride(2),
             *k.stride()[:3], *v.stride()[:3], k_new.stride(0),
             k_new.stride(2), v_new.stride(0), v_new.stride(2), int(window),
             float(cap), int(vec),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, name)
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0

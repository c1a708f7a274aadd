"""Every kernel family as a ``torch.library`` custom op, so that
``torch.export`` can trace a lowered graph that runs the hand-written
kernels (``frontends/deploy.py``).

One op a family, in the namespace ``repro_torch``.  Each op's body calls
the family's public entry in its ``ops.py``, the one the live impl calls:
a CUDA tensor launches the kernel (or the wrapper raises), a CPU tensor
takes the plain version.  Every pinned ``Tunable`` config and every node
attribute the impl reads is an explicit argument, so an exported graph
carries its elected configs as literals.  A DFP ``Program`` travels as one
``str``, its ``key()`` in JSON (``program.program_to_str``).

Each op returns fresh, contiguous tensors: a custom op may not hand back a
view of its input, and the fake impls (``register_fake``), which give the
shapes and dtypes export traces with, describe contiguous outputs.

The impls call these ops only while ``torch.compiler.is_exporting()``;
the live path keeps its direct calls, since a custom op's dispatch costs
more than the direct call on every launch.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch

from .avgpool import ops as _avgpool
from .decode_attention import ops as _decode
from .dfp_fused import ops as _dfp
from .dfp_fused.program import Program, program_from_str
from .flash_attention import ops as _flash
from .matmul import ops as _matmul
from .rglru_scan import ops as _rglru
from .rwkv6_scan import ops as _rwkv6

Tensor = torch.Tensor


def _fresh(outs: Sequence[Tensor], ins: Sequence[Tensor]) -> List[Tensor]:
    """``outs`` contiguous, each one copied where it shares storage with an
    input or an earlier output (a plain version may return a view)."""
    seen = {t.untyped_storage().data_ptr() for t in ins}
    fresh = []
    for o in outs:
        o = o.contiguous()
        ptr = o.untyped_storage().data_ptr()
        if ptr in seen:
            o = o.clone()
            ptr = o.untyped_storage().data_ptr()
        seen.add(ptr)
        fresh.append(o)
    return fresh


def _empty(like: Tensor, shape, dtype=None) -> Tensor:
    return like.new_empty(tuple(shape), dtype=dtype or like.dtype)


# -- matmul ------------------------------------------------------------------

@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def matmul(x: Tensor, w: Tensor, splits: int) -> Tensor:
    """``kernels/matmul/ops.py::matmul``: x (..., K) @ w (K, N)."""
    return _fresh([_matmul.matmul(x, w, splits=splits)], [x, w])[0]


@matmul.register_fake
def _(x, w, splits):
    return _empty(x, (*x.shape[:-1], w.shape[-1]))


# -- flash attention -----------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    window: int, cap: float, block_q: int) -> Tensor:
    """``kernels/flash_attention/ops.py::flash_attention``, model layout."""
    o = _flash.flash_attention(q, k, v, causal=causal, window=window,
                               cap=cap, block_q=block_q)
    return _fresh([o], [q, k, v])[0]


@flash_attention.register_fake
def _(q, k, v, causal, window, cap, block_q):
    return _empty(q, q.shape)


# -- decode attention ----------------------------------------------------------

@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention(q: Tensor, k: Tensor, v: Tensor, k_new: Tensor,
                     v_new: Tensor, lens: Tensor, window: int, cap: float,
                     splits: int) -> Tensor:
    """``kernels/decode_attention/ops.py::decode_attention``."""
    o = _decode.decode_attention(q, k, v, k_new, v_new, lens, window=window,
                                 cap=cap, splits=splits)
    return _fresh([o], [q, k, v, k_new, v_new, lens])[0]


@decode_attention.register_fake
def _(q, k, v, k_new, v_new, lens, window, cap, splits):
    return _empty(q, q.shape)


# -- DFP fused chains ----------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _program(text: str) -> Program:
    """The decoded program of an op argument, one per distinct string, so
    the kernel cache (keyed on ``Program.key()``) finds its kernel."""
    return program_from_str(text)


@torch.library.custom_op("repro_torch::dfp_fused", mutates_args=())
def dfp_fused(operands: List[Tensor], program: str, block_rows: int,
              max_group: int) -> Tensor:
    """``kernels/dfp_fused/ops.py::dfp_fused``, or ``dfp_fused_segmented``
    where ``max_group`` cuts the program."""
    prog = _program(program)
    if max_group and max_group < len(prog.instrs):
        out = _dfp.dfp_fused_segmented(prog, operands, max_group,
                                       block_rows=block_rows)
    else:
        out = _dfp.dfp_fused(prog, operands, block_rows=block_rows)
    return _fresh([out], operands)[0]


@dfp_fused.register_fake
def _(operands, program, block_rows, max_group):
    kinds = _program(program).operand_kinds
    full = next(o for o, k in zip(operands, kinds) if k == "full")
    return _empty(full, full.shape)


# -- the scans -----------------------------------------------------------------

@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def rglru_scan(a: Tensor, b: Tensor, h0: Tensor, lanes: int,
               chunks: int) -> Tuple[Tensor, Tensor]:
    """``kernels/rglru_scan/ops.py::rglru_scan`` → (h, h_last)."""
    h, h_last = _rglru.rglru_scan(a, b, h0, lanes=lanes, chunks=chunks)
    h, h_last = _fresh([h, h_last], [a, b, h0])
    return h, h_last


@rglru_scan.register_fake
def _(a, b, h0, lanes, chunks):
    return _empty(a, a.shape), _empty(a, h0.shape)


@torch.library.custom_op("repro_torch::rwkv6_scan", mutates_args=())
def rwkv6_scan(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
               s0: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """``kernels/rwkv6_scan/ops.py::rwkv6_scan`` → (o, s_last f32)."""
    o, s_last = _rwkv6.rwkv6_scan(r, k, v, logw, u, s0, chunk=chunk)
    o, s_last = _fresh([o, s_last], [r, k, v, logw, u, s0])
    return o, s_last


@rwkv6_scan.register_fake
def _(r, k, v, logw, u, s0, chunk):
    return _empty(r, r.shape), _empty(r, s0.shape, torch.float32)


# -- average pooling -----------------------------------------------------------

@torch.library.custom_op("repro_torch::avgpool", mutates_args=())
def avgpool(x: Tensor, kh: int, kw: int, rows: int) -> Tensor:
    """``kernels/avgpool/ops.py::avgpool`` (NCHW, stride 1, VALID)."""
    return _fresh([_avgpool.avgpool(x, kh, kw, rows=rows)], [x])[0]


@avgpool.register_fake
def _(x, kh, kw, rows):
    n, c, h, w = x.shape
    return _empty(x, (n, c, h - kh + 1, w - kw + 1))


# the op of each family, by family name
OPS = {"matmul": matmul, "flash_attention": flash_attention,
       "decode_attention": decode_attention, "dfp_fused": dfp_fused,
       "rglru_scan": rglru_scan, "rwkv6_scan": rwkv6_scan,
       "avgpool": avgpool}

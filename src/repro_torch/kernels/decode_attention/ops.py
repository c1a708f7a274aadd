"""Public entry + dispatch-table entries for DECODE_ATTENTION.

The node carries six model-layout operands — q (B,1,H,hd), the cache k, v
(B,S,KV,hd), the step's k_new, v_new (B,1,KV,hd) and lens (B,) int32 — and
produces (B,1,H,hd).  ``cuda.decode_attention`` sits at the shared tier
gated on ``"cuda"``; ``ref.decode_attention`` is the reference tier.  The
kernel takes q, the cache and the step's pair in float32, bfloat16 or
float16, one dtype (``kernels/dtypes.py``); ``supports`` refuses other
dtypes visibly.

The impl declares a ``Tunable`` over the split-KV cut of
``kernel.decode_plan``: a config ``(splits,)`` is pinned as
``node.attrs['cuda_decode_block']``."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ...backends import registry
from ...core.autotune import Tunable
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import (HEAD_DIMS, MAX_GROUP, MAX_SPLITS, decode_attention_cuda,
                     decode_plan)
from .ref import decode_attention_ref

ATTR = "cuda_decode_block"


def _ref_model_layout(q, k, v, k_new, v_new, lens, window, cap):
    o = decode_attention_ref(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                             k_new[:, 0], v_new[:, 0], lens, window=window,
                             cap=cap)
    return o[:, None]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     lens: torch.Tensor, *, window: int = 0,
                     cap: float = 0.0, splits: int = 0) -> torch.Tensor:
    """Model-layout decode attention.  A CPU tensor takes the plain version;
    a CUDA tensor the kernel, cut in ``splits`` where a tuned config asks
    for them."""
    if q.device.type == "cpu":
        return _ref_model_layout(q, k, v, k_new, v_new, lens, window, cap)
    return decode_attention_cuda(q, k, v, k_new, v_new, lens, window=window,
                                 cap=cap, splits=splits)


def _attrs(n: Node) -> dict:
    return dict(window=n.attrs.get("window", 0), cap=n.attrs.get("cap", 0.0))


def node_plan(n: Node, hw, splits: int = 0):
    """``decode_plan`` at a node's shapes on ``hw``."""
    b, _one, _h, hd = n.spec.shape
    _, cache, kv, _ = n.inputs[1].spec.shape
    return decode_plan(b, kv, cache, hd,
                       2 if n.spec.dtype != "float32" else 4, hw.sms, splits)


def decode_tune_space(n: Node, hw) -> List[Tuple[int]]:
    """Split counts around the plan's own: 1, half, the plan's and twice
    it, at most ``MAX_SPLITS``; the configs are the distinct counts the
    plan makes of them (its chunks stay whole warp tiles)."""
    p = node_plan(n, hw)
    want = {1, max(1, p.splits // 2), p.splits,
            min(MAX_SPLITS, 2 * p.splits)}
    return [(s,) for s in sorted({node_plan(n, hw, w).splits for w in want})]


def decode_refine_space(n: Node, hw, cfg) -> List[Tuple[int]]:
    """Half and twice the winning split count, as the plan makes them."""
    s = int(cfg[0])
    return [(node_plan(n, hw, c).splits,) for c in (max(1, s // 2), 2 * s)]


def _decode_cuda_impl(n: Node, vals: Sequence[torch.Tensor],
                      backend: "registry.Backend") -> torch.Tensor:
    cfg = n.attrs.get(ATTR)
    return decode_attention(*vals, **_attrs(n),
                            splits=int(cfg[0]) if cfg else 0)


def _decode_ref_impl(n: Node, vals: Sequence[torch.Tensor],
                     backend: "registry.Backend") -> torch.Tensor:
    a = _attrs(n)
    return _ref_model_layout(*vals, a["window"], a["cap"])


def _supports(n: Node) -> bool:
    if len(n.spec.shape) != 4 or len(n.inputs) != 6 \
            or not same_float(n, n.inputs[:5]):
        return False
    h, hd = n.spec.shape[2], n.spec.shape[3]
    kv = n.inputs[1].spec.shape[2]
    return hd in HEAD_DIMS and h // kv <= MAX_GROUP


registry.register_shared_impl(
    OpKind.DECODE_ATTENTION, _decode_cuda_impl,
    name="cuda.decode_attention", requires=("cuda",), supports=_supports,
    tunable=Tunable(ATTR, decode_tune_space, refine=decode_refine_space))
registry.register_reference_impl(
    OpKind.DECODE_ATTENTION, _decode_ref_impl, name="ref.decode_attention",
    memory="roundtrip")   # materializes the (B, H, S) score rows

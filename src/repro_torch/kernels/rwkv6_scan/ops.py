"""Public entry + dispatch-table entries of the RWKV6 WKV scan kernel.

``cuda.rwkv6_scan`` sits at the shared tier gated on ``"cuda"``, where
``pallas.rwkv6_scan`` sits in the JAX package; ``ref.rwkv6_scan`` is the
reference tier.  The RWKV6_SCAN node takes (r, k, v, logw, u, s0) and
yields the per-token output o.  ``supports`` admits rank-4 nodes in
float32, bfloat16 or float16 whose inputs share the node's dtype
(``kernels/dtypes.py``), with a head dim the kernel keeps in registers
(≤ 128); any other node elects the reference tier visibly, in
``impl_report``.

The impl declares a ``Tunable`` over the chunk of ``kernel.rwkv6_plan``: a
config ``(chunk,)`` is pinned as ``node.attrs['cuda_rwkv6_block']``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ...backends import registry
from ...core.autotune import Tunable
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import MAX_CHUNK, MAX_HEAD_DIM, STEP, rwkv6_plan, \
    rwkv6_scan_cuda
from .ref import rwkv6_scan_ref

ATTR = "cuda_rwkv6_block"


def rwkv6_scan(r, k, v, logw, u, s0, *, chunk: int = 0):
    """r, k, v, logw: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) →
    (o, s_last).  A CPU tensor takes the plain version; a CUDA tensor the
    kernel, in chunks of ``chunk`` steps where a tuned config gives it."""
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, logw, u, s0)
    return rwkv6_scan_cuda(*(t.contiguous() for t in (r, k, v, logw, u, s0)),
                           chunk=chunk)


def node_plan(n: Node, hw, chunk: int = 0):
    """``rwkv6_plan`` at a node's shapes on ``hw``."""
    b, t, h, hd = n.spec.shape
    return rwkv6_plan(b, t, h, hd, 2 if n.spec.dtype != "float32" else 4,
                      hw.sms, chunk)


def rwkv6_tune_space(n: Node, hw) -> List[Tuple[int]]:
    """The plan's chunk and every multiple of ``STEP`` up to ``MAX_CHUNK``
    shorter than T, each whose output pass stages within
    ``hw.smem_bytes``; the configs are the distinct chunks."""
    t = n.spec.shape[1]
    plans = [node_plan(n, hw)] + [node_plan(n, hw, c)
                                  for c in range(STEP, MAX_CHUNK + 1, STEP)
                                  if c < t]
    return sorted({(p.chunk,) for p in plans if p.smem <= hw.smem_bytes})


def rwkv6_refine_space(n: Node, hw, cfg) -> List[Tuple[int]]:
    """Half and twice the winning chunk, as the plan makes them (a
    multiple of ``STEP`` up to ``MAX_CHUNK``, or all of T)."""
    c = int(cfg[0])
    plans = [node_plan(n, hw, x) for x in (max(1, c // 2), 2 * c)]
    return [(p.chunk,) for p in plans if p.smem <= hw.smem_bytes]


def _rwkv6_impl(n: Node, vals: Sequence[torch.Tensor],
                backend: "registry.Backend") -> torch.Tensor:
    cfg = n.attrs.get(ATTR)
    chunk = int(cfg[0]) if cfg else 0
    if torch.compiler.is_exporting():
        from ..library import rwkv6_scan as op
        return op(*vals, chunk)[0]
    return rwkv6_scan(*vals, chunk=chunk)[0]


def _rwkv6_ref_impl(n: Node, vals: Sequence[torch.Tensor],
                    backend: "registry.Backend") -> torch.Tensor:
    return rwkv6_scan_ref(*vals)[0]


def _supports(n: Node) -> bool:
    return (len(n.spec.shape) == 4 and n.spec.shape[-1] <= MAX_HEAD_DIM
            and same_float(n))


registry.register_shared_impl(
    OpKind.RWKV6_SCAN, _rwkv6_impl, name="cuda.rwkv6_scan",
    requires=("cuda",), supports=_supports,
    tunable=Tunable(ATTR, rwkv6_tune_space, refine=rwkv6_refine_space))
registry.register_reference_impl(
    OpKind.RWKV6_SCAN, _rwkv6_ref_impl, name="ref.rwkv6_scan")

"""Public entry + dispatch-table entries of the RWKV6 WKV scan kernel.

``cuda.rwkv6_scan`` sits at the shared tier gated on ``"cuda"``, where
``pallas.rwkv6_scan`` sits in the JAX package; ``ref.rwkv6_scan`` is the
reference tier.  The RWKV6_SCAN node takes (r, k, v, logw, u, s0) and
yields the per-token output o.  ``supports`` admits rank-4 nodes in
float32, bfloat16 or float16 whose inputs share the node's dtype
(``kernels/dtypes.py``), with a head dim the kernel keeps in registers
(≤ 128); any other node elects the reference tier visibly, in
``impl_report``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...backends import registry
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import MAX_HEAD_DIM, rwkv6_scan_cuda
from .ref import rwkv6_scan_ref


def rwkv6_scan(r, k, v, logw, u, s0):
    """r, k, v, logw: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) →
    (o, s_last).  A CPU tensor takes the plain version; a CUDA tensor the
    kernel."""
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, logw, u, s0)
    return rwkv6_scan_cuda(*(t.contiguous() for t in (r, k, v, logw, u, s0)))


def _rwkv6_impl(n: Node, vals: Sequence[torch.Tensor],
                backend: "registry.Backend") -> torch.Tensor:
    return rwkv6_scan(*vals)[0]


def _rwkv6_ref_impl(n: Node, vals: Sequence[torch.Tensor],
                    backend: "registry.Backend") -> torch.Tensor:
    return rwkv6_scan_ref(*vals)[0]


def _supports(n: Node) -> bool:
    return (len(n.spec.shape) == 4 and n.spec.shape[-1] <= MAX_HEAD_DIM
            and same_float(n))


registry.register_shared_impl(
    OpKind.RWKV6_SCAN, _rwkv6_impl, name="cuda.rwkv6_scan",
    requires=("cuda",), supports=_supports)
registry.register_reference_impl(
    OpKind.RWKV6_SCAN, _rwkv6_ref_impl, name="ref.rwkv6_scan")

"""Public entry + dispatch-table entries of the RG-LRU scan kernel.

``cuda.rglru_scan`` sits at the shared tier gated on ``"cuda"``, where
``pallas.rglru_scan`` sits in the JAX package; ``ref.rglru_scan`` is the
reference tier.  The RGLRU_SCAN node takes (a, b, h0) and yields the whole
hidden sequence h.  The kernel takes float32, bfloat16 and float16
(``kernels/dtypes.py``); ``supports`` refuses other dtypes, so such a node
elects the reference tier visibly, in ``impl_report``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...backends import registry
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import rglru_scan_cuda
from .ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t·h_{t-1} + b_t.  a, b: (B, T, D); h0: (B, D) → (h, h_last).
    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    return rglru_scan_cuda(a.contiguous(), b.contiguous(), h0.contiguous())


def _rglru_impl(n: Node, vals: Sequence[torch.Tensor],
                backend: "registry.Backend") -> torch.Tensor:
    return rglru_scan(*vals)[0]


def _rglru_ref_impl(n: Node, vals: Sequence[torch.Tensor],
                    backend: "registry.Backend") -> torch.Tensor:
    return rglru_scan_ref(*vals)[0]


def _supports(n: Node) -> bool:
    return len(n.spec.shape) == 3 and same_float(n)


registry.register_shared_impl(
    OpKind.RGLRU_SCAN, _rglru_impl, name="cuda.rglru_scan",
    requires=("cuda",), supports=_supports)
registry.register_reference_impl(
    OpKind.RGLRU_SCAN, _rglru_ref_impl, name="ref.rglru_scan")

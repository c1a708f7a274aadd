"""Public entry + dispatch-table entries for ATTENTION.

``cuda.flash_attention`` sits at the shared tier gated on ``"cuda"`` (where
``pallas.flash_attention`` sits in the JAX package); ``ref.attention`` is
the reference tier, which materializes the S×S scores ("roundtrip").  The
kernel takes float32, bfloat16 and float16 (``kernels/dtypes.py``);
``supports`` refuses other dtypes visibly."""
from __future__ import annotations

from typing import Sequence

import torch

from ...backends import registry
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import HEAD_DIMS, flash_attention_cuda
from .ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    cap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) → (B, S, H, hd).  A CPU tensor
    takes the plain version; a CUDA tensor the kernel."""
    if q.device.type == "cpu":
        o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, cap=cap)
        return o.transpose(1, 2)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                cap=cap)


def _attrs(n: Node) -> dict:
    return dict(causal=n.attrs.get("causal", True),
                window=n.attrs.get("window", 0),
                cap=n.attrs.get("cap", 0.0))


def _attention_cuda_impl(n: Node, vals: Sequence[torch.Tensor],
                         backend: "registry.Backend") -> torch.Tensor:
    q, k, v = vals
    return flash_attention(q, k, v, **_attrs(n))


def _attention_ref_impl(n: Node, vals: Sequence[torch.Tensor],
                        backend: "registry.Backend") -> torch.Tensor:
    q, k, v = vals
    o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), **_attrs(n))
    return o.transpose(1, 2)


def _supports(n: Node) -> bool:
    return (len(n.spec.shape) == 4 and same_float(n)
            and n.spec.shape[-1] in HEAD_DIMS)


registry.register_shared_impl(
    OpKind.ATTENTION, _attention_cuda_impl, name="cuda.flash_attention",
    requires=("cuda",), supports=_supports)
registry.register_reference_impl(
    OpKind.ATTENTION, _attention_ref_impl, name="ref.attention",
    memory="roundtrip")

"""Public entry + dispatch-table entries for ATTENTION.

``cuda.flash_attention`` sits at the shared tier gated on ``"cuda"`` (where
``pallas.flash_attention`` sits in the JAX package); ``ref.attention`` is
the reference tier, which materializes the S×S scores ("roundtrip").  The
kernel takes float32, bfloat16 and float16 (``kernels/dtypes.py``);
``supports`` refuses other dtypes visibly.

The impl declares a ``Tunable`` over the query rows a block: a config
``(block_q,)`` is pinned as ``node.attrs['cuda_attn_block']`` and picks one
of the source's instances (``kernel.BLOCK_QS``) whose shared memory fits a
block on the backend's card."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ...backends import registry
from ...core.autotune import Tunable
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import (BLOCK_Q, BLOCK_QS, HEAD_DIMS, flash_attention_cuda,
                     flash_smem_bytes)
from .ref import flash_attention_ref

ATTR = "cuda_attn_block"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    cap: float = 0.0, block_q: int = BLOCK_Q) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) → (B, S, H, hd).  A CPU tensor
    takes the plain version; a CUDA tensor the kernel, with ``block_q``
    query rows a block."""
    if q.device.type == "cpu":
        o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, cap=cap)
        return o.transpose(1, 2)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                cap=cap, block_q=block_q)


def attn_tune_space(n: Node, hw) -> List[Tuple[int]]:
    """The instances' query rows a block whose shared memory fits
    ``hw.smem_bytes``, the default first."""
    hd = n.spec.shape[-1]
    size = 2 if n.spec.dtype != "float32" else 4
    return [(bq,) for bq in BLOCK_QS
            if flash_smem_bytes(hd, size, bq) <= hw.smem_bytes]


def attn_refine_space(n: Node, hw, cfg) -> List[Tuple[int]]:
    """Only the source's instances are legal, and the space already holds
    every one that fits: nothing lies around the winner."""
    return attn_tune_space(n, hw)


def _attrs(n: Node) -> dict:
    return dict(causal=n.attrs.get("causal", True),
                window=n.attrs.get("window", 0),
                cap=n.attrs.get("cap", 0.0))


def _attention_cuda_impl(n: Node, vals: Sequence[torch.Tensor],
                         backend: "registry.Backend") -> torch.Tensor:
    q, k, v = vals
    cfg = n.attrs.get(ATTR)
    return flash_attention(q, k, v, **_attrs(n),
                           block_q=int(cfg[0]) if cfg else BLOCK_Q)


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
    requires=("cuda",), supports=_supports,
    tunable=Tunable(ATTR, attn_tune_space, refine=attn_refine_space))
registry.register_reference_impl(
    OpKind.ATTENTION, _attention_ref_impl, name="ref.attention",
    memory="roundtrip")

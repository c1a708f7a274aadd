"""Gradient compression for the data-parallel all-reduce (counterpart of
``repro.distributed.compress``).  ``"bf16"`` rounds every f32 gradient to
bfloat16 and back, the values a compressed all-reduce would carry;
``"none"`` leaves the gradients as they are."""
from __future__ import annotations

import torch

from ..models.backbone import tree_map


def compress_grads(grads, method: str = "none"):
    if method == "none":
        return grads
    if method == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16)
                        if g.dtype == torch.float32 else g, grads)
    raise ValueError(f"unknown compression {method}")


def decompress_grads(grads, method: str = "none"):
    if method == "bf16":
        return tree_map(lambda g: g.float(), grads)
    return grads

"""The storage types of the hand-written kernels: float32, bfloat16 and
float16.

Each kernel reads its operands in one of them, computes and keeps its
state in f32, and rounds once to the output's type at the store, as the
JAX kernels do.  A family's ``supports`` admits a node whose dtype is one
of them when its inputs share it (the JAX matmul's rule); a wrapper given
any other dtype, or mixed dtypes, raises.  No path converts a tensor to
f32 and back around a kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

FLOAT_DTYPES = ("float32", "bfloat16", "float16")
# each CUDA kernel exports one entry per type: sol_<kernel>_<suffix>
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16"}


def same_float(n, inputs: Optional[Sequence] = None) -> bool:
    """Whether node ``n``'s dtype is a storage type of the kernels and
    every node of ``inputs`` (all of ``n``'s inputs by default) shares
    it."""
    ins = n.inputs if inputs is None else inputs
    return (n.spec.dtype in FLOAT_DTYPES
            and all(i.spec.dtype == n.spec.dtype for i in ins))


def suffix(what: str, *tensors: torch.Tensor) -> str:
    """The entry suffix of the storage type the tensors share; raises
    ``TypeError`` for any other dtype or for mixed ones."""
    dt = tensors[0].dtype
    if dt not in SUFFIX or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{what} takes float32, bfloat16 or float16, all "
                        f"one dtype; got {[str(t.dtype) for t in tensors]}")
    return SUFFIX[dt]

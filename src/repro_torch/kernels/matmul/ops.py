"""Public entry + dispatch-table entries of the matmul kernel.

``cuda.matmul`` (MATMUL, weights (in, out)) and ``cuda.linear`` (LINEAR,
weights (out, in), read through the transposed view) sit at the shared tier
gated on the ``"cuda"`` capability — where ``pallas.matmul_mxu`` and
``pallas.linear_mxu`` sit in the JAX package.  As there, ``supports`` admits
float32, bfloat16 and float16 when both operands share the node's dtype
(``kernels/dtypes.py``); any other node goes to the reference tier visibly,
in ``impl_report``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...backends import registry
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import matmul_cuda
from .ref import matmul_ref


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) → (..., N); leading dims fold into M.  A CPU
    tensor takes the plain version; a CUDA tensor the kernel."""
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    lead = x.shape[:-1]
    y = matmul_cuda(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[-1])


def _matmul_impl(n: Node, vals: Sequence[torch.Tensor],
                 backend: "registry.Backend") -> torch.Tensor:
    return matmul(vals[0], vals[1])


def _linear_impl(n: Node, vals: Sequence[torch.Tensor],
                 backend: "registry.Backend") -> torch.Tensor:
    from ...core.executor import linear_weight_kn
    y = matmul(vals[0], linear_weight_kn(n, vals[1]))   # (K, N) view
    if len(vals) > 2 and vals[2] is not None:
        y = y + vals[2]
    return y


def _supports_matmul(n: Node) -> bool:
    return (len(n.inputs) >= 2 and len(n.inputs[1].spec.shape) == 2
            and len(n.inputs[0].spec.shape) >= 2
            and same_float(n, n.inputs[:2]))


def _supports_linear(n: Node) -> bool:
    return _supports_matmul(n) and "out_features" in n.attrs


registry.register_shared_impl(
    OpKind.MATMUL, _matmul_impl, name="cuda.matmul", requires=("cuda",),
    supports=_supports_matmul)
registry.register_shared_impl(
    OpKind.LINEAR, _linear_impl, name="cuda.linear", requires=("cuda",),
    supports=_supports_linear)

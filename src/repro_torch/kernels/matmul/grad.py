"""Matmul and Linear backward on the matmul kernel (counterpart of
``repro.kernels.matmul.grad``).

For y = x @ w both gradients are products, dx = ct @ wᵀ and
dw = xᵀ @ ct, so ``cuda.matmul_bwd`` and ``cuda.linear_bwd`` run them
through ``cuda.matmul`` (``csrc/matmul.cu``), the kernel of the forward.
They sit at the shared tier gated on ``"cuda"``, where
``pallas.matmul_mxu_bwd`` and ``pallas.linear_mxu_bwd`` sit in the JAX
package.  The kernel wants its left operand with a unit column stride, so
the transposed operand of the dw product is copied contiguous first: one
copy of the activations (or of the cotangent) per node and step.  dw comes
back in the layout its weight is bound in: a Linear's (out, in) weight
takes ctᵀ @ x, an (in, out) one xᵀ @ ct (the orientation rule of
``executor.linear_weight_kn``), and a bias takes ``ct``'s sum over its
rows.

Their ``Tunable`` is the forward's K split under
``node.attrs['cuda_mm_block_bwd']``, applied to the dx product
(M, N) · (N, K) only, whose shape differs from the forward's; the dw
product takes its own plan.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ...backends import registry
from ...core.autotune import Tunable, node_shape
from ...core.ir import Node, OpKind
from .kernel import plan
from .ops import (ATTR, _supports_linear, _supports_matmul, matmul, mm_unit,
                  split_space)

ATTR_BWD = ATTR + "_bwd"


def _splits(n: Node) -> int:
    cfg = n.attrs.get(ATTR_BWD)
    return int(cfg[0]) if cfg else 0


def _kn_weight(n: Node, w_shape) -> bool:
    """Whether the node's weight is stored (K=in, N=out): a MATMUL's
    always, a Linear's unless its first dim is ``out_features``."""
    return n.op is OpKind.MATMUL or w_shape[0] != n.attrs["out_features"]


def _dx_dw(x: torch.Tensor, w: torch.Tensor, ct: torch.Tensor, kn: bool,
           splits: int):
    """x (..., K); w (K, N) where ``kn`` else (N, K); ct (..., N) → (dx
    (..., K), dw in w's layout)."""
    ct = ct.contiguous()
    dx = matmul(ct, w.T if kn else w, splits=splits)
    x2d = x.reshape(-1, x.shape[-1])
    ct2d = ct.reshape(-1, ct.shape[-1])
    if kn:
        dw = matmul(x2d.T.contiguous(), ct2d)          # (K, M) @ (M, N)
    else:
        dw = matmul(ct2d.T.contiguous(), x2d)          # (N, M) @ (M, K)
    return dx, dw


def _matmul_grad_impl(n: Node, res, ct: torch.Tensor,
                      backend: "registry.Backend"):
    (x, w), _out = res
    return _dx_dw(x, w, ct, True, _splits(n))


def _linear_grad_impl(n: Node, res, ct: torch.Tensor,
                      backend: "registry.Backend"):
    vals, _out = res
    x, w = vals[0], vals[1]
    dx, dw = _dx_dw(x, w, ct, _kn_weight(n, w.shape), _splits(n))
    if len(vals) > 2:
        return dx, dw, ct.reshape(-1, ct.shape[-1]).sum(0)
    return dx, dw


def dx_plan(n: Node, hw, splits: int = 0):
    """The plan of the node's dx product ct (M, N) @ wᵀ (N, K): ct
    contiguous; the weight read as ``_dx_dw`` passes it, an (N, K) one
    K-contiguous (element (n, k) at n·K + k), a (K, N) one through its
    transposed view (at k·N + n)."""
    m, k, nn = node_shape(n)
    kn = _kn_weight(n, n.inputs[1].spec.shape)
    ldb_k, ldb_n = (1, nn) if kn else (k, 1)
    return plan(m, k, nn, nn, ldb_k, ldb_n, sms=hw.sms,
                itemsize=2 if n.spec.dtype != "float32" else 4,
                splits=splits)


def mm_bwd_tune_space(n: Node, hw) -> List[Tuple[int]]:
    """``split_space`` of the dx product, whose reduction is N."""
    return split_space(lambda s: dx_plan(n, hw, s), node_shape(n)[2])


def mm_bwd_refine_space(n: Node, hw, cfg) -> List[Tuple[int]]:
    """Half and twice the winning split count of the dx product."""
    s = int(cfg[0])
    return [(dx_plan(n, hw, c).splits,) for c in (max(1, s // 2), 2 * s)]


_MM_BWD_TUNABLE = Tunable(ATTR_BWD, mm_bwd_tune_space,
                          refine=mm_bwd_refine_space)

registry.register_shared_grad_impl(
    OpKind.MATMUL, _matmul_grad_impl, name="cuda.matmul_bwd",
    requires=("cuda",), supports=_supports_matmul, tunable=_MM_BWD_TUNABLE,
    unit=mm_unit)
registry.register_shared_grad_impl(
    OpKind.LINEAR, _linear_grad_impl, name="cuda.linear_bwd",
    requires=("cuda",), supports=_supports_linear, tunable=_MM_BWD_TUNABLE,
    unit=mm_unit)

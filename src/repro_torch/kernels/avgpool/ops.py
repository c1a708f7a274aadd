"""Public entry + dispatch-table entry of the Listing-3 AveragePooling.

``cuda.avgpool`` sits at the shared tier gated on ``"cuda"``, where
``pallas.avgpool`` sits in the JAX package; AVGPOOL's reference tier is the
executor's ``F.avg_pool2d`` lowering.  The kernel covers rank-4 NCHW,
stride 1, VALID, in float32, bfloat16 or float16 (``kernels/dtypes.py``);
``supports`` refuses the rest, so such a node elects the reference tier
visibly, in ``impl_report``.  The JAX impl's
``avgpool_block`` Tunable waits for measured election on the card; its
natural space here is the band height of ``kernel.avgpool_plan``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ...backends import registry
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import avgpool_cuda
from .ref import avgpool_ref


def avgpool(x: torch.Tensor, kh: int = 3, kw: int = 3) -> torch.Tensor:
    """Paper Listing-3 AveragePooling (NCHW, stride 1, VALID).  A CPU
    tensor takes the plain version; a CUDA tensor the kernel."""
    if x.device.type == "cpu":
        return avgpool_ref(x, kh, kw)
    return avgpool_cuda(x.contiguous(), kh, kw)


def _window(n: Node) -> Tuple[int, int]:
    k = n.attrs.get("kernel", 2)
    return (k, k) if isinstance(k, int) else tuple(k)


def _supports(n: Node) -> bool:
    k = n.attrs.get("kernel", 2)
    s = n.attrs.get("stride", k)
    return (len(n.spec.shape) == 4 and s in (1, (1, 1))
            and (isinstance(k, int) or len(k) == 2)
            and same_float(n))


def _avgpool_impl(n: Node, vals: Sequence[torch.Tensor],
                  backend: "registry.Backend") -> torch.Tensor:
    return avgpool(vals[0], *_window(n))


registry.register_shared_impl(
    OpKind.AVGPOOL, _avgpool_impl, name="cuda.avgpool",
    requires=("cuda",), supports=_supports)

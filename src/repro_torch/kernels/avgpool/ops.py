"""Public entry + dispatch-table entry of the Listing-3 AveragePooling.

``cuda.avgpool`` sits at the shared tier gated on ``"cuda"``, where
``pallas.avgpool`` sits in the JAX package; AVGPOOL's reference tier is the
executor's ``F.avg_pool2d`` lowering.  The kernel covers rank-4 NCHW,
stride 1, VALID, in float32, bfloat16 or float16 (``kernels/dtypes.py``);
``supports`` refuses the rest, so such a node elects the reference tier
visibly, in ``impl_report``.

The impl declares a ``Tunable`` over the band height of
``kernel.avgpool_plan``: a config ``(rows,)`` is pinned as
``node.attrs['cuda_avgpool_block']``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ...backends import registry
from ...core.autotune import Tunable
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import BAND_SWEEP, avgpool_cuda, avgpool_plan
from .ref import avgpool_ref

ATTR = "cuda_avgpool_block"


def avgpool(x: torch.Tensor, kh: int = 3, kw: int = 3, *,
            rows: int = 0) -> torch.Tensor:
    """Paper Listing-3 AveragePooling (NCHW, stride 1, VALID).  A CPU
    tensor takes the plain version; a CUDA tensor the kernel, in bands of
    ``rows`` output rows where a tuned config gives them."""
    if x.device.type == "cpu":
        return avgpool_ref(x, kh, kw)
    return avgpool_cuda(x.contiguous(), kh, kw, rows=rows)


def _window(n: Node) -> Tuple[int, int]:
    k = n.attrs.get("kernel", 2)
    return (k, k) if isinstance(k, int) else tuple(k)


def _supports(n: Node) -> bool:
    k = n.attrs.get("kernel", 2)
    s = n.attrs.get("stride", k)
    return (len(n.spec.shape) == 4 and s in (1, (1, 1))
            and (isinstance(k, int) or len(k) == 2)
            and same_float(n))


def node_plan(n: Node, rows: int = 0):
    """``avgpool_plan`` at a node's shapes."""
    nb, c, h, w = n.inputs[0].spec.shape
    return avgpool_plan(nb, c, h, w, *_window(n),
                        2 if n.spec.dtype != "float32" else 4, rows)


def avgpool_tune_space(n: Node, hw) -> List[Tuple[int]]:
    """The plan's band height and every height of ``BAND_SWEEP``, each
    whose staged band fits ``hw.smem_bytes``; the configs are the distinct
    heights the plan makes of them (at most the output's rows)."""
    return sorted(set(_heights(n, hw, (0, *BAND_SWEEP))))


def avgpool_refine_space(n: Node, hw, cfg) -> List[Tuple[int]]:
    """Half and twice the winning band height, as the plan makes them."""
    rows = int(cfg[0])
    return _heights(n, hw, (max(1, rows // 2), 2 * rows))


def _heights(n: Node, hw, asks) -> List[Tuple[int]]:
    """The band heights the plan makes of ``asks`` whose staged band fits
    ``hw.smem_bytes``."""
    out = []
    for rows in asks:
        try:
            p = node_plan(n, rows)
        except ValueError:          # the band cannot fit a block
            continue
        if p.smem <= hw.smem_bytes:
            out.append((p.rows,))
    return out


def _avgpool_impl(n: Node, vals: Sequence[torch.Tensor],
                  backend: "registry.Backend") -> torch.Tensor:
    cfg = n.attrs.get(ATTR)
    return avgpool(vals[0], *_window(n), rows=int(cfg[0]) if cfg else 0)


registry.register_shared_impl(
    OpKind.AVGPOOL, _avgpool_impl, name="cuda.avgpool",
    requires=("cuda",), supports=_supports,
    tunable=Tunable(ATTR, avgpool_tune_space, refine=avgpool_refine_space))

"""AveragePooling backward: uniform spreading as a grouped convolution
(counterpart of ``repro.kernels.avgpool.grad``).

For stride-1 VALID average pooling every input pixel receives ct/(kh·kw)
from each window that covers it: a full-padding correlation of the
cotangent with a (kh, kw) kernel of 1/(kh·kw), one ``F.conv2d`` with
``groups=C``, padded kh−1 and kw−1, in f32 with TF32 off.
``conv.avgpool_bwd`` is shared with no capability needed, for the nodes
the forward kernel admits, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...backends import registry
from ...core.ir import Node, OpKind
from ...core.measure import full_f32
from .ops import _supports, _window


def _avgpool_grad_impl(n: Node, res, ct: torch.Tensor,
                       backend: "registry.Backend"):
    (x,), _out = res
    kh, kw = _window(n)
    c = x.shape[1]
    kern = torch.full((c, 1, kh, kw), 1.0 / (kh * kw), dtype=torch.float32,
                      device=ct.device)
    with full_f32():
        dx = F.conv2d(ct.float(), kern, padding=(kh - 1, kw - 1), groups=c)
    return (dx.to(x.dtype),)


registry.register_shared_grad_impl(
    OpKind.AVGPOOL, _avgpool_grad_impl, name="conv.avgpool_bwd",
    supports=_supports)

"""The ``host_cpu`` backend (counterpart of ``repro.backends.host_cpu``):
the paper's claim that standing up a device backend costs a handful of
declarations, because all lowering logic is shared and only per-op
'flavours' differ (paper Sec. IV, 'a backend is ≤3 kLOC').

Everything here goes through the public dispatch table, ``register_backend``
plus ``register_impl``, with no edit to ``core.executor``:

  * its own :class:`HardwareSpec` (``registry.HOST_CPU``: the host's memory
    hierarchy, no tensor cores) and ``device_type="cpu"``: ``optimize(...,
    backend="host_cpu")`` runs on the host and refuses a CUDA device;
  * (out, in) Linear weights and NCHW convs (paper: fastest on CPUs);
  * DFP fusion groups compose op at a time (``ref.compose``): with no
    ``cuda`` capability the shared Hopper kernels are not admissible;
  * two tier-0 overrides showing per-op flavour election: a BLAS-shaped
    Linear (the explicit (out, in) contraction) and an NCHW conv.

Both overrides compute what the reference tier computes.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.ir import Node, OpKind
from .registry import HOST_CPU, Backend, register_backend, register_impl

Tensor = torch.Tensor


host_cpu = register_backend(Backend(
    name="host_cpu",
    hw=HOST_CPU,
    linear_weight_layout="oi",   # paper: (out,in) fastest on CPUs
    conv_layout="nchw",
    capabilities=frozenset({"torch"}),   # no "cuda": DFP groups compose
    device_type="cpu",
))


def _linear_oi(n: Node, vals: Sequence[Tensor], backend: Backend) -> Tensor:
    """BLAS-shaped Linear: keep the weight (out, in) and contract x @ Wᵀ,
    the GEMM orientation host BLAS libraries prefer (paper Sec. III-A)."""
    x, w = vals[0], vals[1]
    if w.shape[0] != n.attrs["out_features"]:
        w = w.T                       # stored (in, out): back to (out, in)
    y = x @ w.T
    if len(vals) > 2 and vals[2] is not None:
        y = y + vals[2]
    return y


def _conv2d_nchw(n: Node, vals: Sequence[Tensor], backend: Backend) -> Tensor:
    """NCHW × OIHW: the layout host conv libraries (DNNL in the paper's X86
    backend) default to, with the node's stride, padding and groups."""
    x, w = vals[0], vals[1]
    bias = vals[2] if len(vals) > 2 else None
    return F.conv2d(x, w, bias, stride=n.attrs.get("stride", 1),
                    padding=n.attrs.get("padding", 0),
                    groups=n.attrs.get("groups", 1))


register_impl("host_cpu", OpKind.LINEAR, _linear_oi,
              name="host_cpu.linear_oi",
              supports=lambda n: len(n.inputs) >= 2)
register_impl("host_cpu", OpKind.CONV2D, _conv2d_nchw,
              name="host_cpu.conv2d_nchw",
              supports=lambda n: len(n.spec.shape) == 4)

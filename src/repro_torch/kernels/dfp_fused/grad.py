"""DFP fusion-group backward: recompute and autograd of the composed chain
(counterpart of ``repro.kernels.dfp_fused.grad``).

A FUSED node's forward may be the single-launch DFP kernel, which has no
autograd of its own.  ``recompute.fused_bwd`` recomputes the group op at a
time through ``executor.compose_fused`` (body ops still resolve through
the dispatch table) from the saved side inputs and differentiates that
chain: no intermediate of the group outlives the forward.  It sits at the
shared tier with streamed memory, so FUSED nodes elect it over the
reference tier's ``ref.fused_bwd`` (the same math, charged with a round
trip of every intermediate).
"""
from __future__ import annotations

import torch

from ...backends import registry
from ...core import executor
from ...core.ir import Node, OpKind


def _fused_grad_impl(n: Node, res, ct: torch.Tensor,
                     backend: "registry.Backend"):
    vals, _out = res
    return executor.vjp(
        lambda *xs: executor.compose_fused(n, list(xs), backend), vals, ct)


registry.register_shared_grad_impl(
    OpKind.FUSED, _fused_grad_impl, name="recompute.fused_bwd")

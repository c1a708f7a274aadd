"""Decode-attention backward: autograd of the plain version (counterpart
of ``repro.kernels.decode_attention.grad``).

Decode steps are served, not trained, but the op joins the backward
tables so a graph holding DECODE_ATTENTION nodes stays differentiable end
to end.  The integer ``lens`` gets no cotangent (the executor's
``_NodeFunction`` returns None for it).
"""
from __future__ import annotations

from ...backends import registry
from ...core import executor
from ...core.ir import OpKind

registry.register_reference_grad_impl(
    OpKind.DECODE_ATTENTION, executor.reference_vjp_grad,
    name="ref.decode_attention_bwd", memory="roundtrip")

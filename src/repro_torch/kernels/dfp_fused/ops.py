"""Public entry + dispatch-table entry of the DFP fused kernel.

``cuda.dfp_fused`` is the shared-tier impl of ``OpKind.FUSED`` gated on
``"cuda"`` (where ``pallas.dfp_fused`` sits in the JAX package).  Whether a
fusion group encodes as a ``Program`` is decided in ``supports``, at
election time: a group the kernel does not cover elects ``ref.compose``
visibly, in ``impl_report``, and the kernel path itself never falls back.
The kernel takes float32, bfloat16 and float16 when the group's inputs
share the node's dtype (``kernels/dtypes.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...backends import registry
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import dfp_fused_triton
from .program import Program, encode_program
from .ref import dfp_fused_ref

# ops the fused kernel covers
DFP_KERNEL_OPS = {
    OpKind.RELU, OpKind.GELU, OpKind.SILU, OpKind.SIGMOID, OpKind.TANH,
    OpKind.EXP, OpKind.ADD, OpKind.SUB, OpKind.MUL, OpKind.DIV,
    OpKind.BIAS_ADD, OpKind.SCALE, OpKind.SOFTCAP, OpKind.RMSNORM,
    OpKind.LAYERNORM, OpKind.IDENTITY, OpKind.DROPOUT,
}


def dfp_fused(prog: Program, operands: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """Run a program over its operands; the output has the shape and dtype
    of the first 'full' operand.  A CPU tensor takes the plain version; a
    CUDA tensor the kernel."""
    full = [o for o, k in zip(operands, prog.operand_kinds) if k == "full"]
    if not full:
        raise ValueError("dfp_fused needs at least one full-shape operand")
    out_shape, out_dtype = tuple(full[0].shape), full[0].dtype
    if full[0].device.type == "cpu":
        return dfp_fused_ref(prog, operands, out_shape, out_dtype)
    return dfp_fused_triton(prog, [o.contiguous() for o in operands],
                            out_shape, out_dtype)


def _encodes(n: Node) -> bool:
    try:
        prog, _ = encode_program(n, {id(i): i.spec for i in n.inputs})
    except NotImplementedError:
        return False
    return "full" in prog.operand_kinds


def _supports_chain(n: Node) -> bool:
    body = n.body
    return (bool(body)
            and all(b.op in DFP_KERNEL_OPS for b in body)
            and all(b.spec.shape == body[-1].spec.shape
                    or b.op is OpKind.BIAS_ADD for b in body)
            and same_float(n)
            and _encodes(n))


def _dfp_fused_impl(n: Node, vals: Sequence[torch.Tensor],
                    backend: "registry.Backend") -> torch.Tensor:
    program, operands = encode_program(
        n, {id(i): v for i, v in zip(n.inputs, vals)})
    return dfp_fused(program, operands)


registry.register_shared_impl(
    OpKind.FUSED, _dfp_fused_impl, name="cuda.dfp_fused",
    requires=("cuda",), supports=_supports_chain, memory="streamed")

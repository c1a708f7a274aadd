"""Static program encoding for the DFP fused kernel (counterpart of
``repro.kernels.dfp_fused.program``; the port keeps its own copy).

A fusion group is encoded as a tuple of ``Instr`` over a small virtual
register file.  The encoding is static, so one generated kernel serves
every group with the same ``Program.key()``.

Register model: r0..rk hold values of the chain's output shape.
Operands:
  kind 'full' — a tensor shaped like the chain output (residual inputs)
  kind 'vec'  — a last-dim vector broadcast over rows (bias / norm gains);
                a BIAS_ADD over another axis does not encode

One difference from the JAX encoder: a 'vec' operand may also be a value
source of an elementwise instruction (``mul(x, mu)``, ``add(w0, y)``),
broadcast over rows.  The JAX encoder refuses such a group and its Pallas
impl composes it op by op at run time; the recurrent blocks' mixes and
gates are such groups, and the port runs them through the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from ...core.ir import Node, OpKind

# (opname, dst, srcs..., imm)
Instr = Tuple[Any, ...]

UNARY = {OpKind.RELU: "relu", OpKind.GELU: "gelu", OpKind.SILU: "silu",
         OpKind.SIGMOID: "sigmoid", OpKind.TANH: "tanh", OpKind.EXP: "exp",
         OpKind.IDENTITY: "copy", OpKind.DROPOUT: "copy"}
BINARY = {OpKind.ADD: "add", OpKind.SUB: "sub", OpKind.MUL: "mul",
          OpKind.DIV: "div"}


@dataclasses.dataclass
class Program:
    instrs: Tuple[Instr, ...]
    operand_kinds: Tuple[str, ...]   # per operand: 'full' | 'vec'
    out_reg: int

    def key(self):
        return (self.instrs, self.operand_kinds, self.out_reg)


def encode_program(fused: Node, env: Dict[int, Any]):
    """IR fusion group → (Program, operand list).  ``env`` maps ``id`` of
    each side input to anything with a ``.shape`` — tensors at run time, the
    nodes' ``TensorSpec``s when ``supports`` asks whether a group encodes.
    Raises NotImplementedError for chains the kernel does not cover."""
    body = fused.body
    out_shape = tuple(body[-1].spec.shape)
    if len(out_shape) < 2:
        raise NotImplementedError("dfp_fused wants rank>=2")
    d = out_shape[-1]

    operands: List[Any] = []
    operand_kinds: List[str] = []
    op_index: Dict[int, int] = {}     # id(node) -> operand idx
    regs: Dict[int, int] = {}         # id(node) -> register
    next_reg = 0
    instrs: List[Instr] = []
    in_chain = {id(b) for b in body}

    def operand_for(node: Node) -> Tuple[str, int]:
        if id(node) in op_index:
            i = op_index[id(node)]
            return operand_kinds[i], i
        val = env[id(node)]
        if tuple(val.shape) == out_shape:
            kind = "full"
        elif tuple(val.shape) == (d,):
            kind = "vec"
        else:
            raise NotImplementedError(f"operand shape {tuple(val.shape)}")
        op_index[id(node)] = len(operands)
        operands.append(val)
        operand_kinds.append(kind)
        return kind, op_index[id(node)]

    def src_of(node: Node) -> Tuple[str, int]:
        """('reg', r) if produced in-chain else ('op', operand_idx); a 'vec'
        operand broadcasts over rows, like a bias."""
        if id(node) in in_chain:
            return ("reg", regs[id(node)])
        return ("op", operand_for(node)[1])

    for b in body:
        dst = next_reg
        next_reg += 1
        if b.op in UNARY:
            instrs.append((UNARY[b.op], dst, src_of(b.inputs[0]), None))
        elif b.op in BINARY:
            instrs.append((BINARY[b.op], dst, src_of(b.inputs[0]),
                           src_of(b.inputs[1]), None))
        elif b.op is OpKind.SCALE:
            instrs.append(("scale", dst, src_of(b.inputs[0]),
                           float(b.attrs["value"])))
        elif b.op is OpKind.SOFTCAP:
            instrs.append(("softcap", dst, src_of(b.inputs[0]),
                           float(b.attrs["cap"])))
        elif b.op is OpKind.BIAS_ADD:
            # a vec broadcasts over the last axis only: a conv bias (NCHW,
            # axis 1) is per channel, which no operand kind expresses
            axis = b.attrs.get("axis", -1)
            if axis % len(out_shape) != len(out_shape) - 1:
                raise NotImplementedError(f"bias over axis {axis}")
            kind, i = operand_for(b.inputs[1])
            if kind != "vec":
                raise NotImplementedError("bias must be a vector")
            instrs.append(("bias", dst, src_of(b.inputs[0]), i, None))
        elif b.op is OpKind.RMSNORM:
            kind, i = operand_for(b.inputs[1])
            if kind != "vec":
                raise NotImplementedError("rmsnorm gain must be a vector")
            instrs.append(("rmsnorm", dst, src_of(b.inputs[0]), i,
                           float(b.attrs.get("eps", 1e-6))))
        elif b.op is OpKind.LAYERNORM:
            kg, gi = operand_for(b.inputs[1])
            kb, bi = operand_for(b.inputs[2])
            if kg != "vec" or kb != "vec":
                raise NotImplementedError("layernorm params must be vectors")
            instrs.append(("layernorm", dst, src_of(b.inputs[0]), gi, bi,
                           float(b.attrs.get("eps", 1e-5))))
        else:
            raise NotImplementedError(f"dfp op {b.op}")
        regs[id(b)] = dst

    prog = Program(tuple(instrs), tuple(operand_kinds),
                   out_reg=regs[id(body[-1])])
    return prog, operands

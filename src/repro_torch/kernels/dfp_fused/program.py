"""Static program encoding for the DFP fused kernel (counterpart of
``repro.kernels.dfp_fused.program``; the port keeps its own copy).

A fusion group is encoded as a tuple of ``Instr`` over a small virtual
register file.  The encoding is static, so one generated kernel serves
every group with the same ``Program.key()``.

``split_program`` cuts a program into segments that run as successive
launches of the same kernel (a tuned ``max_group``; JAX
``dfp_fused/program.py:147-244``).  ``program_to_str`` and
``program_from_str`` carry a program through an exported graph, as the
DFP custom op's string argument (``kernels/library.py``).

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
import json
from typing import Any, Dict, List, Optional, Tuple

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


def program_to_str(prog: Program) -> str:
    """``prog.key()`` as JSON: the DFP op's argument in an exported graph.
    JSON writes each float as its shortest repr, so it reads back exactly."""
    return json.dumps(prog.key(), separators=(",", ":"))


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def program_from_str(text: str) -> Program:
    """The program ``program_to_str`` wrote, with an equal ``key()``."""
    instrs, kinds, out_reg = json.loads(text)
    return Program(_tuples(instrs), tuple(kinds), int(out_reg))


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


# ---------------------------------------------------------------------------
# program splitting — the second field of a tuned DFP config caps how many
# instructions run as one kernel launch; each cut carries one value through
# device memory to the next launch
# ---------------------------------------------------------------------------

# which Instr slots hold value sources ('reg'/'op' pairs) and which hold raw
# operand indices of vectors, per opcode: what split_program renumbers
_SRC_SLOTS = {**{op: (2,) for op in
                 ("relu", "gelu", "silu", "sigmoid", "tanh", "exp", "copy",
                  "scale", "softcap", "bias", "rmsnorm", "layernorm")},
              **{op: (2, 3) for op in ("add", "sub", "mul", "div")}}
_VEC_SLOTS = {"bias": (3,), "rmsnorm": (3,), "layernorm": (3, 4)}


def split_points(prog: Program) -> List[int]:
    """Instruction indices ``i`` after which the only live value is
    instruction ``i``'s own destination: the legal cuts, where exactly one
    tensor crosses."""
    n = len(prog.instrs)
    dst_pos = {ins[1]: j for j, ins in enumerate(prog.instrs)}
    pts: List[int] = []
    for i in range(n - 1):
        live = set()
        for j in range(i + 1, n):
            ins = prog.instrs[j]
            for slot in _SRC_SLOTS[ins[0]]:
                tag, r = ins[slot]
                if tag == "reg" and dst_pos[r] <= i:
                    live.add(r)
        if dst_pos.get(prog.out_reg, n) <= i:
            live.add(prog.out_reg)
        if live == {prog.instrs[i][1]}:
            pts.append(i)
    return pts


def split_program(prog: Program, max_len: int):
    """Split ``prog`` at legal split points into segments of at most
    ``max_len`` instructions (stretching a segment to the next legal point
    when none falls inside the budget).  The value crossing each cut becomes
    a ``'full'`` operand of the following segment.

    Returns ``[(segment, selection), ...]`` where ``selection`` maps each
    segment operand slot to an original operand index, or the string
    ``'carry'`` for the previous segment's output."""
    n = len(prog.instrs)
    if max_len >= n or max_len < 1:
        return [(prog, list(range(len(prog.operand_kinds))))]
    pts = set(split_points(prog))
    cuts: List[int] = []
    start = 0
    while n - start > max_len:
        cut = None
        for i in range(min(start + max_len, n - 1) - 1, start - 1, -1):
            if i in pts:
                cut = i
                break
        if cut is None:
            for i in range(start + max_len, n - 1):
                if i in pts:
                    cut = i
                    break
        if cut is None:
            break
        cuts.append(cut)
        start = cut + 1
    if not cuts:
        return [(prog, list(range(len(prog.operand_kinds))))]

    segments = []
    carry_reg: Optional[int] = None
    lo = 0
    for hi in cuts + [n - 1]:
        sel: List[Any] = []
        kinds: List[str] = []
        op_map: Dict[int, int] = {}
        carry_local: Optional[int] = None
        local_reg: Dict[int, int] = {}
        instrs: List[Instr] = []

        def op_local(orig: int) -> int:
            if orig not in op_map:
                op_map[orig] = len(sel)
                sel.append(orig)
                kinds.append(prog.operand_kinds[orig])
            return op_map[orig]

        for j in range(lo, hi + 1):
            ins = list(prog.instrs[j])
            for slot in _SRC_SLOTS[ins[0]]:
                tag, r = ins[slot]
                if tag == "op":
                    ins[slot] = ("op", op_local(r))
                elif r in local_reg:
                    ins[slot] = ("reg", local_reg[r])
                else:       # produced before this segment: must be the carry
                    assert r == carry_reg, f"non-carry reg {r} crosses a cut"
                    if carry_local is None:
                        carry_local = len(sel)
                        sel.append("carry")
                        kinds.append("full")
                    ins[slot] = ("op", carry_local)
            for slot in _VEC_SLOTS.get(ins[0], ()):
                ins[slot] = op_local(ins[slot])
            local_reg[ins[1]] = j - lo
            ins[1] = j - lo
            instrs.append(tuple(ins))
        segments.append((Program(tuple(instrs), tuple(kinds),
                                 out_reg=hi - lo), sel))
        carry_reg = prog.instrs[hi][1]
        lo = hi + 1
    return segments

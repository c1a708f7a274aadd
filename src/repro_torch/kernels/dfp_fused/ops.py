"""Public entry + dispatch-table entry of the DFP fused kernel.

``cuda.dfp_fused`` is the shared-tier impl of ``OpKind.FUSED`` gated on
``"cuda"`` (where ``pallas.dfp_fused`` sits in the JAX package).  Whether a
fusion group encodes as a ``Program`` is decided in ``supports``, at
election time: a group the kernel does not cover elects ``ref.compose``
visibly, in ``impl_report``, and the kernel path itself never falls back.
The kernel takes float32, bfloat16 and float16 when the group's inputs
share the node's dtype (``kernels/dtypes.py``).

The impl declares a ``Tunable`` over fusion-group sizing, as the JAX impl
does: a config ``(block_rows, max_group)`` is pinned as
``node.attrs['cuda_dfp_block']``.  ``block_rows`` sets the row block of
``kernel.block_shape``; a ``max_group`` shorter than the program runs it as
successive launches of the same kernel over the segments
``program.split_program`` cuts (``dfp_fused_segmented``), each cut value
crossing device memory once.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ...backends import registry
from ...core.autotune import Tunable
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import BLOCK_ELEMS, block_shape, dfp_fused_triton
from .program import Program, encode_program, program_to_str, \
    split_program
from .ref import dfp_fused_ref

ATTR = "cuda_dfp_block"

# ops the fused kernel covers
DFP_KERNEL_OPS = {
    OpKind.RELU, OpKind.GELU, OpKind.SILU, OpKind.SIGMOID, OpKind.TANH,
    OpKind.EXP, OpKind.ADD, OpKind.SUB, OpKind.MUL, OpKind.DIV,
    OpKind.BIAS_ADD, OpKind.SCALE, OpKind.SOFTCAP, OpKind.RMSNORM,
    OpKind.LAYERNORM, OpKind.IDENTITY, OpKind.DROPOUT,
}


def dfp_fused(prog: Program, operands: Sequence[torch.Tensor], *,
              block_rows: int = 0) -> torch.Tensor:
    """Run a program over its operands; the output has the shape and dtype
    of the first 'full' operand.  A CPU tensor takes the plain version; a
    CUDA tensor the kernel, with ``block_rows`` rows a program where a
    tuned config asks for them."""
    full = [o for o, k in zip(operands, prog.operand_kinds) if k == "full"]
    if not full:
        raise ValueError("dfp_fused needs at least one full-shape operand")
    out_shape, out_dtype = tuple(full[0].shape), full[0].dtype
    if full[0].device.type == "cpu":
        return dfp_fused_ref(prog, operands, out_shape, out_dtype)
    return dfp_fused_triton(prog, [o.contiguous() for o in operands],
                            out_shape, out_dtype, block_rows=block_rows)


def dfp_fused_segmented(prog: Program, operands: Sequence[torch.Tensor],
                        max_group: int, *,
                        block_rows: int = 0) -> torch.Tensor:
    """Run a program as launches of at most ``max_group`` instructions
    (``segments``), each cut value stored between them in the storage
    type, which every instruction rounds its result to anyway."""
    out = None
    for seg, sel in segments(prog, max_group):
        vals = [out if i == "carry" else operands[i] for i in sel]
        out = dfp_fused(seg, vals, block_rows=block_rows)
    return out


def segments(prog: Program, max_group: int):
    """``split_program``'s segments of at most ``max_group`` instructions
    where every one reads a full operand (a launch takes its output's
    shape from one), else the whole program as one segment: a config
    measured on another program of the cache bucket still runs."""
    segs = split_program(prog, max_group)
    if all("full" in seg.operand_kinds for seg, _ in segs):
        return segs
    return [(prog, list(range(len(prog.operand_kinds))))]


def dfp_tune_space(n: Node, hw) -> List[Tuple[int, int]]:
    """(block_rows, max_group) configs for one FUSED node: the default row
    block, half, twice and four times it, within four times
    ``BLOCK_ELEMS`` elements and with the block's f32 tile within
    ``hw.smem_bytes`` (a row reduction may stage it in shared memory);
    crossed with the whole program and, where it has a legal cut, a split
    in about halves whose segments each read a full operand."""
    rows, d = math.prod(n.spec.shape[:-1]), n.spec.shape[-1]
    auto = block_shape(rows, d)[0]
    brs = set()
    for want in (max(1, auto // 2), auto, 2 * auto, 4 * auto):
        br, bd, _ = block_shape(rows, d, want)
        if br * bd <= 4 * BLOCK_ELEMS and 4 * br * bd <= hw.smem_bytes:
            brs.add(br)
    prog, _ = encode_program(n, {id(i): i.spec for i in n.inputs})
    size = len(prog.instrs)
    groups = [size]
    half = (size + 1) // 2
    if size >= 2 and len(segments(prog, half)) > 1:
        groups.append(half)
    return [(br, grp) for br in sorted(brs) for grp in groups]


def dfp_refine_space(n: Node, hw, cfg) -> List[Tuple[int, int]]:
    """Half and twice the winning row block, as ``block_shape`` makes them
    and within ``hw.smem_bytes``, each with the winning ``max_group``."""
    rows, d = math.prod(n.spec.shape[:-1]), n.spec.shape[-1]
    br, grp = int(cfg[0]), int(cfg[1])
    out = []
    for want in (max(1, br // 2), 2 * br):
        b, bd, _ = block_shape(rows, d, want)
        if 4 * b * bd <= hw.smem_bytes:
            out.append((b, grp))
    return out


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
    cfg = n.attrs.get(ATTR)
    block_rows, max_group = (int(cfg[0]), int(cfg[1])) if cfg else (0, 0)
    if torch.compiler.is_exporting():
        from ..library import dfp_fused as op
        return op(list(operands), program_to_str(program), block_rows,
                  max_group)
    if max_group and max_group < len(program.instrs):
        return dfp_fused_segmented(program, operands, max_group,
                                   block_rows=block_rows)
    return dfp_fused(program, operands, block_rows=block_rows)


registry.register_shared_impl(
    OpKind.FUSED, _dfp_fused_impl, name="cuda.dfp_fused",
    requires=("cuda",), supports=_supports_chain, memory="streamed",
    tunable=Tunable(ATTR, dfp_tune_space, refine=dfp_refine_space))

"""Plain PyTorch version of the DFP fused kernel: interprets the same static
program on whole tensors (counterpart of ``repro.kernels.dfp_fused.ref``)."""
from __future__ import annotations

import math
from typing import Sequence

import torch

from .program import Program

GELU_C = math.sqrt(2.0 / math.pi)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5·x·(1 + tanh(√(2/π)·(x + 0.044715·x³))) — ``jax.nn.gelu``."""
    return 0.5 * x * (1.0 + torch.tanh(GELU_C * (x + 0.044715 * x ** 3)))


def dfp_fused_ref(prog: Program, operands: Sequence[torch.Tensor],
                  out_shape, out_dtype) -> torch.Tensor:
    d = out_shape[-1]
    rows = 1
    for s in out_shape[:-1]:
        rows *= s
    vals = {i: op.reshape(rows, d) if kind == "full" else op.reshape(1, d)
            for i, (op, kind) in enumerate(zip(operands,
                                               prog.operand_kinds))}
    regs = {}

    def val(src):
        tag, i = src
        return regs[i] if tag == "reg" else vals[i]

    for ins in prog.instrs:
        op, dst = ins[0], ins[1]
        if op == "relu":
            r = torch.clamp_min(val(ins[2]), 0.0)
        elif op == "gelu":
            r = gelu_tanh(val(ins[2]))
        elif op == "silu":
            r = val(ins[2]) * torch.sigmoid(val(ins[2]))
        elif op == "sigmoid":
            r = torch.sigmoid(val(ins[2]))
        elif op == "tanh":
            r = torch.tanh(val(ins[2]))
        elif op == "exp":
            r = torch.exp(val(ins[2]))
        elif op == "copy":
            r = val(ins[2])
        elif op == "add":
            r = val(ins[2]) + val(ins[3])
        elif op == "sub":
            r = val(ins[2]) - val(ins[3])
        elif op == "mul":
            r = val(ins[2]) * val(ins[3])
        elif op == "div":
            r = val(ins[2]) / val(ins[3])
        elif op == "scale":
            r = val(ins[2]) * ins[3]
        elif op == "softcap":
            r = torch.tanh(val(ins[2]) / ins[3]) * ins[3]
        elif op == "bias":
            r = val(ins[2]) + vals[ins[3]]
        elif op == "rmsnorm":
            x = val(ins[2]).float()
            ms = (x * x).mean(-1, keepdim=True)
            r = (x * torch.rsqrt(ms + ins[4])).to(val(ins[2]).dtype) \
                * vals[ins[3]]
        elif op == "layernorm":
            x = val(ins[2]).float()
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            xn = (x - mu) * torch.rsqrt(var + ins[5])
            r = xn.to(val(ins[2]).dtype) * vals[ins[3]] + vals[ins[4]]
        else:  # pragma: no cover
            raise NotImplementedError(op)
        regs[dst] = r
    return regs[prog.out_reg].reshape(out_shape).to(out_dtype)

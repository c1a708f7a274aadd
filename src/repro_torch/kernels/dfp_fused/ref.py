"""Plain PyTorch version of the DFP fused kernel: interprets the same static
program on whole tensors (counterpart of ``repro.kernels.dfp_fused.ref``).

As the kernel, it widens every operand to f32, computes each instruction
in f32 and rounds its result to the operands' storage type (a norm also
after normalising and after its gain), the JAX kernel's instruction-level
cast points; in f32 the roundings are the identity (``kernel.py``)."""
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
    storage = operands[0].dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(storage).float()

    d = out_shape[-1]
    rows = 1
    for s in out_shape[:-1]:
        rows *= s
    vals = {i: (op.reshape(rows, d) if kind == "full"
                else op.reshape(1, d)).float()
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
            x = val(ins[2])
            ms = (x * x).mean(-1, keepdim=True)
            r = rnd(x * torch.rsqrt(ms + ins[4])) * vals[ins[3]]
        elif op == "layernorm":
            x = val(ins[2])
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            xn = rnd((x - mu) * torch.rsqrt(var + ins[5]))
            r = rnd(xn * vals[ins[3]]) + vals[ins[4]]
        else:  # pragma: no cover
            raise NotImplementedError(op)
        regs[dst] = rnd(r)
    return regs[prog.out_reg].reshape(out_shape).to(out_dtype)

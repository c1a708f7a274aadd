"""DFP fused-chain kernel for Hopper, generated in Triton.

Replaces ``repro/kernels/dfp_fused/kernel.py::dfp_fused_call`` (the Pallas
kernel behind ``pallas.dfp_fused``).

The paper's DFP module generates one depth-first loop nest per chain of
memory-bound layers.  Here that code generation targets this card: each
distinct ``Program.key()`` becomes the source of one ``@triton.jit`` kernel
with the instruction program unrolled into straight-line Triton, written to
``build/repro_torch/dfp/`` (Triton compiles from a source file) and cached
per key.  Triton serves as well as CUDA here: the work is an elementwise
pass with at most one row reduction (layernorm/rmsnorm) whose body differs
per fusion group, and Triton compiles a generated body at first use in
seconds, where ``nvcc`` would need a build per program.

Operands and output are float32, bfloat16 or float16, one dtype for all.
Every load is widened to f32 (``.to(tl.float32)``) and each instruction
computes in f32, then rounds its result to the storage type, as the JAX
kernel's instructions do (``repro/kernels/dfp_fused/kernel.py:60-99``): a
norm also rounds after normalising and after its gain, before its bias.
Registers hold f32 values the storage type represents exactly; in f32 the
roundings are the identity.  One difference is left: inside a composite
instruction (gelu, silu, softcap) the JAX kernel rounds each primitive,
the port only the instruction's result.

What bounds it on this card: bytes — each 'full' operand is read once and
the output written once (3.35 TB/s); the few FLOPs per element are free.
Design: the input is viewed as (rows, d) with d untiled (norms reduce over
it); one program handles BLOCK_R rows of BLOCK_D = next_pow2(d) columns,
masked at the edge, so intermediates stay in registers and never touch
device memory.  tanh (for gelu, tanh and softcap) is written through exp,
1 - 2/(exp(2z) + 1), which needs no ``tl.math.tanh``; its absolute error is
a few f32 ulps, inside the 1e-5 tolerance.
"""
from __future__ import annotations

import hashlib
import importlib.util
import math
import os
import threading
from typing import Dict, List, Sequence

import torch

from .. import build, dtypes
from .program import Program

DFP_DIR = build.BUILD_DIR / "dfp"
_lock = threading.Lock()
_kernels: Dict[tuple, object] = {}


def _tanh(z: str) -> str:
    return f"(1.0 - 2.0 / (tl.exp(2.0 * ({z})) + 1.0))"


def _round(v: str) -> str:
    """``v`` rounded to the storage type and widened back to f32."""
    return f"({v}).to(out.dtype.element_ty).to(tl.float32)"


def _norm(x: str, center: bool) -> List[str]:
    """Lines computing a row-normalized value of ``x`` into ``_xn``; masked
    columns are excluded from the row statistics."""
    lines = []
    if center:
        lines.append(f"_mu = tl.sum(tl.where(cmask, {x}, 0.0), axis=1) / d")
        lines.append(f"_xc = tl.where(cmask, {x} - _mu[:, None], 0.0)")
    else:
        lines.append(f"_xc = tl.where(cmask, {x}, 0.0)")
    lines.append("_var = tl.sum(_xc * _xc, axis=1) / d")
    return lines


def generate_source(prog: Program, name: str) -> str:
    """The Triton source of one program's kernel."""
    ops = [f"p{i}" for i in range(len(prog.operand_kinds))]
    body = [
        "pid = tl.program_id(0)",
        "r = pid * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]",
        "c = tl.arange(0, BLOCK_D)[None, :]",
        "cmask = c < d",
        "mask = (r < rows) & cmask",
        "off = r.to(tl.int64) * d + c",
    ]
    for i, kind in enumerate(prog.operand_kinds):
        if kind == "full":
            body.append(f"o{i} = tl.load(p{i} + off, mask=mask, "
                        f"other=0.0).to(tl.float32)")
        else:
            body.append(f"o{i} = tl.load(p{i} + c, mask=cmask, "
                        f"other=0.0).to(tl.float32)")

    def src(s) -> str:
        tag, i = s
        return f"r{i}" if tag == "reg" else f"o{i}"

    for ins in prog.instrs:
        op, dst = ins[0], f"r{ins[1]}"
        if op == "relu":
            body.append(f"{dst} = tl.maximum({src(ins[2])}, 0.0)")
        elif op == "gelu":
            x = src(ins[2])
            inner = f"{math.sqrt(2.0 / math.pi)!r} * ({x} + 0.044715 * {x} * {x} * {x})"
            body.append(f"{dst} = 0.5 * {x} * (1.0 + {_tanh(inner)})")
        elif op == "silu":
            x = src(ins[2])
            body.append(f"{dst} = {x} / (1.0 + tl.exp(-{x}))")
        elif op == "sigmoid":
            body.append(f"{dst} = 1.0 / (1.0 + tl.exp(-{src(ins[2])}))")
        elif op == "tanh":
            body.append(f"{dst} = {_tanh(src(ins[2]))}")
        elif op == "exp":
            body.append(f"{dst} = tl.exp({src(ins[2])})")
        elif op == "copy":
            body.append(f"{dst} = {src(ins[2])}")
        elif op in ("add", "sub", "mul", "div"):
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[op]
            body.append(f"{dst} = {src(ins[2])} {sym} {src(ins[3])}")
        elif op == "scale":
            body.append(f"{dst} = {src(ins[2])} * {ins[3]!r}")
        elif op == "softcap":
            cap = ins[3]
            body.append(f"{dst} = {_tanh(f'{src(ins[2])} / {cap!r}')} * {cap!r}")
        elif op == "bias":
            body.append(f"{dst} = {src(ins[2])} + o{ins[3]}")
        elif op == "rmsnorm":
            body += _norm(src(ins[2]), center=False)
            xn = _round(f"_xc / tl.sqrt(_var[:, None] + {ins[4]!r})")
            body.append(f"{dst} = {xn} * o{ins[3]}")
        elif op == "layernorm":
            body += _norm(src(ins[2]), center=True)
            xn = _round(f"_xc / tl.sqrt(_var[:, None] + {ins[5]!r})")
            body.append(f"{dst} = {_round(f'{xn} * o{ins[3]}')} + o{ins[4]}")
        else:
            raise NotImplementedError(op)
        body.append(f"{dst} = {_round(dst)}")
    body.append(f"tl.store(out + off, r{prog.out_reg}"
                f".to(out.dtype.element_ty), mask=mask)")
    sig = ", ".join(["out"] + ops + ["rows", "d", "BLOCK_R: tl.constexpr",
                                     "BLOCK_D: tl.constexpr"])
    lines = ["# generated by repro_torch.kernels.dfp_fused.kernel for",
             f"# {prog.key()!r}",
             "import triton", "import triton.language as tl", "", "",
             "@triton.jit", f"def {name}({sig}):"]
    lines += ["    " + line for line in body]
    return "\n".join(lines) + "\n"


def compiled_kernel(prog: Program):
    """The ``@triton.jit`` kernel of ``prog``, generated at first use."""
    key = prog.key()
    kern = _kernels.get(key)
    if kern is not None:
        return kern
    with _lock:
        if key not in _kernels:
            digest = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
            name = f"dfp_{digest}"
            DFP_DIR.mkdir(parents=True, exist_ok=True)
            # Triton's compile cache stays inside the checkout's build tree
            # (its default is under $HOME)
            os.environ.setdefault("TRITON_CACHE_DIR",
                                  str(build.BUILD_DIR / "triton"))
            path = DFP_DIR / f"{name}.py"
            text = generate_source(prog, name)
            if not path.is_file() or path.read_text() != text:
                tmp = path.with_suffix(".tmp")
                tmp.write_text(text)
                tmp.replace(path)
            spec = importlib.util.spec_from_file_location(
                f"repro_torch_dfp_{digest}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _kernels[key] = getattr(mod, name)
        return _kernels[key]


BLOCK_ELEMS = 4096      # elements of a program's row block, by default


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def block_shape(rows: int, d: int, block_rows: int = 0):
    """(BLOCK_R, BLOCK_D, num_warps): d untiled; a row block of at most
    ``BLOCK_ELEMS`` elements (at least one row), or ``block_rows`` rows (a
    tuned config, rounded up to a power of two, within four times
    ``BLOCK_ELEMS`` elements: a config measured at a narrower d of the
    cache bucket still fits), never more rows than the call has rounded up
    to a power of two.  Row block i takes rows
    ``[i * BLOCK_R, (i + 1) * BLOCK_R)``, masked at the edge."""
    block_d = _pow2_ceil(d)
    most = _pow2_ceil(rows)
    if block_rows:
        block_r = min(_pow2_ceil(block_rows), most,
                      max(1, 4 * BLOCK_ELEMS // block_d))
    else:
        block_r = max(1, min(BLOCK_ELEMS // block_d, most))
    warps = 8 if block_r * block_d >= BLOCK_ELEMS else 4
    return block_r, block_d, warps


def dfp_fused_triton(prog: Program, operands: Sequence[torch.Tensor],
                     out_shape, out_dtype, *,
                     block_rows: int = 0) -> torch.Tensor:
    """Run ``prog`` on the card: 'full' operands shaped ``out_shape``, 'vec'
    operands (d,), contiguous, on one CUDA device, all in ``out_dtype``
    (float32, bfloat16 or float16).  ``block_rows``: a row block a tuned
    config asks ``block_shape`` for."""
    d = int(out_shape[-1])
    rows = 1
    for s in out_shape[:-1]:
        rows *= int(s)
    if len(operands) != len(prog.operand_kinds):
        raise ValueError("operand count does not match the program")
    dev = operands[0].device if operands else None
    dtypes.suffix("dfp_fused_triton", *operands)
    if out_dtype != operands[0].dtype:
        raise TypeError(f"dfp_fused_triton writes its operands' dtype "
                        f"{operands[0].dtype}, not {out_dtype}")
    for t, kind in zip(operands, prog.operand_kinds):
        if not t.is_cuda or t.device != dev:
            raise ValueError("dfp_fused_triton wants operands on one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("dfp_fused_triton wants contiguous operands")
        want = rows * d if kind == "full" else d
        if t.numel() != want:
            raise ValueError(f"{kind} operand of {t.numel()} elements, "
                             f"want {want}")
    kern = compiled_kernel(prog)
    out = torch.empty(tuple(out_shape), device=dev, dtype=out_dtype)
    block_r, block_d, warps = block_shape(rows, d, block_rows)
    grid = (-(-rows // block_r),)
    with torch.cuda.device(dev):
        kern[grid](out, *operands, rows, d, BLOCK_R=block_r,
                   BLOCK_D=block_d, num_warps=warps)
    dfp_fused_triton.launches += 1
    return out


dfp_fused_triton.launches = 0

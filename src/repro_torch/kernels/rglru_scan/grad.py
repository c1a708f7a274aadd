"""RG-LRU backward: the reverse recurrence is an RG-LRU scan (counterpart
of ``repro.kernels.rglru_scan.grad``).

For h_t = a_t·h_{t-1} + b_t the cotangent recurrence is

  g_t = ḣ_t + a_{t+1}·g_{t+1}        (g_{T-1} = ḣ_{T-1}),

which, read in reversed time, is another gated linear recurrence: the
coefficients rev(a) shifted right one step, the additions rev(ḣ), a zero
initial state.  ``cuda.rglru_scan_bwd`` runs it on the forward's kernel
(``csrc/rglru_scan.cu``) in f32, at the shared tier gated on ``"cuda"``
where ``pallas.rglru_scan_bwd`` sits in the JAX package; the rest is
elementwise:

  db_t = g_t;   da_t = g_t·h_{t-1}  (h_{-1} = h0);   dh0 = a_0·g_0.

Its ``Tunable`` is the forward's (lanes, chunks) cut of the f32 scan,
pinned as ``node.attrs['cuda_rglru_block_bwd']``.  ``ref.rglru_scan_bwd``
is autograd of the plain scan.
"""
from __future__ import annotations

import torch

from ...backends import registry
from ...core import executor
from ...core.autotune import Tunable
from ...core.ir import Node, OpKind
from .ops import ATTR, _supports, rglru_refine_space, rglru_scan, \
    rglru_tune_space

ATTR_BWD = ATTR + "_bwd"


def rglru_scan_vjp(a: torch.Tensor, h0: torch.Tensor, h: torch.Tensor,
                   ct: torch.Tensor, *, lanes: int = 0, chunks: int = 0):
    """(da, db, dh0) in f32 of h = scan(a, b, h0) against the cotangent
    ``ct`` of h (B, T, D), the reverse recurrence run on the scan's entry
    (``ops.rglru_scan``: the kernel on a CUDA tensor, cut as ``lanes``
    and ``chunks`` say where they are given)."""
    af = a.float()
    a_rev = af.flip(1)
    # reversed-time coefficients: coeff_i = a_{T-i}; the first is unused,
    # the zero initial state absorbs it
    coeff = torch.cat([torch.ones_like(a_rev[:, :1]), a_rev[:, :-1]], 1)
    g = rglru_scan(coeff, ct.float().flip(1),
                   torch.zeros(h0.shape, dtype=torch.float32,
                               device=h0.device),
                   lanes=lanes, chunks=chunks)[0].flip(1)
    h_prev = torch.cat([h0.float()[:, None], h.float()[:, :-1]], 1)
    return g * h_prev, g, af[:, 0] * g[:, 0]


def _rglru_grad_impl(n: Node, res, ct: torch.Tensor,
                     backend: "registry.Backend"):
    (a, _b, h0), h = res
    cfg = n.attrs.get(ATTR_BWD)
    lanes, chunks = (int(cfg[0]), int(cfg[1])) if cfg else (0, 0)
    return rglru_scan_vjp(a, h0, h, ct, lanes=lanes, chunks=chunks)


registry.register_shared_grad_impl(
    OpKind.RGLRU_SCAN, _rglru_grad_impl, name="cuda.rglru_scan_bwd",
    requires=("cuda",), supports=_supports,
    tunable=Tunable(ATTR_BWD, lambda n, hw: rglru_tune_space(n, hw, 4),
                    refine=lambda n, hw, cfg: rglru_refine_space(n, hw, cfg,
                                                                 4)))
registry.register_reference_grad_impl(
    OpKind.RGLRU_SCAN, executor.reference_vjp_grad,
    name="ref.rglru_scan_bwd")

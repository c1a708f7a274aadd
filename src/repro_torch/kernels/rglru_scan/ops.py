"""Public entry + dispatch-table entries of the RG-LRU scan kernel.

``cuda.rglru_scan`` sits at the shared tier gated on ``"cuda"``, where
``pallas.rglru_scan`` sits in the JAX package; ``ref.rglru_scan`` is the
reference tier.  The RGLRU_SCAN node takes (a, b, h0) and yields the whole
hidden sequence h.  The kernel takes float32, bfloat16 and float16
(``kernels/dtypes.py``); ``supports`` refuses other dtypes, so such a node
elects the reference tier visibly, in ``impl_report``.

The impl declares a ``Tunable`` over the cut of ``kernel.rglru_plan``: a
config ``(lanes, chunks)`` is pinned as ``node.attrs['cuda_rglru_block']``
— the channel lanes of a warp and the chunks of ``CHUNK`` steps a tile
walks.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ...backends import registry
from ...core.autotune import Tunable
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import LANES, MAX_CHUNKS, rglru_plan, rglru_scan_cuda, \
    static_smem_bytes
from .ref import rglru_scan_ref

ATTR = "cuda_rglru_block"


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
               lanes: int = 0, chunks: int = 0):
    """h_t = a_t·h_{t-1} + b_t.  a, b: (B, T, D); h0: (B, D) → (h, h_last).
    A CPU tensor takes the plain version; a CUDA tensor the kernel, cut as
    a tuned config's ``lanes`` and ``chunks`` say where they are given."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    return rglru_scan_cuda(a.contiguous(), b.contiguous(), h0.contiguous(),
                           lanes=lanes, chunks=chunks)


def node_plan(n: Node, hw, lanes: int = 0, chunks: int = 0):
    """``rglru_plan`` at a node's shapes on ``hw``."""
    b, t, d = n.spec.shape
    return rglru_plan(b, t, d, 2 if n.spec.dtype != "float32" else 4,
                      hw.sms, lanes, chunks)


def rglru_tune_space(n: Node, hw) -> List[Tuple[int, int]]:
    """Every lane width whose chunk kernel's shared memory fits
    ``hw.smem_bytes``, each with the chunks a tile its plan takes and half
    of them (whole warps, at least one); the configs are the distinct
    (lanes, chunks) plans."""
    out = set()
    for lanes in LANES:
        if static_smem_bytes(lanes) > hw.smem_bytes:
            continue
        full = node_plan(n, hw, lanes).chunks
        for chunks in (full, max(1, full // 2)):
            p = node_plan(n, hw, lanes, min(chunks, MAX_CHUNKS))
            out.add((p.lanes, p.chunks))
    return sorted(out, reverse=True)


def rglru_refine_space(n: Node, hw, cfg) -> List[Tuple[int, int]]:
    """The winner's lane width and its neighbours in ``LANES`` whose
    shared memory fits, each with half, the same and twice the winning
    chunks, as the plan makes them."""
    lanes, chunks = int(cfg[0]), int(cfg[1])
    i = LANES.index(lanes)
    out = []
    for width in LANES[max(0, i - 1):i + 2]:
        if static_smem_bytes(width) > hw.smem_bytes:
            continue
        for c in (max(1, chunks // 2), chunks, 2 * chunks):
            p = node_plan(n, hw, width, min(c, MAX_CHUNKS))
            out.append((p.lanes, p.chunks))
    return out


def _rglru_impl(n: Node, vals: Sequence[torch.Tensor],
                backend: "registry.Backend") -> torch.Tensor:
    cfg = n.attrs.get(ATTR)
    lanes, chunks = (int(cfg[0]), int(cfg[1])) if cfg else (0, 0)
    return rglru_scan(*vals, lanes=lanes, chunks=chunks)[0]


def _rglru_ref_impl(n: Node, vals: Sequence[torch.Tensor],
                    backend: "registry.Backend") -> torch.Tensor:
    return rglru_scan_ref(*vals)[0]


def _supports(n: Node) -> bool:
    return len(n.spec.shape) == 3 and same_float(n)


registry.register_shared_impl(
    OpKind.RGLRU_SCAN, _rglru_impl, name="cuda.rglru_scan",
    requires=("cuda",), supports=_supports,
    tunable=Tunable(ATTR, rglru_tune_space, refine=rglru_refine_space))
registry.register_reference_impl(
    OpKind.RGLRU_SCAN, _rglru_ref_impl, name="ref.rglru_scan")

"""Public entry + dispatch-table entries of the matmul kernel.

``cuda.matmul`` (MATMUL, weights (in, out)) and ``cuda.linear`` (LINEAR,
weights (out, in), read through the transposed view) sit at the shared tier
gated on the ``"cuda"`` capability — where ``pallas.matmul_mxu`` and
``pallas.linear_mxu`` sit in the JAX package.  As there, ``supports`` admits
float32, bfloat16 and float16 when both operands share the node's dtype
(``kernels/dtypes.py``); any other node goes to the reference tier visibly,
in ``impl_report``.

Both impls declare one ``Tunable`` over the K split of ``kernel.plan``: a
config ``(splits,)`` is pinned as ``node.attrs['cuda_mm_block']`` and asks
the plan for that many splits of K, on whichever kernel (tensor cores or
skinny) the plan picks for the node's shapes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ...backends import registry
from ...core.autotune import Tunable, node_shape
from ...core.ir import Node, OpKind
from ..dtypes import same_float
from .kernel import SKINNY_MIN_K_CHUNK, TC_MIN_K_CHUNK, matmul_cuda, plan
from .ref import matmul_ref

ATTR = "cuda_mm_block"


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           splits: int = 0) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) → (..., N); leading dims fold into M.  A CPU
    tensor takes the plain version; a CUDA tensor the kernel, with
    ``splits`` K splits where a tuned config asks for them."""
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    lead = x.shape[:-1]
    y = matmul_cuda(x.reshape(-1, x.shape[-1]), w, splits=splits)
    return y.reshape(*lead, w.shape[-1])


def _splits(n: Node) -> int:
    cfg = n.attrs.get(ATTR)
    return int(cfg[0]) if cfg else 0


def _matmul_impl(n: Node, vals: Sequence[torch.Tensor],
                 backend: "registry.Backend") -> torch.Tensor:
    return matmul(vals[0], vals[1], splits=_splits(n))


def _linear_impl(n: Node, vals: Sequence[torch.Tensor],
                 backend: "registry.Backend") -> torch.Tensor:
    from ...core.executor import linear_weight_kn
    y = matmul(vals[0], linear_weight_kn(n, vals[1]),   # (K, N) view
               splits=_splits(n))
    if len(vals) > 2 and vals[2] is not None:
        y = y + vals[2]
    return y


def node_plan(n: Node, hw, splits: int = 0):
    """The plan the kernel takes at a node's shapes: x contiguous, the
    weight read as the impl reads it (a LINEAR's (out, in) weight through
    its transposed view, K-contiguous; a MATMUL's (K, N) weight
    N-contiguous), both 16-byte aligned."""
    m, k, nn = node_shape(n)
    w = n.inputs[1].spec.shape
    kmajor = n.op is OpKind.LINEAR and w[0] == n.attrs["out_features"]
    ldb_k, ldb_n = (1, k) if kmajor else (nn, 1)
    return plan(m, nn, k, k, ldb_k, ldb_n, sms=hw.sms,
                itemsize=2 if n.spec.dtype != "float32" else 4,
                splits=splits)


def mm_tune_space(n: Node, hw) -> List[Tuple[int]]:
    """K splits around the plan's own: 1, the plan's, half and twice it,
    each keeping a chunk of at least the kernel's least K chunk
    (``TC_MIN_K_CHUNK``, or ``SKINNY_MIN_K_CHUNK`` of the streamed
    operand's layout) unless it is 1 or the plan's; the configs are the
    distinct split counts those give."""
    p = node_plan(n, hw)
    k = node_shape(n)[1]
    least = (TC_MIN_K_CHUNK if p.kernel == "tensor_core"
             else SKINNY_MIN_K_CHUNK[p.big_kmajor])
    want = {1, p.splits, max(1, p.splits // 2), 2 * p.splits}
    out = set()
    for s in want:
        if s in (1, p.splits) or -(-k // s) >= least:
            out.add(node_plan(n, hw, s).splits)
    return [(s,) for s in sorted(out)]


def _supports_matmul(n: Node) -> bool:
    return (len(n.inputs) >= 2 and len(n.inputs[1].spec.shape) == 2
            and len(n.inputs[0].spec.shape) >= 2
            and same_float(n, n.inputs[:2]))


def _supports_linear(n: Node) -> bool:
    return _supports_matmul(n) and "out_features" in n.attrs


def mm_refine_space(n: Node, hw, cfg) -> List[Tuple[int]]:
    """Half and twice the winning split count, as the plan makes them."""
    s = int(cfg[0])
    return [(node_plan(n, hw, c).splits,) for c in (max(1, s // 2), 2 * s)]


_MM_TUNABLE = Tunable(ATTR, mm_tune_space, refine=mm_refine_space)

registry.register_shared_impl(
    OpKind.MATMUL, _matmul_impl, name="cuda.matmul", requires=("cuda",),
    supports=_supports_matmul, tunable=_MM_TUNABLE)
registry.register_shared_impl(
    OpKind.LINEAR, _linear_impl, name="cuda.linear", requires=("cuda",),
    supports=_supports_linear, tunable=_MM_TUNABLE)

"""SOL graph intermediate representation.

The paper's IR has two properties we reproduce exactly:

1. **Purpose-tagged dimensions** (Sec. II-C): a tensor dim is not a bare
   integer index but a (purpose, index) pair — ``N0`` (batch), ``C0``
   (channel), ``P1``/``P0`` (pixels), ``F0`` (features/sequence).  A tensor in
   NCHW is ``[N0, C0, P1, P0]``; in NHWC it is ``[N0, P1, P0, C0]``.  Layers
   select dims by purpose (e.g. a normalization normalizes "all channel dims")
   which makes every layer implementation layout-independent.

2. **Coarse, layer-level nodes**: SOL's IR nodes are layers (Conv, Linear,
   ReLU, MaxPool, ...), not scalar ops.  High-level mathematical
   optimizations (ReLU⊕MaxPool folding etc.) operate on this granularity;
   each node is later assigned to an optimizing module (DFP or DNN).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Purpose(enum.Enum):
    """Dimension purposes, following the paper's None/Channel/Pixel tagging."""

    NONE = "N"      # batch-like, never vectorized over
    CHANNEL = "C"   # feature channels
    PIXEL = "P"     # spatial
    FEATURE = "F"   # flat features / sequence positions


@dataclasses.dataclass(frozen=True)
class Dim:
    """A purpose-tagged dimension: ``Dim(Purpose.CHANNEL, 0)`` renders as C0."""

    purpose: Purpose
    index: int

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.purpose.value}{self.index}"


# Common layouts --------------------------------------------------------------
def NCHW() -> Tuple[Dim, ...]:
    return (Dim(Purpose.NONE, 0), Dim(Purpose.CHANNEL, 0),
            Dim(Purpose.PIXEL, 1), Dim(Purpose.PIXEL, 0))


def NHWC() -> Tuple[Dim, ...]:
    return (Dim(Purpose.NONE, 0), Dim(Purpose.PIXEL, 1),
            Dim(Purpose.PIXEL, 0), Dim(Purpose.CHANNEL, 0))


def NF() -> Tuple[Dim, ...]:
    return (Dim(Purpose.NONE, 0), Dim(Purpose.FEATURE, 0))


def BSD() -> Tuple[Dim, ...]:
    """Sequence layout (batch, positions, channels) for the sequence models."""
    return (Dim(Purpose.NONE, 0), Dim(Purpose.FEATURE, 0),
            Dim(Purpose.CHANNEL, 0))


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: str = "float32"
    dims: Tuple[Dim, ...] = ()

    def __post_init__(self):
        if self.dims and len(self.dims) != len(self.shape):
            raise ValueError(
                f"dims {self.dims} do not match shape rank {self.shape}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def dim_of(self, purpose: Purpose) -> List[int]:
        """Positions of all dims with the given purpose (layout-independent
        dim selection — the paper's 'automatically select all channel
        dimensions' mechanism)."""
        return [i for i, d in enumerate(self.dims) if d.purpose is purpose]


class OpKind(enum.Enum):
    # DNN-module candidates (compute-bound → vendor-library / MXU path)
    LINEAR = "linear"
    CONV2D = "conv2d"
    MATMUL = "matmul"
    ATTENTION = "attention"       # (q, k, v) scaled-dot-product attention
    DECODE_ATTENTION = "decode_attention"  # 1 query vs a paged KV cache
    RGLRU_SCAN = "rglru_scan"     # gated linear recurrence h_t = a·h + b
    RWKV6_SCAN = "rwkv6_scan"     # RWKV6 WKV recurrence
    # DFP-module ops (memory-bound → fused depth-first code)
    RELU = "relu"
    GELU = "gelu"
    SILU = "silu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    EXP = "exp"
    SOFTPLUS = "softplus"
    SQRT = "sqrt"             # optional 'min' attr clamps before the root
    TIME_SHIFT = "time_shift" # prev-token features along axis 1 (zeros at t=0)
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"
    BIAS_ADD = "bias_add"
    SCALE = "scale"
    SOFTCAP = "softcap"
    MAXPOOL = "maxpool"
    AVGPOOL = "avgpool"
    GLOBALPOOL = "globalpool"
    BATCHNORM = "batchnorm"
    LAYERNORM = "layernorm"
    RMSNORM = "rmsnorm"
    SOFTMAX = "softmax"
    DROPOUT = "dropout"       # identity at inference; masks in training
    FLATTEN = "flatten"
    RESHAPE = "reshape"
    TRANSPOSE = "transpose"
    REORDER = "reorder"       # layout change inserted by the layout pass
    IDENTITY = "identity"
    # structural
    INPUT = "input"
    PARAM = "param"
    CONST = "const"           # materialized constant: attrs['fill'] + spec
    OUTPUT = "output"
    FUSED = "fused"           # a DFP fusion group (post-fusion-pass node)


# Which OpKinds are elementwise-ish and therefore DFP-fusable.
DFP_FUSABLE = {
    OpKind.RELU, OpKind.GELU, OpKind.SILU, OpKind.SIGMOID, OpKind.TANH,
    OpKind.EXP, OpKind.SOFTPLUS, OpKind.SQRT, OpKind.ADD, OpKind.SUB,
    OpKind.MUL, OpKind.DIV,
    OpKind.BIAS_ADD, OpKind.SCALE, OpKind.SOFTCAP, OpKind.LAYERNORM,
    OpKind.RMSNORM, OpKind.SOFTMAX, OpKind.BATCHNORM, OpKind.DROPOUT,
    OpKind.IDENTITY, OpKind.MAXPOOL, OpKind.AVGPOOL, OpKind.GLOBALPOOL,
}

# Graph-level sequence kernels: never DFP-fused, always elected as whole
# nodes through the dispatch table (attention + linear-recurrence scans).
SEQUENCE_OPS = {OpKind.ATTENTION, OpKind.DECODE_ATTENTION,
                OpKind.RGLRU_SCAN, OpKind.RWKV6_SCAN}

# Source nodes carry no inputs; everything else must have at least one.
SOURCE_OPS = {OpKind.INPUT, OpKind.PARAM, OpKind.CONST}


class Module(enum.Enum):
    """The paper's two optimizing modules."""

    DFP = "dfp"   # depth-first parallelism: fused, cache/VMEM-resident
    DNN = "dnn"   # vendor-library / MXU path


_node_counter = itertools.count()


@dataclasses.dataclass
class Node:
    op: OpKind
    inputs: List["Node"]
    spec: TensorSpec
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    name: str = ""
    module: Optional[Module] = None          # set by assign_modules pass
    layout: Optional[str] = None             # set by layout pass
    impl: Optional[str] = None               # Impl name elected by
                                             # passes.elect_implementations
    impl_bwd: Optional[str] = None           # backward Impl name elected by
                                             # passes.elect_grad_implementations
    # for FUSED nodes: the ordered list of original nodes in the group
    body: List["Node"] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.name:
            self.name = f"{self.op.value}_{next(_node_counter)}"

    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other: object) -> bool:
        return self is other

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        mod = f":{self.module.value}" if self.module else ""
        return f"<{self.name}{mod} {self.spec.shape}>"


@dataclasses.dataclass
class Graph:
    """A SOL computation graph: inputs → nodes → outputs, plus named params."""

    inputs: List[Node]
    outputs: List[Node]
    params: Dict[str, Node]

    def topo(self) -> List[Node]:
        seen: Dict[int, bool] = {}
        order: List[Node] = []

        def visit(n: Node) -> None:
            if id(n) in seen:
                return
            seen[id(n)] = True
            for i in n.inputs:
                visit(i)
            order.append(n)

        for o in self.outputs:
            visit(o)
        return order

    def nodes_of(self, *kinds: OpKind) -> List[Node]:
        ks = set(kinds)
        return [n for n in self.topo() if n.op in ks]

    def consumers(self) -> Dict[Node, List[Node]]:
        cons: Dict[Node, List[Node]] = {}
        for n in self.topo():
            for i in n.inputs:
                cons.setdefault(i, []).append(n)
        return cons

    def replace(self, old: Node, new: Node) -> None:
        """Rewire every consumer of ``old`` to consume ``new`` — including
        consumers buried in FUSED bodies, which live outside ``topo()`` (a
        fusion group's side input must stay in sync with the body node that
        reads it, or the group's local environment dangles)."""
        for n in self.topo():
            n.inputs = [new if i is old else i for i in n.inputs]
            for b in n.body:
                b.inputs = [new if i is old else i for i in b.inputs]
        self.outputs = [new if o is old else o for o in self.outputs]

    def validate(self) -> None:
        """Graph invariants (used by property tests)."""
        order = self.topo()
        pos = {id(n): i for i, n in enumerate(order)}
        for n in order:
            for i in n.inputs:
                assert pos[id(i)] < pos[id(n)], f"cycle at {n}"
        for o in self.outputs:
            assert id(o) in pos
        for n in order:
            if n.op not in SOURCE_OPS:
                assert n.inputs, f"non-source node {n} without inputs"

    def stats(self) -> Dict[str, int]:
        order = self.topo()
        return {
            "nodes": len(order),
            "dfp": sum(1 for n in order if n.module is Module.DFP),
            "dnn": sum(1 for n in order if n.module is Module.DNN),
            "fused_groups": sum(1 for n in order if n.op is OpKind.FUSED),
            "reorders": sum(1 for n in order if n.op is OpKind.REORDER),
            "elected": sum(1 for n in order if n.impl is not None),
        }


# -- builders ------------------------------------------------------------------

def input_node(shape: Sequence[int], dtype: str = "float32",
               dims: Tuple[Dim, ...] = (), name: str = "") -> Node:
    return Node(OpKind.INPUT, [], TensorSpec(tuple(shape), dtype, dims),
                name=name or "input")


def param_node(shape: Sequence[int], dtype: str = "float32",
               name: str = "param") -> Node:
    return Node(OpKind.PARAM, [], TensorSpec(tuple(shape), dtype), name=name)


def const_node(shape: Sequence[int], fill: float = 0.0,
               dtype: str = "float32", name: str = "") -> Node:
    """A materialized fill-constant (zero recurrence states, unit norm gains
    ...) — a source node the executor binds without framework storage."""
    return Node(OpKind.CONST, [], TensorSpec(tuple(shape), dtype),
                attrs={"fill": float(fill)}, name=name or "const")

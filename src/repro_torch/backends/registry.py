"""SOL device backends and the per-op dispatch table (counterpart of
``repro.backends.registry``).

Each (backend, OpKind) pair maps to a list of :class:`Impl` entries and the
executor resolves ``node → impl`` through a fallback chain:

  tier 0  backend-specific kernel   (``register_impl(backend, op, fn)``)
  tier 1  shared hand-written kernel (``register_shared_impl`` — admitted
                                     only when the impl's ``requires``
                                     capabilities are a subset of the
                                     backend's; the Hopper kernels sit here,
                                     gated on ``"cuda"``)
  tier 2  PyTorch reference         (``register_reference_impl`` — always
                                     available; registered by core.executor)

Three backends: ``torch_ref`` (capabilities ``{"torch"}``, the reference
tier only — the counterpart of ``xla``; it runs wherever its tensors are),
``h100`` (``{"torch", "cuda"}`` — the counterpart of ``pallas_tpu``) and
``host_cpu`` (``backends/host_cpu.py``: two tier-0 impls on the host,
registered through this table alone).

Backward (grad) tables sit beside the forward ones, with the same
:class:`Impl`, tiers and capability gating; a grad impl's ``fn`` follows
:data:`GradFn` and its measurements live under the ``_bwd`` cache key
(:func:`grad_cache_op`), so a node's forward and backward elections are
independent.

Peaks by unit.  The election costs every FLOP at the bf16 tensor-core
peak, as the JAX package does (``HardwareSpec.compute_s``'s default unit),
so elections equal its elections.  A speed-of-light bound
(``core.sol``) takes each FLOP at the peak of the unit that runs it
(:data:`UNITS`): each :class:`Impl` says which unit runs a node.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.autotune import Tunable, node_shape
from ..core.ir import Node, OpKind

# the compute units a node's FLOPs can run on: f32 outside the tensor cores,
# f32-accurate products as three TF32 passes, and bf16/f16 tensor cores
UNITS = ("simt", "tf32x3", "tensor16")
HALF_DTYPES = ("bfloat16", "float16")


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants of one device.  The TPU spec's ``vmem_bytes``,
    ``mxu_dim``, ``lanes`` and ``sublanes`` become what bounds a CUDA block
    here: shared memory per block, the wgmma tile, the warp and the SM
    count."""

    name: str
    peak_flops_bf16: float        # FLOP/s, dense tensor cores
    peak_flops_f32: float         # FLOP/s, f32 outside the tensor cores
    peak_flops_tf32: float        # FLOP/s, dense TF32 tensor cores
    hbm_bandwidth: float          # bytes/s
    link_bandwidth: float         # bytes/s per NVLink direction
    hbm_bytes: int                # device memory
    smem_bytes: int               # shared memory one block may use
    mma_dim: int = 64             # wgmma tile rows
    warp: int = 32                # threads per warp
    sms: int = 132                # streaming multiprocessors

    def peak_flops(self, unit: str) -> float:
        """The peak FLOP/s of one of :data:`UNITS`."""
        if unit == "simt":
            return self.peak_flops_f32
        if unit == "tf32x3":
            return self.peak_flops_tf32 / 3.0
        if unit == "tensor16":
            return self.peak_flops_bf16
        raise ValueError(f"unknown compute unit {unit!r}; have {UNITS}")

    def compute_s(self, flops: float, unit: str = "tensor16") -> float:
        """FLOPs over the peak of ``unit``; by default the bf16 peak (the
        election's cost, the JAX package's)."""
        return flops / self.peak_flops(unit)

    def memory_s(self, nbytes: float) -> float:
        return nbytes / self.hbm_bandwidth

    def collective_s(self, nbytes: float) -> float:
        return nbytes / self.link_bandwidth

    def roofline_s(self, flops: float, nbytes: float,
                   link_bytes: float = 0.0,
                   unit: str = "tensor16") -> float:
        """Time lower bound: the dominant of compute (at ``unit``'s peak,
        by default the bf16 peak) / memory / links."""
        return max(self.compute_s(flops, unit), self.memory_s(nbytes),
                   self.collective_s(link_bytes))


# NVIDIA H100 data sheet, dense rates.  SXM5: 989 TFLOP/s bf16, 495 TF32,
# 67 TFLOP/s f32 (no tensor cores), 3.35 TB/s HBM3, 80 GB, 132 SMs, 227 KiB
# of shared memory per block, NVLink 900 GB/s (450 each way).
H100_SXM = HardwareSpec(
    name="h100_sxm", peak_flops_bf16=989e12, peak_flops_f32=67e12,
    peak_flops_tf32=495e12, hbm_bandwidth=3.35e12, link_bandwidth=450e9,
    hbm_bytes=80 * 1024 ** 3, smem_bytes=227 * 1024, sms=132)

# PCIe card: 756 TFLOP/s bf16, 378 TF32, 51 TFLOP/s f32, 2.0 TB/s HBM2e,
# 114 SMs.
H100_PCIE = HardwareSpec(
    name="h100_pcie", peak_flops_bf16=756e12, peak_flops_f32=51e12,
    peak_flops_tf32=378e12, hbm_bandwidth=2.0e12, link_bandwidth=300e9,
    hbm_bytes=80 * 1024 ** 3, smem_bytes=227 * 1024, sms=114)


# The host, as the JAX package's ``HOST_CPU`` describes it
# (``repro/backends/registry.py``): ~0.2 TFLOP/s, 40 GB/s DRAM, 64 GiB; its
# VMEM slice (the last-level cache share, 32 MiB) stands where a block's
# shared memory does, its 16-wide tile, 16 lanes and one sublane where the
# wgmma tile, the warp and the SM count do.  It has no tensor cores, so
# every unit runs at the one peak (the 3xTF32 unit's third of it included).
HOST_CPU = HardwareSpec(
    name="host_cpu", peak_flops_bf16=0.2e12, peak_flops_f32=0.2e12,
    peak_flops_tf32=3 * 0.2e12, hbm_bandwidth=40e9, link_bandwidth=10e9,
    hbm_bytes=64 * 1024 ** 3, smem_bytes=32 * 1024 ** 2, mma_dim=16,
    warp=16, sms=1)


def h100_spec(device_name: str) -> HardwareSpec:
    """The spec matching a CUDA device name (PCIe values when it says so)."""
    return H100_PCIE if "pcie" in device_name.lower() else H100_SXM


def library_unit(shape: Tuple[int, ...], dtype: str) -> str:
    """The unit of a library product in its own dtype: bf16/f16 on the
    tensor cores, f32 outside them (the port keeps TF32 off)."""
    return "tensor16" if dtype in HALF_DTYPES else "simt"


# ---------------------------------------------------------------------------
# per-op implementations
# ---------------------------------------------------------------------------

# fn(node, vals, backend) -> Tensor; vals are the lowered inputs of the node
# (for FUSED nodes: the side inputs, in node.inputs order).
ImplFn = Callable[[Node, Sequence[Any], "Backend"], Any]
# fn(node, (vals, out), ct, backend) -> one cotangent per input of the node
# (None where the input is an integer or gets no gradient); the residuals
# are the node's inputs and its forward output
GradFn = Callable[[Node, Tuple[Sequence[Any], Any], Any, "Backend"],
                  Sequence[Any]]
# unit(shape, dtype) -> one of UNITS, from the node's autotune key shape
# (``core.autotune.node_shape``) and dtype, so a cache entry's bucket and a
# live node answer alike
UnitFn = Callable[[Tuple[int, ...], str], str]

TIER_BACKEND = 0      # backend-specific kernel
TIER_SHARED = 1       # shared hand-written kernel (capability-gated)
TIER_REFERENCE = 2    # PyTorch reference lowering


@dataclasses.dataclass(frozen=True)
class Impl:
    """One implementation 'flavour' of an op."""

    name: str                                    # e.g. "cuda.dfp_fused"
    op: OpKind
    fn: ImplFn
    tier: int
    requires: frozenset = frozenset()            # backend capabilities needed
    supports: Optional[Callable[[Node], bool]] = None   # per-node capability
    backend: Optional[str] = None                # tier-0 owner; None = any
    # 'streamed' impls touch memory once per input/output (depth-first);
    # 'roundtrip' impls materialize every intermediate
    memory: str = "streamed"
    tunable: Optional[Tunable] = None
    unit: Optional[UnitFn] = None                # None: "simt"

    def unit_at(self, shape: Optional[Tuple[int, ...]], dtype: str) -> str:
        """The unit that runs this impl at a node's key shape and dtype."""
        return self.unit(shape, dtype) if self.unit and shape else "simt"

    def unit_of(self, node: Node) -> str:
        """The unit that runs this impl on ``node``."""
        return self.unit_at(node_shape(node), node.spec.dtype)

    def admissible(self, backend: "Backend", node: Node) -> bool:
        if self.backend is not None and self.backend != backend.name:
            return False
        if not self.requires <= backend.capabilities:
            return False
        if self.supports is not None and not self.supports(node):
            return False
        return True


_BACKEND_IMPLS: Dict[Tuple[str, OpKind], List[Impl]] = {}
_SHARED_IMPLS: Dict[OpKind, List[Impl]] = {}
_REFERENCE_IMPLS: Dict[OpKind, Impl] = {}
_IMPLS_BY_NAME: Dict[str, Impl] = {}
# the backward tables, parallel to the forward ones
_GRAD_BACKEND_IMPLS: Dict[Tuple[str, OpKind], List[Impl]] = {}
_GRAD_SHARED_IMPLS: Dict[OpKind, List[Impl]] = {}
_GRAD_REFERENCE_IMPLS: Dict[OpKind, Impl] = {}
_GRAD_IMPLS_BY_NAME: Dict[str, Impl] = {}


def _index(impl: Impl) -> Impl:
    _IMPLS_BY_NAME[impl.name] = impl
    return impl


def register_impl(backend: str, op: OpKind, fn: ImplFn, *,
                  name: Optional[str] = None,
                  supports: Optional[Callable[[Node], bool]] = None,
                  memory: str = "streamed",
                  tunable: Optional[Tunable] = None) -> Impl:
    """Register a backend-specific implementation (tier 0); newest wins."""
    impl = _index(Impl(name or f"{backend}.{op.value}", op, fn, TIER_BACKEND,
                       supports=supports, backend=backend, memory=memory,
                       tunable=tunable))
    _BACKEND_IMPLS.setdefault((backend, op), []).insert(0, impl)
    return impl


def register_shared_impl(op: OpKind, fn: ImplFn, *, name: str,
                         requires: Sequence[str] = (),
                         supports: Optional[Callable[[Node], bool]] = None,
                         memory: str = "streamed",
                         tunable: Optional[Tunable] = None,
                         unit: Optional[UnitFn] = None) -> Impl:
    """Register a shared kernel (tier 1), admitted for any backend whose
    capabilities cover ``requires``."""
    impl = _index(Impl(name, op, fn, TIER_SHARED,
                       requires=frozenset(requires), supports=supports,
                       memory=memory, tunable=tunable, unit=unit))
    _SHARED_IMPLS.setdefault(op, []).insert(0, impl)
    return impl


def register_reference_impl(op: OpKind, fn: ImplFn, *,
                            name: Optional[str] = None,
                            memory: str = "streamed",
                            unit: Optional[UnitFn] = None) -> Impl:
    """Register the always-available PyTorch reference (tier 2)."""
    impl = _index(Impl(name or f"ref.{op.value}", op, fn, TIER_REFERENCE,
                       memory=memory, unit=unit))
    _REFERENCE_IMPLS[op] = impl
    return impl


def get_impl(name: str) -> Optional[Impl]:
    _load_entry_points()
    return _IMPLS_BY_NAME.get(name)


_ENTRY_POINTS_STATE = "unloaded"     # unloaded | loading | loaded


def _load_entry_points() -> None:
    """Import the modules that populate the dispatch table: the executor's
    reference lowerings and the kernel entry points (each ops.py registers
    its own impls at import).  A failed import resets the state so the real
    error resurfaces on the next dispatch call."""
    global _ENTRY_POINTS_STATE
    if _ENTRY_POINTS_STATE != "unloaded":
        return
    _ENTRY_POINTS_STATE = "loading"
    try:
        from ..core import executor
        executor._register_reference_impls()
        from ..kernels.avgpool import ops as _ap             # noqa: F401
        from ..kernels.decode_attention import ops as _da    # noqa: F401
        from ..kernels.dfp_fused import ops as _d            # noqa: F401
        from ..kernels.flash_attention import ops as _f      # noqa: F401
        from ..kernels.matmul import ops as _m               # noqa: F401
        from ..kernels.rglru_scan import ops as _rg          # noqa: F401
        from ..kernels.rwkv6_scan import ops as _rw          # noqa: F401
        # backward entry points (each grad.py registers its impls)
        from ..kernels.avgpool import grad as _apg           # noqa: F401
        from ..kernels.decode_attention import grad as _dag  # noqa: F401
        from ..kernels.dfp_fused import grad as _dg          # noqa: F401
        from ..kernels.flash_attention import grad as _fg    # noqa: F401
        from ..kernels.matmul import grad as _mg             # noqa: F401
        from ..kernels.rglru_scan import grad as _rgg        # noqa: F401
        from ..kernels.rwkv6_scan import grad as _rwg        # noqa: F401
    except BaseException:
        _ENTRY_POINTS_STATE = "unloaded"
        raise
    _ENTRY_POINTS_STATE = "loaded"


def tunables_for(op: OpKind) -> List[Tunable]:
    """Every Tunable any impl (any backend, any tier) declares for ``op`` —
    the election pass clears all of them before pinning."""
    _load_entry_points()
    out: List[Tunable] = []
    for (_b, o), impls in _BACKEND_IMPLS.items():
        if o is op:
            out += [i.tunable for i in impls if i.tunable is not None]
    out += [i.tunable for i in _SHARED_IMPLS.get(op, ())
            if i.tunable is not None]
    return out


def candidates(backend: "Backend", node: Node) -> List[Impl]:
    """All admissible impls for (backend, node) in fallback-chain order:
    backend-specific → shared → reference."""
    _load_entry_points()
    out: List[Impl] = []
    for impl in _BACKEND_IMPLS.get((backend.name, node.op), []):
        if impl.admissible(backend, node):
            out.append(impl)
    for impl in _SHARED_IMPLS.get(node.op, []):
        if impl.admissible(backend, node):
            out.append(impl)
    ref = _REFERENCE_IMPLS.get(node.op)
    if ref is not None and ref.admissible(backend, node):
        out.append(ref)
    return out


def resolve(backend: "Backend", node: Node) -> Impl:
    """First admissible impl in the fallback chain."""
    cands = candidates(backend, node)
    if not cands:
        raise NotImplementedError(
            f"no implementation of {node.op} for backend {backend.name!r}")
    return cands[0]


# ---------------------------------------------------------------------------
# backward implementations
# ---------------------------------------------------------------------------

GRAD_SUFFIX = "_bwd"


def grad_cache_op(op: OpKind) -> str:
    """The autotune-cache op key of ``op``'s backward impls, suffixed so
    backward timings and configs never collide with the forward's."""
    return f"{op.value}{GRAD_SUFFIX}"


def register_grad_impl(backend: str, op: OpKind, fn: GradFn, *,
                       name: Optional[str] = None,
                       supports: Optional[Callable[[Node], bool]] = None,
                       memory: str = "streamed",
                       tunable: Optional[Tunable] = None,
                       unit: Optional[UnitFn] = None) -> Impl:
    """Register a backend-specific backward impl (tier 0)."""
    impl = Impl(name or f"{backend}.{op.value}{GRAD_SUFFIX}", op, fn,
                TIER_BACKEND, supports=supports, backend=backend,
                memory=memory, tunable=tunable, unit=unit)
    _GRAD_IMPLS_BY_NAME[impl.name] = impl
    _GRAD_BACKEND_IMPLS.setdefault((backend, op), []).insert(0, impl)
    return impl


def register_shared_grad_impl(
        op: OpKind, fn: GradFn, *, name: str, requires: Sequence[str] = (),
        supports: Optional[Callable[[Node], bool]] = None,
        memory: str = "streamed", tunable: Optional[Tunable] = None,
        unit: Optional[UnitFn] = None) -> Impl:
    """Register a shared backward impl (tier 1, capability-gated)."""
    impl = Impl(name, op, fn, TIER_SHARED, requires=frozenset(requires),
                supports=supports, memory=memory, tunable=tunable, unit=unit)
    _GRAD_IMPLS_BY_NAME[impl.name] = impl
    _GRAD_SHARED_IMPLS.setdefault(op, []).insert(0, impl)
    return impl


def register_reference_grad_impl(op: OpKind, fn: GradFn, *,
                                 name: Optional[str] = None,
                                 memory: str = "roundtrip") -> Impl:
    """Register the always-available backward reference (tier 2), usually
    autograd of the forward reference recomputed from the primals
    (``core.executor.reference_vjp_grad``)."""
    impl = Impl(name or f"ref.{op.value}{GRAD_SUFFIX}", op, fn,
                TIER_REFERENCE, memory=memory)
    _GRAD_IMPLS_BY_NAME[impl.name] = impl
    _GRAD_REFERENCE_IMPLS[op] = impl
    return impl


def get_grad_impl(name: str) -> Optional[Impl]:
    _load_entry_points()
    return _GRAD_IMPLS_BY_NAME.get(name)


def grad_tunables_for(op: OpKind) -> List[Tunable]:
    """Every Tunable any backward impl declares for ``op`` (the backward
    election clears all of them before pinning its winner's)."""
    _load_entry_points()
    out: List[Tunable] = []
    for (_b, o), impls in _GRAD_BACKEND_IMPLS.items():
        if o is op:
            out += [i.tunable for i in impls if i.tunable is not None]
    out += [i.tunable for i in _GRAD_SHARED_IMPLS.get(op, ())
            if i.tunable is not None]
    return out


def grad_candidates(backend: "Backend", node: Node) -> List[Impl]:
    """Admissible backward impls for (backend, node): backend-specific
    first, then shared.

    The reference backward is a candidate only when no kernel-tier
    backward is admissible: it materializes what the kernels exist to
    avoid (the S×S attention matrix, every recurrent state), so a timing
    race at small shapes would elect it and then exhaust device memory at
    real ones.  Alone, it keeps every op differentiable on every
    backend."""
    _load_entry_points()
    out: List[Impl] = []
    for impl in _GRAD_BACKEND_IMPLS.get((backend.name, node.op), []):
        if impl.admissible(backend, node):
            out.append(impl)
    for impl in _GRAD_SHARED_IMPLS.get(node.op, []):
        if impl.admissible(backend, node):
            out.append(impl)
    if not out:
        ref = _GRAD_REFERENCE_IMPLS.get(node.op)
        if ref is not None and ref.admissible(backend, node):
            out.append(ref)
    return out


def resolve_grad(backend: "Backend", node: Node) -> Optional[Impl]:
    """The first admissible backward impl, or None: an op with no
    registered backward is differentiated by autograd through its forward
    impl's torch ops."""
    cands = grad_candidates(backend, node)
    return cands[0] if cands else None


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    hw: HardwareSpec
    # layout preferences — the paper's per-device layout election
    linear_weight_layout: str     # 'oi' (out,in) vs 'io' (in,out)
    conv_layout: str              # 'nchw' vs 'nhwc'
    capabilities: frozenset = frozenset({"torch"})
    # mesh qualifier for the autotune cache (set by the mesh slice)
    shard_tag: str = ""
    # the one device type the backend runs on (None: wherever its
    # tensors are); ``compile_graph`` places a model there by default
    device_type: Optional[str] = None

    @property
    def cache_name(self) -> str:
        """The autotune-cache backend key: ``name`` on one device,
        ``name@shard_tag`` under a mesh."""
        return f"{self.name}@{self.shard_tag}" if self.shard_tag else self.name

    def preferred_layout(self, node: Node) -> str:
        if node.op in (OpKind.LINEAR, OpKind.MATMUL):
            return self.linear_weight_layout
        return self.conv_layout   # convs and DFP ops follow the data layout

    def candidates(self, node: Node) -> List[Impl]:
        return candidates(self, node)

    def resolve(self, node: Node) -> Impl:
        return resolve(self, node)


_REGISTRY: Dict[str, Backend] = {}


def register_backend(b: Backend) -> Backend:
    _REGISTRY[b.name] = b
    return b


def get_backend(name: str) -> Backend:
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def set_layout_preference(name: str, *, linear: Optional[str] = None,
                          conv: Optional[str] = None) -> Backend:
    """Session-scoped layout override: re-register ``name`` with measured
    layout winners (``repro_torch.benchmarks.layouts --apply``)."""
    b = get_backend(name)
    return register_backend(dataclasses.replace(
        b,
        linear_weight_layout=linear or b.linear_weight_layout,
        conv_layout=conv or b.conv_layout))


def available_backends() -> Dict[str, Backend]:
    return dict(_REGISTRY)


def for_device(backend: Backend, device: Any) -> Backend:
    """``backend`` with the spec of the H100 at ``device`` (PCIe values on
    a PCIe card, by its name): where a server, a compiled graph and a SOL
    bound on a CUDA device read the card's spec.  Off CUDA, or for a
    backend whose spec is not an H100's, ``backend`` itself."""
    if getattr(device, "type", None) != "cuda" or \
            backend.hw not in (H100_SXM, H100_PCIE):
        return backend
    import torch
    hw = h100_spec(torch.cuda.get_device_name(device))
    return backend if hw == backend.hw else dataclasses.replace(backend,
                                                                hw=hw)


# The reference backend: every node runs as PyTorch ops on whatever device
# its tensors are on (the counterpart of ``xla``).
register_backend(Backend(
    name="torch_ref",
    hw=H100_SXM,
    linear_weight_layout="oi",   # paper: (out,in) — torch's own layout
    conv_layout="nchw",
    capabilities=frozenset({"torch"}),
))

# The Hopper backend: the hand-written CUDA/Triton kernels at the shared
# tier (the counterpart of ``pallas_tpu``).
register_backend(Backend(
    name="h100",
    hw=H100_SXM,
    linear_weight_layout="io",   # kernels contract K-major; the wrapper
    conv_layout="nhwc",          # reads (out,in) weights through strides
    capabilities=frozenset({"torch", "cuda"}),
))

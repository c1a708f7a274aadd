"""sol.deploy — deployment mode (paper Sec. III-C; counterpart of
``repro.frontends.deploy``): the optimized network as an artifact that
runs without the frontend or the SOL compiler.

The JAX package exports StableHLO; the port exports a ``torch.export``
program.  The artifact is a zip (stored, not compressed) with:

* ``graph.pt2``       — ``torch.export.save`` of a non-strict export of
  ``fn(params, *xs)``, the graph lowered afresh on its elected impls; the
  params are inputs, so the graph holds no weights.  Every kernel the
  election chose appears as a call of its ``repro_torch::*`` custom op
  (``kernels/library.py``) with its pinned config as literal arguments;
  the reference tier's torch ops appear as themselves;
* ``params/<i>.npy``  — one ``.npy`` a parameter leaf, in flatten order
  (params may be any nested dict; the manifest's tree rebuilds it).  NumPy
  has no bfloat16, so a bf16 leaf is stored as its ``uint16`` bit pattern;
* ``manifest.json``   — ``schema``, the parameter ``tree`` (shape, dtype
  and leaf index of each leaf), the graph's ``inputs`` (shape, dtype), the
  ``format`` (``"torch.export"``), the ``device_type`` it was exported
  on, and the ``elections`` of the exported graph (histogram, ``by_op``,
  ``provenance``, ``pinned``), so ``DeployedModel.impl_report`` answers
  as ``SolModel.impl_report`` does and a server audits either alike.

An exported graph asserts the device of each input, so an artifact runs on
the device type it was exported on; loading it for another raises.
Loading stages every parameter exactly once, through
``runtime.packed.transfer``; each call reuses the staged tensors.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.executor import TORCH_DTYPES, lower_graph
from ..kernels import library  # noqa: F401  (registers the repro_torch ops)
from ..runtime import packed
from .offload import DeviceLike, api as device_api, resolve_device
from .optimize import SolModel

MANIFEST_SCHEMA = 2
FORMAT = "torch.export"
GRAPH = "graph.pt2"

# an input of the exported function: (shape, dtype)
InputSpec = Tuple[Sequence[int], torch.dtype]


def deploy(sol_model: SolModel,
           input_shape: Optional[Tuple[int, ...]] = None,
           dtype: torch.dtype = torch.float32) -> bytes:
    """Serialize weights, the lowered graph and the election metadata into
    one artifact.  With ``input_shape=None`` the input specs (shapes and
    dtypes, e.g. the decode program's int32 ``lens``) come from the graph's
    input nodes, as multi-input graphs need.  A ``training=True`` model
    exports its forward program."""
    if getattr(sol_model, "mesh", None) is not None:
        raise RuntimeError(
            "deploy: mesh-compiled SolModels cannot be exported: the "
            "artifact stages its params onto one device and the graph's "
            "specs are per-shard shapes; compile with mesh=None for an "
            "artifact, or serve the mesh model live")
    g = sol_model.graph
    elections = {
        "elections": dict(getattr(g, "elections", {})),
        "by_op": {op: dict(v) for op, v in
                  getattr(g, "elections_by_op", {}).items()},
        "provenance": {k: dict(v) for k, v in
                       getattr(g, "election_provenance", {}).items()},
        "pinned": {k: [list(c) for c in v] for k, v in
                   getattr(g, "election_pinned", {}).items()},
    }
    if input_shape is not None:
        specs = [(tuple(input_shape), dtype)]
    else:
        specs = [(tuple(i.spec.shape), TORCH_DTYPES[i.spec.dtype])
                 for i in g.inputs]
    # a fresh lowering: the live function's CONST cache would otherwise
    # keep export's fake tensors and hand them to the live model's next call
    fn = lower_graph(g, sol_model.backend)
    return export_fn(fn, sol_model._params_for_call(), *specs,
                     elections=elections, device=sol_model.device)


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``forward(params, *xs)``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, params, *xs):
        return self.fn(params, *xs)


def export_fn(fn, params: Dict[str, Any], *x_specs: InputSpec,
              elections: Optional[Dict[str, Any]] = None,
              device: DeviceLike = None) -> bytes:
    """Export ``fn(params, *xs)`` with ``params``, any nested dict of
    tensors or arrays, and ``xs`` of the given (shape, dtype) specs into
    the artifact format.  ``device``: where the graph is traced (default:
    the first leaf's device, else the card unless ``device_api`` was set
    to the CPU).  ``deploy`` is the ``SolModel`` front door; this is the
    general entry point."""
    params = _tensors(params)
    if device is None:
        first = next(iter(_flat(params)), None)
        device = first.device if first is not None else None
    dev = resolve_device(device)
    xs = [torch.zeros(tuple(shape), dtype=dtype, device=dev)
          for shape, dtype in x_specs]
    ep = torch.export.export(_Program(fn), (params, *xs), strict=False)
    # the saved program would carry its example inputs, params included,
    # and each node's Python stack trace
    ep.example_inputs = None
    for node in ep.graph.nodes:
        node.meta.pop("stack_trace", None)
    graph = io.BytesIO()
    torch.export.save(ep, graph)

    leaves: List[torch.Tensor] = []
    tree = _tree_spec(params, leaves)
    manifest = {"schema": MANIFEST_SCHEMA, "format": FORMAT,
                "device_type": dev.type, "tree": tree,
                "inputs": [{"shape": list(x.shape),
                            "dtype": str(x.dtype).removeprefix("torch.")}
                           for x in xs],
                "elections": elections or {}}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr(GRAPH, graph.getvalue())
        for i, t in enumerate(leaves):
            with z.open(f"params/{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _host_array(t),
                                          allow_pickle=False)
        z.writestr("manifest.json", json.dumps(manifest))
    return buf.getvalue()


def _tensors(p):
    """The params tree with every leaf a tensor without autograd history."""
    if isinstance(p, dict):
        return {k: _tensors(v) for k, v in p.items()}
    if isinstance(p, torch.Tensor):
        return p.detach()
    return torch.from_numpy(np.array(p))


def _flat(p):
    if isinstance(p, dict):
        for v in p.values():
            yield from _flat(v)
    else:
        yield p


def _tree_spec(p, leaves: List[torch.Tensor]):
    """Mirror the params tree as JSON; each leaf becomes ``{"__leaf__":
    index, shape, dtype}`` and joins ``leaves`` in insertion order."""
    if isinstance(p, dict):
        return {k: _tree_spec(v, leaves) for k, v in p.items()}
    leaves.append(p)
    return {"__leaf__": len(leaves) - 1, "shape": list(p.shape),
            "dtype": str(p.dtype).removeprefix("torch.")}


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A leaf on the host as numpy: bf16 as its uint16 bit pattern."""
    t = t.detach().cpu().contiguous()
    if t.dtype is torch.bfloat16:
        t = t.view(torch.uint16)
    return t.numpy()


def _tree_build(spec, staged: List[torch.Tensor]):
    """The params tree of the staged leaves; a bf16 leaf, staged as its
    uint16 bits, viewed back as bf16."""
    if isinstance(spec, dict) and isinstance(spec.get("__leaf__"), int):
        t = staged[spec["__leaf__"]]
        return t.view(torch.bfloat16) if spec["dtype"] == "bfloat16" else t
    return {k: _tree_build(v, staged) for k, v in spec.items()}


def _count_leaves(spec) -> int:
    if isinstance(spec, dict) and isinstance(spec.get("__leaf__"), int):
        return 1
    return sum(_count_leaves(v) for v in spec.values())


def read_manifest(blob: bytes) -> Dict[str, Any]:
    """An artifact's manifest, checked: a JAX artifact (``graph.stablehlo``,
    no ``graph.pt2``), another schema or a missing parameter tree raises
    ``ValueError`` naming the reason."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        names = set(z.namelist())
        if GRAPH not in names:
            if "graph.stablehlo" in names:
                raise ValueError(
                    "artifact holds graph.stablehlo, not graph.pt2: it was "
                    "deployed by the JAX package; deploy the model with "
                    "repro_torch.frontends.deploy")
            raise ValueError(f"artifact has no {GRAPH} member (members: "
                             f"{sorted(names)})")
        manifest = json.loads(z.read("manifest.json"))
    if manifest.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(
            f"artifact manifest schema {manifest.get('schema')!r} != "
            f"{MANIFEST_SCHEMA}: written by an incompatible deploy version; "
            f"re-export the artifact")
    if "tree" not in manifest:
        raise ValueError("artifact manifest has no parameter tree (corrupt "
                         "artifact?)")
    if manifest.get("format") != FORMAT:
        raise ValueError(f"artifact format {manifest.get('format')!r} != "
                         f"{FORMAT!r}")
    return manifest


class DeployedModel:
    """An artifact, loaded: needs torch and the ``repro_torch::*`` ops, not
    the frontend or the compiler.  ``device=None`` is the CUDA card unless
    the CPU was selected; it must be of the device type the artifact was
    exported on.  Parameters are staged once, here."""

    def __init__(self, blob: bytes, device: DeviceLike = None):
        manifest = read_manifest(blob)
        self.device = resolve_device(device)
        if manifest["device_type"] != self.device.type:
            raise ValueError(
                f"artifact was exported on {manifest['device_type']!r} and "
                f"its graph asserts that device type; it cannot run on "
                f"{self.device} (export it on {self.device.type!r})")
        n_leaves = _count_leaves(manifest["tree"])
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            host = [np.load(io.BytesIO(z.read(f"params/{i}.npy")),
                            allow_pickle=False) for i in range(n_leaves)]
            program = torch.export.load(io.BytesIO(z.read(GRAPH)))
        staged = packed.transfer(host, self.device) if host else []
        self.params = _tree_build(manifest["tree"], staged)
        self.staged_leaves = len(staged)
        self.host_bytes = sum(a.nbytes for a in host)
        self.inputs = [(tuple(i["shape"]), TORCH_DTYPES[i["dtype"]])
                       for i in manifest.get("inputs", [])]
        self._elections = manifest.get("elections") or {}
        self._call = program.module()

    @torch.no_grad()
    def __call__(self, *xs) -> Any:
        """The same staged inputs as ``SolModel``, and its outputs; a conv
        runs in full f32, as the executor's reference tier runs it."""
        staged = [device_api.stage_input(x, self.device) for x in xs]
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            y = self._call(self.params, *staged)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        if isinstance(y, (tuple, list)):
            return tuple(device_api.fetch_output(o) for o in y)
        return device_api.fetch_output(y)

    def impl_report(self, by_kind: bool = False,
                    provenance: bool = False) -> Dict[str, Any]:
        """The exported graph's election report, read from the manifest,
        in ``SolModel.impl_report``'s shapes."""
        e = self._elections
        if provenance:
            out = {}
            for name, count in (e.get("elections") or {}).items():
                entry = {"count": count,
                         "sources": dict((e.get("provenance") or {})
                                         .get(name, {}))}
                pins = (e.get("pinned") or {}).get(name)
                if pins:
                    entry["pinned"] = [tuple(c) for c in pins]
                out[name] = entry
            return out
        if by_kind:
            return {op: dict(v) for op, v in (e.get("by_op") or {}).items()}
        return dict(e.get("elections") or {})


def load(blob: bytes, device: DeviceLike = None) -> DeployedModel:
    return DeployedModel(blob, device)

"""sol.optimize — the paper's user-facing entry point (Listing 1):

    sol_model = sol.optimize(py_model, input_shape)
    y = sol_model(x)

The returned :class:`SolModel` is an ``nn.Module`` (Listing 2): its
parameters stay framework-managed — it reads the source module's own
parameter tensors — while ``forward`` runs SOL's elected graph.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from ..backends import Backend, for_device, get_backend
from ..core import passes
from ..core.executor import lower_graph
from .extract import extract
from .offload import DeviceLike, api as device_api, resolve_device


class SolModel(tnn.Module):
    """The custom model SOL injects into the framework (paper Listing 2)."""

    def __init__(self, source: tnn.Module, graph, backend: Backend, fn,
                 device: torch.device, mesh=None):
        super().__init__()
        # a plain attribute, not a submodule: the source owns its parameters
        object.__setattr__(self, "_source", source)
        self.graph = graph
        self.backend = backend
        self._fn = fn
        self.device = device
        self.mesh = mesh
        self._ctx_key: Optional[Tuple] = None
        self._ctx_params: Optional[Dict[str, torch.Tensor]] = None

    def _params_for_call(self) -> Dict[str, torch.Tensor]:
        """Offloading context: parameters are staged to the device once and
        re-staged only when the framework-side values change (every
        in-place update bumps a tensor's version counter) — the paper's
        context caching (Sec. V-A)."""
        named = dict(self._source.named_parameters())
        named.update(self._source.named_buffers())
        params = {k: named[k] for k in self.graph.params}
        key = tuple((id(p), p._version) for p in params.values())
        if self._ctx_params is None or self._ctx_key != key:
            if self.mesh is not None:
                params = {k: self._shard(v.detach(), self.graph.param_specs[k])
                          for k, v in params.items()}
            self._ctx_params = device_api.stage_params(params, self.device)
            self._ctx_key = key
        return self._ctx_params

    def _shard(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of a global tensor under ``spec``."""
        from ..distributed.sharding import shard_slices
        return t[shard_slices(self.mesh, self.mesh.coords, tuple(t.shape),
                              spec)].contiguous()

    def _gather(self, outs, specs) -> list:
        """The whole outputs on every rank, as ``shard_map``'s out_specs
        gather them: every rank's blocks of all outputs in one all-gather
        over the mesh, each laid back at its rank's slices (a block of a
        dim the spec replicates is the same on every rank of that axis)."""
        from ..distributed.sharding import shard_slices
        if all(all(a is None for a in s) for s in specs):
            return list(outs)
        if len({o.dtype for o in outs}) > 1:
            return [self._gather([o], [s])[0] for o, s in zip(outs, specs)]
        mesh = self.mesh
        flat = torch.cat([o.reshape(-1) for o in outs])
        blocks = mesh.all_gather(flat, mesh.axis_names, 0).view(
            mesh.size, -1)
        full = []
        for o, s in zip(outs, specs):
            gshape = tuple(d * mesh.span(a) if a is not None else d
                           for d, a in zip(o.shape, tuple(s) + (None,) * (
                               o.dim() - len(s))))
            full.append(torch.empty(gshape, dtype=o.dtype, device=o.device))
        for r in range(mesh.size):
            coords = mesh.coords_of(r)
            off = 0
            for o, s, g in zip(outs, specs, full):
                n = o.numel()
                g[shard_slices(mesh, coords, g.shape, s)] = \
                    blocks[r, off:off + n].view(o.shape)
                off += n
        return full

    def load_state_dict(self, sd, strict: bool = True, assign: bool = False):
        return self._source.load_state_dict(sd, strict=strict, assign=assign)

    def state_dict(self, *args, **kwargs):
        return self._source.state_dict(*args, **kwargs)

    @torch.no_grad()
    def forward(self, *xs) -> Any:
        params = self._params_for_call()
        staged = [device_api.stage_input(x, self.device) for x in xs]
        if self.mesh is not None:
            staged = [self._shard(x, s)
                      for x, s in zip(staged, self.graph.input_specs)]
        y = self._fn(params, *staged)
        if self.mesh is not None:
            outs = self._gather(y if isinstance(y, tuple) else (y,),
                                self.graph.output_specs)
            y = tuple(outs) if isinstance(y, tuple) else outs[0]
        if isinstance(y, tuple):     # multi-output serving programs
            return tuple(device_api.fetch_output(o) for o in y)
        return device_api.fetch_output(y)

    def stats(self) -> Dict[str, int]:
        return self.graph.stats()

    def impl_report(self, by_kind: bool = False,
                    provenance: bool = False, sol: bool = False) -> Any:
        """Elected-implementation report.  Default: impl name → node count.
        ``by_kind=True``: ``{op value → {impl name → count}}``.
        ``provenance=True``: ``{impl name → {"count": n, "sources":
        {"measured"|"calibrated"|"analytical" → n}, "pinned": [cfg, ...]}}``
        (``"pinned"`` only when non-empty).  ``sol=True``: the
        speed-of-light view (``core.sol.node_rows`` over the process-wide
        autotune cache), one JSON dict per elected node, worst gap first:
        the bound at the unit that runs the node, the measured (or
        calibrated) ``us``, their ``ratio`` and its provenance."""
        if sol:
            from ..core import autotune
            from ..core import sol as sol_mod
            rows = sol_mod.node_rows(self.graph, self.backend,
                                     autotune.get_cache())
            return [r.to_json() for r in sol_mod.rank(rows)]
        if provenance:
            prov = getattr(self.graph, "election_provenance", {})
            pins = getattr(self.graph, "election_pinned", {})
            out = {}
            for name, count in getattr(self.graph, "elections", {}).items():
                entry = {"count": count,
                         "sources": dict(prov.get(name, {}))}
                if pins.get(name):
                    entry["pinned"] = [tuple(c) for c in pins[name]]
                out[name] = entry
            return out
        if by_kind:
            return {op: dict(impls) for op, impls in
                    getattr(self.graph, "elections_by_op", {}).items()}
        return dict(getattr(self.graph, "elections", {}))

    def check_provenance(self,
                         kinds: Tuple[str, ...] = ("linear", "matmul",
                                                   "attention"),
                         require: Tuple[str, ...] = ("measured",)
                         ) -> list:
        """Serving audit: every node of the given OpKinds must have been
        elected from an allowed provenance source.  Returns violation
        strings — empty means clean."""
        return provenance_violations(self.impl_report(by_kind=True),
                                     self.impl_report(provenance=True),
                                     kinds=kinds, require=require)


def provenance_violations(by_op: Dict[str, Any], prov: Dict[str, Any],
                          kinds: Tuple[str, ...] = ("linear", "matmul",
                                                    "attention"),
                          require: Tuple[str, ...] = ("measured",)) -> list:
    """For each elected impl of the target OpKinds, every recorded election
    source must be in ``require``; an impl with no provenance at all is also
    a violation."""
    out = []
    for kind in kinds:
        for impl_name in (by_op.get(kind) or {}):
            sources = (prov.get(impl_name) or {}).get("sources", {})
            bad = {s: n for s, n in sources.items()
                   if s not in require and n}
            if not sources:
                out.append(f"{kind}→{impl_name}: no election provenance "
                           f"recorded")
            elif bad:
                out.append(f"{kind}→{impl_name}: elected via {bad}, "
                           f"require {tuple(require)}")
    return out


def optimize(model: tnn.Module, input_shape: Tuple[int, ...], *,
             backend: str | Backend = "h100", training: bool = False,
             dtype: str = "float32", device: DeviceLike = None,
             mesh=None) -> SolModel:
    """Extract → optimize → lower → inject.  ``device=None`` is the device
    API's selection: the CUDA card unless the caller chose the CPU.  With
    ``training=True`` the backward impls are elected too and ``_fn`` is
    differentiable through them (``forward`` itself stays gradient-free:
    a train step differentiates ``_fn``, as
    ``distributed.steps.make_sol_train_step`` does).  ``mesh``: as in
    :func:`compile_graph`."""
    graph = extract(model, input_shape, dtype)
    return compile_graph(model, graph, backend, training=training,
                         device=device, mesh=mesh)


def compile_graph(model: tnn.Module, graph, backend: str | Backend = "h100",
                  *, training: bool = False, device: DeviceLike = None,
                  mesh=None) -> SolModel:
    """Optimize → lower → inject for a pre-built graph (the serving prefill
    and decode programs).

    With ``mesh`` (``launch.mesh.make_debug_mesh``) the graph is
    partitioned first (``distributed.sharding.shard_graph``) and the
    backend's cache key qualified (``mesh_backend``), so the pipeline,
    elections and autotune lookups run on per-shard shapes.  The model
    holds this rank's parameter shards, slices each input by the graph's
    input specs, lowers the row-parallel all-reduces inside the program
    and all-gathers every output, so each rank returns the whole output.
    With ``training=True`` its ``_fn`` takes this rank's parameter blocks
    and rows and is differentiable across the ranks
    (``distributed.steps.make_sol_train_step`` trains it).
    ``device=None`` is then the mesh's device.  A backend bound to one
    device type (``Backend.device_type``: ``host_cpu``'s is the CPU)
    runs there when no device is given and refuses any other."""
    bk = backend if isinstance(backend, Backend) else get_backend(backend)
    if mesh is not None and device is None:
        device = getattr(mesh, "device", None)
    if device is None:
        device = bk.device_type
    if bk.device_type is not None and \
            torch.device(device).type != bk.device_type:
        raise ValueError(
            f"backend {bk.name!r} runs on the {bk.device_type} device (the "
            f"host), not on {device}: compile for that device with another "
            f"backend")
    dev = resolve_device(device)
    bk = for_device(bk, dev)            # a PCIe card's spec on a PCIe card
    if mesh is not None:
        from ..distributed import sharding as shd
        graph = shd.shard_graph(graph, mesh)
        bk = shd.mesh_backend(bk, mesh)
    graph = passes.run_pipeline(graph, bk, training=training)
    return SolModel(model, graph, bk,
                    lower_graph(graph, bk, differentiable=training), dev,
                    mesh=mesh)

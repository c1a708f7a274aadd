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
                 device: torch.device):
        super().__init__()
        # a plain attribute, not a submodule: the source owns its parameters
        object.__setattr__(self, "_source", source)
        self.graph = graph
        self.backend = backend
        self._fn = fn
        self.device = device
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
            self._ctx_params = device_api.stage_params(params, self.device)
            self._ctx_key = key
        return self._ctx_params

    def load_state_dict(self, sd, strict: bool = True, assign: bool = False):
        return self._source.load_state_dict(sd, strict=strict, assign=assign)

    def state_dict(self, *args, **kwargs):
        return self._source.state_dict(*args, **kwargs)

    @torch.no_grad()
    def forward(self, *xs) -> Any:
        params = self._params_for_call()
        staged = [device_api.stage_input(x, self.device) for x in xs]
        y = self._fn(params, *staged)
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
    ``distributed.steps.make_sol_train_step`` does)."""
    graph = extract(model, input_shape, dtype)
    return compile_graph(model, graph, backend, training=training,
                         device=device, mesh=mesh)


def compile_graph(model: tnn.Module, graph, backend: str | Backend = "h100",
                  *, training: bool = False, device: DeviceLike = None,
                  mesh=None) -> SolModel:
    """Optimize → lower → inject for a pre-built graph (the serving prefill
    and decode programs)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh compilation arrives with the sharded-serving slice of the "
            "port")
    bk = backend if isinstance(backend, Backend) else get_backend(backend)
    dev = resolve_device(device)
    bk = for_device(bk, dev)            # a PCIe card's spec on a PCIe card
    graph = passes.run_pipeline(graph, bk, training=training)
    return SolModel(model, graph, bk,
                    lower_graph(graph, bk, differentiable=training), dev)

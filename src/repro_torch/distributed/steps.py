"""The SOL train step and the backbone's serve steps (counterpart of
``repro.distributed.steps``'s ``StepOptions``, ``make_sol_train_step``,
``make_prefill_step`` and ``make_decode_step``).  The backbone's serve
steps run on a one-process mesh, on its device; the sharded backbone
(``param_specs``/``cache_specs``, ``jit_serve_steps``) and its training
steps wait for ROADMAP §1 item 7.

Forward and backward ride the elected graph: the loss is computed through
``SolModel._fn`` of a model compiled with ``training=True``, where every
node with a backward impl is a ``torch.autograd.Function`` pairing its
elected forward with its elected backward, and ``torch.autograd.grad``
runs over the parameter dict.  AdamW with the cosine schedule follows
(``repro_torch.optim``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import backbone as B
from ..models.config import ArchConfig
from ..optim import AdamWConfig, adamw_update, cosine_schedule, \
    init_opt_state


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """The SOL train step's options.  The backbone trainer's own
    (rematerialization, microbatches, gradient compression, ZeRO) wait
    for it."""
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000


def mse(out: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The default loss: mean squared error against ``batch["y"]`` in
    f32."""
    return ((out.float() - batch["y"].float()) ** 2).mean()


def make_sol_train_step(model, opts: StepOptions,
                        loss_fn: Optional[Callable] = None
                        ) -> Tuple[Callable, Callable]:
    """``(train_step, init_state)`` over a ``SolModel`` compiled with
    ``training=True``.  ``train_step(state, batch)``, with ``batch =
    {"x": ..., "y": ...}`` on the model's device, returns the new state
    and ``{"loss", "lr", "grad_norm"}``; it writes none of ``state``'s
    tensors.  ``init_state(params=None)`` starts from the model's own
    parameters (``_params_for_call``) with zero moments."""
    ocfg = AdamWConfig(lr=opts.lr)
    lf = loss_fn or mse

    def init_state(params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, Any]:
        p = dict(params) if params is not None \
            else dict(model._params_for_call())
        return {"params": p, "opt": init_opt_state(p, ocfg),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=model.device)}

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        keys = sorted(state["params"])
        params = {k: state["params"][k].detach().requires_grad_(True)
                  for k in keys}
        loss = lf(model._fn(params, batch["x"]), batch)
        grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                    allow_unused=True)
        grads = {k: g if g is not None else torch.zeros_like(params[k])
                 for k, g in zip(keys, grads)}
        with torch.no_grad():
            lr = cosine_schedule(state["step"], peak_lr=opts.lr,
                                 warmup=opts.warmup, total=opts.total_steps)
            new_p, new_opt, om = adamw_update(state["params"], grads,
                                              state["opt"], ocfg, lr)
        return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss.detach(), "lr": lr, **om})

    return train_step, init_state


# ---------------------------------------------------------------------------
# serving the backbone
# ---------------------------------------------------------------------------

def _mesh_device(mesh, what: str) -> Optional[torch.device]:
    """The device of a one-process mesh (None for an abstract one: the
    parameters' own); a larger mesh raises."""
    n = 1
    for size in mesh.sizes:
        n *= int(size)
    if n != 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.shape}: the sharded backbone's "
            f"param_specs and cache_specs wait for ROADMAP §1 item 7")
    return getattr(mesh, "device", None)


def _on(dev: Optional[torch.device], params, *tensors):
    """``tensors`` moved to ``dev``, after checking that the parameters
    already live there (a step never copies a model)."""
    if dev is None:
        return tensors
    if params["embed"].device != dev:
        raise ValueError(f"the parameters are on {params['embed'].device}, "
                         f"the mesh on {dev}")
    return tuple(None if t is None else t.to(dev) for t in tensors)


def make_prefill_step(mesh, cfg: ArchConfig, *, plain: bool = False):
    """``prefill_step(params, batch, cache=None)`` on a one-process mesh:
    the prompt's logits, or with a fresh cache (``backbone.init_cache``)
    ``(logits, the filled cache)``.  ``plain`` forces every attention and
    scan onto plain torch."""
    dev = _mesh_device(mesh, "make_prefill_step")

    def prefill_step(params, batch: Dict[str, torch.Tensor], cache=None):
        keys = sorted(batch)
        moved = _on(dev, params, *(batch[k] for k in keys))
        batch = dict(zip(keys, moved))
        with torch.inference_mode():
            if cache is None:
                logits, _ = B.prefill(cfg, params, batch, plain=plain)
                return logits
            return B.prefill(cfg, params, batch, cache, plain=plain)

    return prefill_step


def make_decode_step(mesh, cfg: ArchConfig, *, plain: bool = False):
    """``decode(params, cache, tokens, pos, enc_out=None)`` on a
    one-process mesh: (logits (B, 1, V), the new cache) for the token at
    position ``pos``."""
    dev = _mesh_device(mesh, "make_decode_step")

    def decode(params, cache, tokens: torch.Tensor, pos,
               enc_out: Optional[torch.Tensor] = None):
        tokens, enc_out = _on(dev, params, tokens, enc_out)
        with torch.inference_mode():
            return B.decode_step(cfg, params, cache, tokens, pos, enc_out,
                                 plain=plain)

    return decode

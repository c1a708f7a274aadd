"""The SOL train step (counterpart of ``repro.distributed.steps``'s
``StepOptions`` and ``make_sol_train_step``; the pjit, mesh and serve
steps wait for sharded serving and the backbone trainer).

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

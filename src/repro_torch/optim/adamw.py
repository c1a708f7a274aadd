"""AdamW on dicts of tensors (counterpart of ``repro.optim.adamw``).

The update is functional, as the JAX package's is: it returns new
parameter and moment tensors and writes none of its arguments, so a
parameter dict staged from a module (``SolModel._params_for_call``, whose
tensors share the module's storage) never changes under it.  Moments are
kept in f32 and every update is computed in f32; the JAX package's
``moment_dtype`` waits for bf16 training, and ``opt_state_specs`` (the
moments' shardings) for sharded training.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: Dict[str, Tensor], ocfg: AdamWConfig
                   ) -> Dict[str, object]:
    """Zero f32 moments beside each parameter, and a step count of 0 (an
    int32 scalar on the parameters' device)."""
    dev = next(iter(params.values())).device if params else None
    return {"m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Dict[str, Tensor]) -> Tensor:
    """The f32 L2 norm over every tensor of ``tree``, summed in key
    order."""
    total = sum(torch.sum(torch.square(tree[k].float()))
                for k in sorted(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(params: Dict[str, Tensor], grads: Dict[str, Tensor],
                 state: Dict[str, object], ocfg: AdamWConfig, lr: Tensor
                 ) -> Tuple[Dict[str, Tensor], Dict[str, object],
                            Dict[str, Tensor]]:
    """One AdamW step with global-norm clipping at ``ocfg.grad_clip`` and
    bias correction: (new params, new state, {"grad_norm"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(ocfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if ocfg.grad_clip else 1.0)
    b1, b2 = ocfg.beta1, ocfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    new_p, new_m, new_v = {}, {}, {}
    for k in sorted(params):
        p = params[k]
        g = grads[k].float() * scale
        new_m[k] = state["m"][k] * b1 + (1 - b1) * g
        new_v[k] = state["v"][k] * b2 + (1 - b2) * g * g
        delta = (new_m[k] / c1) / (torch.sqrt(new_v[k] / c2) + ocfg.eps) \
            + ocfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm}

"""AdamW on trees of tensors (counterpart of ``repro.optim.adamw``).

A tree is a flat dict of tensors (``make_sol_train_step``'s parameters)
or the backbone's nested dicts (``models.backbone``); the moments mirror
it.  The update is functional, as the JAX package's is: it returns new
parameter and moment trees and writes none of its arguments, so a
parameter dict staged from a module (``SolModel._params_for_call``, whose
tensors share the module's storage) never changes under it.  Moments are
stored in ``moment_dtype`` (bfloat16 halves the optimizer's memory),
every update is computed in f32, and each new parameter is cast back to
its own dtype.  ``opt_state_specs`` gives the moments the parameters'
partition specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.backbone import tree_leaves, tree_map

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" halves optimizer memory


def init_opt_state(params, ocfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments in ``ocfg.moment_dtype`` beside each parameter, and a
    step count of 0 (an int32 scalar on the first parameter's device)."""
    dt = getattr(torch, ocfg.moment_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0][1].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_spec_tree) -> Dict[str, Any]:
    """The moments sharded as the parameters, the step replicated."""
    from ..distributed.sharding import P
    return {"m": param_spec_tree, "v": param_spec_tree, "step": P()}


def global_norm(tree) -> Tensor:
    """The f32 L2 norm over every tensor of ``tree``, summed in the
    leaves' order (keys sorted at every level)."""
    total = sum(torch.sum(torch.square(x.float()))
                for _, x in tree_leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(params, grads, state: Dict[str, Any], ocfg: AdamWConfig,
                 lr: Tensor, gnorm: Optional[Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Tensor]]:
    """One AdamW step with global-norm clipping at ``ocfg.grad_clip`` and
    bias correction: (new params, new state, {"grad_norm"}).  ``gnorm``:
    the norm of the whole gradient when ``grads`` is one rank's blocks of
    it (default: ``global_norm(grads)``)."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(ocfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if ocfg.grad_clip else 1.0)
    dt = getattr(torch, ocfg.moment_dtype)
    b1, b2 = ocfg.beta1, ocfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + ocfg.eps) \
            + ocfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m32.to(dt), v32.to(dt)

    out = tree_map(upd, params, grads, state["m"], state["v"])

    def part(i: int):
        return tree_map(lambda _p, o: o[i], params, out)
    return part(0), {"m": part(1), "v": part(2), "step": step}, \
        {"grad_norm": gnorm}

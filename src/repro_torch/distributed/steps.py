"""Train and serve steps (counterpart of ``repro.distributed.steps``).

* :func:`make_train_step` trains the backbone (``models.backbone``):
  ``torch.autograd.grad`` of ``loss_fn`` over the parameter tree's leaves
  (the flash, scan and MoE entries carry explicit backwards, and
  ``remat`` recomputes each macro block), an f32 gradient accumulation
  over microbatches, optional bf16 gradient compression, then the cosine
  schedule and AdamW with moments in ``moment_dtype``.
  :func:`make_train_state_specs` gives the state's partition specs (ZeRO
  moments with ``zero``).  The steps run on a one-process mesh, on its
  device; a larger mesh raises ``NotImplementedError``: the sharded
  backbone's execution waits for ROADMAP §1 item 7.
* :func:`make_sol_train_step` trains a ``SolModel`` compiled with
  ``training=True``: forward and backward ride the elected graph, where
  every node with a backward impl is a ``torch.autograd.Function``
  pairing its elected forward with its elected backward.
* :func:`make_prefill_step` / :func:`make_decode_step` serve the backbone.

Every step is functional: it returns a new state and writes none of the
tensors it was given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models import backbone as B
from ..models.config import ArchConfig
from ..optim import AdamWConfig, adamw_update, cosine_schedule, \
    init_opt_state, opt_state_specs
from . import compress as C
from . import ctx
from . import sharding as S
from . import zero as Z


@dataclasses.dataclass(frozen=True)
class StepOptions:
    remat: bool = True
    microbatch: int = 1               # gradient-accumulation factor
    grad_compression: str = "none"    # "none" | "bf16"
    zero: bool = True                 # ZeRO-1 moment specs
    moment_dtype: str = "float32"
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    aux_weight: float = 0.01


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
    ocfg = AdamWConfig(lr=opts.lr, moment_dtype=opts.moment_dtype)
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
# the backbone's devices
# ---------------------------------------------------------------------------

def _mesh_device(mesh, what: str) -> Optional[torch.device]:
    """The device of a one-process mesh (None for an abstract one: the
    parameters' own); a larger mesh raises."""
    if ctx.mesh_size(mesh) != 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.shape}: placing the backbone's "
            f"trees by param_specs and cache_specs (the sharded "
            f"backbone's execution) waits for ROADMAP §1 item 7")
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


# ---------------------------------------------------------------------------
# training the backbone
# ---------------------------------------------------------------------------

def make_train_state_specs(mesh, cfg: ArchConfig, opts: StepOptions):
    """``{"params", "opt", "step"}`` partition specs of the train state on
    ``mesh``: the parameters' by the rule table, the moments ZeRO-sharded
    with ``opts.zero`` (else as the parameters)."""
    pshapes = B.param_specs(cfg)
    pspecs = S.param_specs(mesh, cfg, pshapes)
    if opts.zero:
        ospecs = Z.zero_opt_specs(mesh, pspecs, pshapes)
    else:
        ospecs = opt_state_specs(pspecs)
    return {"params": pspecs, "opt": ospecs, "step": S.P()}


def _adamw(opts: StepOptions) -> AdamWConfig:
    return AdamWConfig(lr=opts.lr, moment_dtype=opts.moment_dtype)


def init_train_state(cfg: ArchConfig, opts: StepOptions,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> Dict[str, Any]:
    """Parameters from ``generator`` (``backbone.init_params``) on
    ``device`` (the card unless asked otherwise), zero moments and a step
    count of 0."""
    params = B.init_params(cfg, generator, device)
    opt = init_opt_state(params, _adamw(opts))
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=opt["step"].device)}


def train_state_shapes(cfg: ArchConfig, opts: StepOptions):
    """The train state on the meta device: nothing allocated."""
    return init_train_state(cfg, opts, None, "meta")


def _split(batch: Dict[str, torch.Tensor], n: int) -> List[Dict]:
    """The batch cut into ``n`` microbatches along its leading dim."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of {n} microbatches")
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


def make_train_step(mesh, cfg: ArchConfig, opts: StepOptions, *,
                    plain: bool = False) -> Tuple[Callable, Any]:
    """``(train_step, state_specs)`` on a one-process mesh.
    ``train_step(state, batch)`` returns the new state and ``{"loss",
    "ce", "aux", "grad_norm", "lr"}`` (with microbatches, the loss is their
    mean and ``ce``/``aux`` the last one's, as in JAX).  ``plain`` forces
    every attention and scan onto plain torch."""
    dev = _mesh_device(mesh, "make_train_step")
    ocfg = _adamw(opts)

    def grads_of(leaves, params, batch):
        with torch.enable_grad():
            total, metrics = B.loss_fn(cfg, params, batch, remat=opts.remat,
                                       aux_weight=opts.aux_weight,
                                       plain=plain)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        keys = sorted(batch)
        batch = dict(zip(keys, _on(dev, state["params"],
                                   *(batch[k] for k in keys))))
        with ctx.use_mesh(mesh):
            live = B.tree_map(lambda p: p.detach().requires_grad_(True),
                              state["params"])
            paths, leaves = zip(*B.tree_leaves(live))
            if opts.microbatch > 1:
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in leaves]
                lsum = 0.0
                for mb in _split(batch, opts.microbatch):
                    lval, metrics, grads = grads_of(leaves, live, mb)
                    acc = [a + g for a, g in zip(acc, grads)]
                    lsum = lsum + lval
                grads = [a / opts.microbatch for a in acc]
                lval = lsum / opts.microbatch
            else:
                lval, metrics, grads = grads_of(leaves, live, batch)
            by_path = dict(zip(paths, grads))
            grads = B.tree_map_with_path(lambda path, _: by_path[path], live)
            with torch.no_grad():
                grads = C.decompress_grads(
                    C.compress_grads(grads, opts.grad_compression),
                    opts.grad_compression)
                lr = cosine_schedule(state["step"], peak_lr=opts.lr,
                                     warmup=opts.warmup,
                                     total=opts.total_steps)
                new_params, new_opt, om = adamw_update(
                    state["params"], grads, state["opt"], ocfg, lr)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": lval, **metrics, **om, "lr": lr}

    return train_step, make_train_state_specs(mesh, cfg, opts)


def jit_train_step(mesh, cfg: ArchConfig, opts: StepOptions,
                   batch_shapes) -> Tuple[Callable, Any, Any]:
    """``(step, state_specs, batch_specs)``.  JAX compiles the step here
    under its shardings; the port runs it eagerly (nothing is compiled),
    and the specs describe the placement a sharded run would take."""
    step_fn, state_specs = make_train_step(mesh, cfg, opts)
    return step_fn, state_specs, S.batch_specs(mesh, cfg, batch_shapes)


# ---------------------------------------------------------------------------
# serving the backbone
# ---------------------------------------------------------------------------

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

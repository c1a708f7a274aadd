"""Train and serve steps (counterpart of ``repro.distributed.steps``).

* :func:`make_train_step` trains the backbone (``models.backbone``):
  ``torch.autograd.grad`` of ``loss_fn`` over the parameter tree's leaves
  (the flash, scan and MoE entries carry explicit backwards, and
  ``remat`` recomputes each macro block), an f32 gradient accumulation
  over microbatches, optional bf16 gradient compression, then the cosine
  schedule and AdamW with moments in ``moment_dtype``.
  :func:`make_train_state_specs` gives the state's partition specs (ZeRO
  moments with ``zero``).
* On a ``launch.mesh.Mesh`` of several ranks every step runs this rank's
  program (``models.layers``) on its blocks of the state
  (``sharding.shard_tree`` under :func:`make_train_state_specs`) and its
  rows of the batch (``sharding.batch_specs``): the loss is the mean over
  the data shards, the gradients are averaged over ``data``, the
  clipping norm is global (squares summed over the model shards, a
  replicated leaf counted once) and AdamW runs on local blocks; with
  ``zero`` each moment lives on its ``zero_opt_specs`` block, the update
  runs there and the new parameter is all-gathered over ``data``.  An
  abstract mesh of several devices has no ranks to run on and raises
  ``ValueError``.
* :func:`make_sol_train_step` trains a ``SolModel`` compiled with
  ``training=True``: forward and backward ride the elected graph, where
  every node with a backward impl is a ``torch.autograd.Function``
  pairing its elected forward with its elected backward.  Compiled on a
  mesh of ranks (``compile_graph(mesh=...)``), it follows the backbone's
  sharded steps: the state holds this rank's blocks
  (``graph.param_specs``), the batch is this rank's rows
  (:func:`sol_batch_specs`), the loss is the global batch's (the mean
  over ``data``, an output sharded over ``model`` read whole), the
  gradients are averaged over ``data`` in one all-reduce, the clip reads
  the global norm and AdamW updates the rank's blocks
  (:func:`make_sol_grad_step` is its gradient pass, and
  :func:`gather_sol_tree` joins blocks back into whole tensors).
* :func:`make_prefill_step` / :func:`make_decode_step` serve the backbone
  (:func:`jit_serve_steps`: the decode step with the parameter and cache
  specs).

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
from .collectives import gather_over
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


def sol_batch_specs(model) -> Dict[str, Any]:
    """``{"x", "y"}`` partition specs of a batch for a mesh-compiled
    ``SolModel``: the input's (``graph.input_specs``) and the output's
    rows, whole over every other axis (the loss reads the output
    joined over ``model``)."""
    graph, mesh = model.graph, model.mesh
    dp = set(S.dp_axes(mesh))
    out = graph.output_specs[0]
    return {"x": graph.input_specs[0],
            "y": S.P(*(e if set(S.spec_axes(out, i, len(out))) & dp
                       else None for i, e in enumerate(out)))}


def _whole_output(mesh, out: torch.Tensor, spec) -> torch.Tensor:
    """The rank's rows of ``out`` with every dim sharded over other axes
    than the data axes all-gathered (differentiably: the backward keeps
    the rank's block)."""
    dp = set(S.dp_axes(mesh))
    for dim in range(out.dim()):
        axes = S.spec_axes(spec, dim, out.dim())
        if axes and not set(axes) & dp and mesh.span(axes) > 1:
            out = gather_over(out, mesh, axes, dim)
    return out


def make_sol_grad_step(model, loss_fn: Optional[Callable] = None
                       ) -> Callable:
    """``grad_step(params, batch)``: ``(loss, grads)`` of ``loss_fn``
    (default :func:`mse`) through a ``SolModel`` compiled with
    ``training=True``, ``grads`` a dict like ``params``.  On a mesh of
    ranks ``params`` and ``batch`` are this rank's blocks and rows, the
    gradients this rank's blocks of their mean over ``data`` and the
    loss its mean (one all-reduce for both)."""
    lf = loss_fn or mse
    ranks = _ranks(getattr(model, "mesh", None))

    def grad_step(params: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor]):
        keys = sorted(params)
        live = {k: params[k].detach().requires_grad_(True) for k in keys}
        with torch.enable_grad():
            out = model._fn(live, batch["x"])
            if ranks is not None:
                out = _whole_output(ranks, out, model.graph.output_specs[0])
            loss = lf(out, batch)
            grads = torch.autograd.grad(loss, [live[k] for k in keys],
                                        allow_unused=True)
        grads = {k: g if g is not None else torch.zeros_like(live[k])
                 for k, g in zip(keys, grads)}
        loss = loss.detach()
        if ranks is not None:
            with torch.no_grad():
                grads, loss = _data_mean(ranks, (grads, loss))
        return loss, grads

    return grad_step


def gather_sol_tree(model, tree: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The whole tensors of ``tree`` (``{parameter name: this rank's
    block}``: parameters, gradients or moments of a mesh-compiled
    ``SolModel``) under ``graph.param_specs``; a collective every rank
    calls.  Off a mesh of ranks, ``tree`` itself."""
    mesh = _ranks(getattr(model, "mesh", None))
    if mesh is None:
        return dict(tree)
    return S.gather_tree(mesh, dict(tree),
                         {k: model.graph.param_specs[k] for k in tree})


def make_sol_train_step(model, opts: StepOptions,
                        loss_fn: Optional[Callable] = None
                        ) -> Tuple[Callable, Callable]:
    """``(train_step, init_state)`` over a ``SolModel`` compiled with
    ``training=True``.  ``train_step(state, batch)``, with ``batch =
    {"x": ..., "y": ...}`` on the model's device, returns the new state
    and ``{"loss", "lr", "grad_norm"}``; it writes none of ``state``'s
    tensors.  ``init_state(params=None)`` starts from the model's own
    parameters (``_params_for_call``) with zero moments.  On a mesh of
    ranks the state holds this rank's blocks and the batch is this
    rank's rows (``sol_batch_specs``); the loss is the global batch's,
    the gradients their mean over ``data``, the clip reads their global
    norm (a model-sharded leaf's blocks summed over ``model``, a
    replicated leaf counted once), and AdamW updates the blocks, as the
    one-process step updates the whole tensors."""
    ocfg = AdamWConfig(lr=opts.lr, moment_dtype=opts.moment_dtype)
    grad_step = make_sol_grad_step(model, loss_fn)
    ranks = _ranks(getattr(model, "mesh", None))

    def init_state(params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, Any]:
        p = dict(params) if params is not None \
            else dict(model._params_for_call())
        return {"params": p, "opt": init_opt_state(p, ocfg),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=model.device)}

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        loss, grads = grad_step(state["params"], batch)
        with torch.no_grad():
            lr = cosine_schedule(state["step"], peak_lr=opts.lr,
                                 warmup=opts.warmup, total=opts.total_steps)
            gnorm = None if ranks is None else _global_norm(
                ranks, grads, model.graph.param_specs)
            new_p, new_opt, om = adamw_update(state["params"], grads,
                                              state["opt"], ocfg, lr,
                                              gnorm=gnorm)
        return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss, "lr": lr, **om})

    return train_step, init_state


# ---------------------------------------------------------------------------
# the backbone's devices
# ---------------------------------------------------------------------------

def _mesh_device(mesh, what: str) -> Optional[torch.device]:
    """The device of a mesh with ranks (None for an abstract mesh of one
    device: the parameters' own); an abstract mesh of several raises."""
    if ctx.mesh_size(mesh) != 1 and not hasattr(mesh, "all_reduce"):
        raise ValueError(
            f"{what} on {mesh!r}: a sharded step runs on ranks, and an "
            f"abstract mesh has no process groups (start them with "
            f"launch.mesh.run_on_mesh and pass its Mesh)")
    return getattr(mesh, "device", None)


def _ranks(mesh):
    """``mesh`` when it has several ranks, else None."""
    return mesh if hasattr(mesh, "all_reduce") and mesh.size > 1 else None


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


def _flat_collective(mesh, tensors: List[torch.Tensor], op: str,
                     axes) -> List[torch.Tensor]:
    """One collective over ``axes`` for many tensors: their flat
    concatenation all-reduced (summed), or all-gathered into one row per
    rank of the slice; returned cut back per tensor (gathered: (ranks,
    *shape)), where the buffer was.  Over gloo the buffer is built on the
    host, where gloo moves it anyway."""
    host = mesh.backend == "gloo"
    flat = torch.cat([t.reshape(-1).to("cpu" if host else t.device)
                      for t in tensors])
    n = mesh.span(axes)
    if op == "all_reduce":
        flat = mesh.all_reduce(flat, axes)
    else:
        flat = mesh.all_gather(flat, axes, 0).reshape(n, -1)
    out, off = [], 0
    for t in tensors:
        size = t.numel()
        if op == "all_reduce":
            part = flat[off:off + size].reshape(t.shape)
        else:
            part = flat[:, off:off + size].reshape(n, *t.shape)
        out.append(part.to(t.dtype))
        off += size
    return out


def _data_mean(mesh, tree):
    """The mean of every leaf of ``tree`` over the data-parallel ranks
    (one all-reduce)."""
    dp = S.dp_axes(mesh)
    n = mesh.span(dp) if dp else 1
    if n == 1:
        return tree
    leaves = [x for _, x in B.tree_leaves(tree)]
    for leaf, total in zip(leaves, _flat_collective(mesh, leaves,
                                                    "all_reduce", dp)):
        leaf.copy_(total / n)          # in place: no second copy on the card
    return tree


def _model_sharded(spec) -> bool:
    return any(e == "model" or (isinstance(e, tuple) and "model" in e)
               for e in spec)


def _global_norm(mesh, grads, pspecs) -> torch.Tensor:
    """The L2 norm of the whole gradient from this rank's blocks: squares
    of model-sharded leaves summed over ``model``, each replicated leaf
    counted once."""
    sharded = torch.zeros((), dtype=torch.float32, device=mesh.device)
    whole = torch.zeros((), dtype=torch.float32, device=mesh.device)
    specs = dict(B.tree_leaves(pspecs, leaf=S.P))
    for path, g in B.tree_leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        if _model_sharded(specs[path]):
            sharded = sharded + sq
        else:
            whole = whole + sq
    return torch.sqrt(mesh.all_reduce(sharded, "model") + whole)


def _zero_dim(pspec, zspec) -> Optional[int]:
    """The dim ZeRO adds the data-parallel axes to (None: the moment is
    the parameter's block)."""
    for i, z in enumerate(zspec):
        if z is not None and (i >= len(pspec) or pspec[i] is None):
            return i
    return None


def _zero_update(mesh, state, grads, specs, ocfg, lr, gnorm):
    """AdamW on each leaf's ZeRO block (the moments' ``zero_opt_specs``),
    the new parameters all-gathered over ``data``."""
    dp = S.dp_axes(mesh)
    pspecs = dict(B.tree_leaves(specs["params"], leaf=S.P))
    zspecs = dict(B.tree_leaves(specs["opt"]["m"], leaf=S.P))
    zdims = {path: _zero_dim(pspecs[path], zspecs[path]) for path in pspecs}

    def block(path, x):
        d = zdims[path]
        if d is None:
            return x
        cut = [None] * x.dim()
        cut[d] = dp if len(dp) > 1 else dp[0]
        return x[S.shard_slices(mesh, mesh.coords, tuple(x.shape),
                                S.P(*cut))]

    params_z = B.tree_map_with_path(block, state["params"])
    grads_z = B.tree_map_with_path(block, grads)
    new_z, new_opt, om = adamw_update(params_z, grads_z, state["opt"], ocfg,
                                      lr, gnorm=gnorm)
    paths = [p for p, _ in B.tree_leaves(new_z) if zdims[p] is not None]
    z_leaves = dict(B.tree_leaves(new_z))
    gathered = dict(zip(paths, _flat_collective(
        mesh, [z_leaves[p] for p in paths], "all_gather", dp)))

    def whole(path, x):
        if path not in gathered:
            return x
        return torch.cat(list(gathered.pop(path).unbind(0)),
                         dim=zdims[path]).to(x.device)

    return B.tree_map_with_path(whole, new_z), new_opt, om


def make_grad_step(mesh, cfg: ArchConfig, opts: StepOptions, *,
                   plain: bool = False) -> Callable:
    """``grad_step(params, batch)``: ``(loss, {"ce", "aux"}, grads)`` of
    ``backbone.loss_fn`` (microbatches accumulated in f32).  On a mesh of
    ranks ``params`` and ``batch`` are this rank's blocks, the gradients
    this rank's blocks of their mean over the data shards and the loss and
    metrics their mean."""
    dev = _mesh_device(mesh, "make_train_step")
    ranks = _ranks(mesh)

    def grads_of(leaves, params, batch):
        with torch.enable_grad():
            total, metrics = B.loss_fn(cfg, params, batch, remat=opts.remat,
                                       aux_weight=opts.aux_weight,
                                       plain=plain)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for p, g in zip(leaves, grads)]
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def grad_step(params, batch: Dict[str, torch.Tensor]):
        keys = sorted(batch)
        batch = dict(zip(keys, _on(dev, params, *(batch[k] for k in keys))))
        with ctx.use_mesh(mesh):
            live = B.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
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
        if ranks is not None:
            with torch.no_grad():
                grads = _data_mean(ranks, grads)
                lval, metrics = _data_mean(ranks, (lval, metrics))
        return lval, metrics, grads

    return grad_step


def make_train_step(mesh, cfg: ArchConfig, opts: StepOptions, *,
                    plain: bool = False) -> Tuple[Callable, Any]:
    """``(train_step, state_specs)``.  ``train_step(state, batch)``
    returns the new state and ``{"loss", "ce", "aux", "grad_norm", "lr"}``
    (with microbatches, the loss is their mean and ``ce``/``aux`` the last
    one's, as in JAX).  On a mesh of ranks ``state`` and ``batch`` are this
    rank's blocks (``state_specs``; ``sharding.batch_specs``) and so is
    the new state.  ``plain`` forces every attention and scan onto plain
    torch."""
    grad_step = make_grad_step(mesh, cfg, opts, plain=plain)
    specs = make_train_state_specs(mesh, cfg, opts)
    ranks = _ranks(mesh)
    ocfg = _adamw(opts)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        lval, metrics, grads = grad_step(state["params"], batch)
        with torch.no_grad():
            grads = C.decompress_grads(
                C.compress_grads(grads, opts.grad_compression),
                opts.grad_compression)
            lr = cosine_schedule(state["step"], peak_lr=opts.lr,
                                 warmup=opts.warmup, total=opts.total_steps)
            if ranks is None:
                new_params, new_opt, om = adamw_update(
                    state["params"], grads, state["opt"], ocfg, lr)
            else:
                gnorm = _global_norm(ranks, grads, specs["params"])
                if opts.zero:
                    new_params, new_opt, om = _zero_update(
                        ranks, state, grads, specs, ocfg, lr, gnorm)
                else:
                    new_params, new_opt, om = adamw_update(
                        state["params"], grads, state["opt"], ocfg, lr,
                        gnorm=gnorm)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": lval, **metrics, **om, "lr": lr}

    return train_step, specs


def jit_train_step(mesh, cfg: ArchConfig, opts: StepOptions,
                   batch_shapes) -> Tuple[Callable, Any, Any]:
    """``(step, state_specs, batch_specs)``.  JAX compiles the step here
    under its shardings; the port runs it eagerly (nothing is compiled)
    on the blocks those specs place on each rank."""
    step_fn, state_specs = make_train_step(mesh, cfg, opts)
    return step_fn, state_specs, S.batch_specs(mesh, cfg, batch_shapes)


# ---------------------------------------------------------------------------
# serving the backbone
# ---------------------------------------------------------------------------

def make_prefill_step(mesh, cfg: ArchConfig, *, plain: bool = False,
                      cache_specs=None):
    """``prefill_step(params, batch, cache=None)``: the prompt's logits,
    or with a fresh cache (``backbone.init_cache``) ``(logits, the filled
    cache)``.  On a mesh of ranks the arguments and results are this
    rank's blocks (its rows of the batch, whole-vocab logits) and
    ``cache_specs`` the cache's specs.  ``plain`` forces every attention
    and scan onto plain torch."""
    dev = _mesh_device(mesh, "make_prefill_step")

    def prefill_step(params, batch: Dict[str, torch.Tensor], cache=None):
        keys = sorted(batch)
        moved = _on(dev, params, *(batch[k] for k in keys))
        batch = dict(zip(keys, moved))
        with torch.inference_mode(), ctx.use_mesh(mesh):
            if cache is None:
                logits, _ = B.prefill(cfg, params, batch, plain=plain)
                return logits
            return B.prefill(cfg, params, batch, cache, plain=plain,
                             specs=cache_specs)

    return prefill_step


def make_decode_step(mesh, cfg: ArchConfig, *, plain: bool = False,
                     cache_specs=None):
    """``decode(params, cache, tokens, pos, enc_out=None)``: (logits (B, 1,
    V), the new cache) for the token at position ``pos``; on a mesh of
    ranks each this rank's block, ``cache_specs`` the cache's specs."""
    dev = _mesh_device(mesh, "make_decode_step")

    def decode(params, cache, tokens: torch.Tensor, pos,
               enc_out: Optional[torch.Tensor] = None):
        tokens, enc_out = _on(dev, params, tokens, enc_out)
        with torch.inference_mode(), ctx.use_mesh(mesh):
            return B.decode_step(cfg, params, cache, tokens, pos, enc_out,
                                 plain=plain, specs=cache_specs)

    return decode


def jit_serve_steps(mesh, cfg: ArchConfig, batch: int, max_seq: int,
                    prefill_shapes=None, *, plain: bool = False):
    """``(decode, param_specs, cache_specs)`` for a decode cache of
    ``batch`` rows and ``max_seq`` positions: JAX compiles the decode step
    under those shardings, the port runs it eagerly on each rank's
    blocks (``sharding.shard_tree``)."""
    pspecs = S.param_specs(mesh, cfg, B.param_specs(cfg))
    cspecs = S.cache_specs(mesh, cfg, B.cache_specs(cfg, batch, max_seq))
    decode = make_decode_step(mesh, cfg, plain=plain, cache_specs=cspecs)
    return decode, pspecs, cspecs

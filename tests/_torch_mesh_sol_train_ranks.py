"""Rank functions for ``tests/test_torch_mesh_sol_train.py``: each runs
inside a process that ``repro_torch.launch.mesh.run_on_mesh`` spawned, so
it imports the port and torch alone and returns picklable numpy results.
:func:`job` compiles one transformer stack for training on its mesh and
runs every case of the file there."""
import contextlib

import torch
from torch import nn as tnn

from repro_torch.convert import load_numpy_state_dict
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as S
from repro_torch.distributed import steps as ST
from repro_torch.frontends import nn
from repro_torch.frontends.optimize import optimize


def stack(sd, d, heads, layers, vocab=None):
    """``layers`` transformer blocks (and with ``vocab`` a Linear head)
    carrying ``sd``."""
    mods = [nn.transformer_block(d, heads, device="cpu")
            for _ in range(layers)]
    if vocab is not None:
        mods.append(nn.Linear(d, vocab, device="cpu"))
    return load_numpy_state_dict(tnn.Sequential(*mods), sd)


@contextlib.contextmanager
def tally(mesh, seen: dict):
    """Count ``mesh``'s all-reduces that cross ranks by their axes (in the
    mesh's order) in ``seen`` while the block runs."""
    real = mesh.all_reduce

    def counted(t, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if mesh.span(axes) > 1:
            key = tuple(a for a in mesh.axis_names if a in axes)
            seen[key] = seen.get(key, 0) + 1
        return real(t, axes)
    mesh.all_reduce = counted
    try:
        yield seen
    finally:
        del mesh.all_reduce


def _np_tree(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def job(mesh, sd, dims, x, y, opts_kw, steps, head=None):
    """On ``mesh``: the gathered step-0 gradients and loss
    (``make_sol_grad_step``), the all-reduces of one forward, of its
    backward and of one train step by axes, ``steps`` train steps' losses
    and gathered parameters, and the gathered gradients again with the
    column-parallel inputs' backward all-reduce left out; with ``head``
    (:func:`head_job`'s arguments after the mesh) also its results."""
    d, heads, layers = dims
    sm = optimize(stack(sd, d, heads, layers), x.shape, backend="h100",
                  training=True, device="cpu", mesh=mesh)
    batch = S.shard_tree(mesh, {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y)},
                         ST.sol_batch_specs(sm))
    params = sm._params_for_call()
    grad_step = ST.make_sol_grad_step(sm)
    loss, grads = grad_step(params, batch)
    out = {"coords": dict(mesh.coords), "loss": float(loss),
           "grads": _np_tree(ST.gather_sol_tree(sm, grads)),
           "local_shapes": {k: tuple(v.shape) for k, v in params.items()}}

    # the graph's collectives of one forward and of its backward
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with tally(mesh, {}) as fwd:
        l0 = ST.mse(sm._fn(live, batch["x"]), batch)
    with tally(mesh, {}) as bwd:
        torch.autograd.grad(l0, list(live.values()))
    out["forward"], out["backward"] = fwd, bwd

    step, init = ST.make_sol_train_step(sm, ST.StepOptions(**opts_kw))
    state, losses, per_step = init(), [], []
    for _ in range(steps):
        with tally(mesh, {}) as seen:
            state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        per_step.append(seen)
    out.update(losses=losses, step_all_reduces=per_step,
               params=_np_tree(ST.gather_sol_tree(sm, state["params"])),
               grad_norm=float(metrics["grad_norm"]))

    # planted: the column-parallel inputs' backward all-reduce left out
    real = collectives.copy_over
    collectives.copy_over = lambda t, mesh_, axes: t
    try:
        _, bad = grad_step(params, batch)
    finally:
        collectives.copy_over = real
    out["fault_grads"] = _np_tree(ST.gather_sol_tree(sm, bad))
    if head is not None:
        out["head"] = head_job(mesh, *head)
    return out


def head_job(mesh, sd, dims, x, y):
    """The stack with a vocab-parallel head (its output sharded over
    ``model``) on ``mesh``: the output spec, the step-0 loss and the
    gathered gradients."""
    sm = optimize(stack(sd, *dims), x.shape, backend="h100", training=True,
                  device="cpu", mesh=mesh)
    batch = S.shard_tree(mesh, {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y)},
                         ST.sol_batch_specs(sm))
    loss, grads = ST.make_sol_grad_step(sm)(sm._params_for_call(), batch)
    return {"out_spec": tuple(sm.graph.output_specs[0]),
            "y_spec": tuple(ST.sol_batch_specs(sm)["y"]),
            "loss": float(loss),
            "grads": _np_tree(ST.gather_sol_tree(sm, grads))}

"""Rank functions for ``tests/test_torch_mesh_backbone.py``: each runs
inside a process that ``repro_torch.launch.mesh.run_on_mesh`` spawned, so
it imports the port and torch alone and returns picklable numpy results.
:func:`job` runs every case on one (2, 2) mesh; rank 0 returns the
gathered trees, every rank its own rows of the logits."""
import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.convert import train_state_from_numpy
from repro_torch.distributed import ctx
from repro_torch.distributed import sharding as S
from repro_torch.distributed import steps as ST
from repro_torch.models import backbone as B
from repro_torch.models import layers as L


def _np(t):
    return t.detach().float().numpy()


def _np_tree(tree):
    return B.tree_map(_np, tree)


def _check_blocks(mesh, local, whole, specs):
    """Every leaf of ``local`` has its spec's block shape of ``whole``'s."""
    shapes = dict(B.tree_leaves(whole))
    sp = dict(B.tree_leaves(specs, leaf=S.P))
    for path, leaf in B.tree_leaves(local):
        want = S.local_shape(mesh, tuple(shapes[path].shape), sp[path])
        assert tuple(leaf.shape) == want, (path, tuple(leaf.shape), want)


def _rows(mesh, batch):
    return S.shard_tree(mesh, batch, S.batch_specs(mesh, None, batch))


def serve(mesh, name, state, tokens, gen):
    """Prefill that fills a sharded cache, then ``gen`` greedy decode
    steps through ``jit_serve_steps``: this rank's rows of the prefill
    logits, of each step's logits and of the tokens."""
    cfg = get_smoke(name)
    params = train_state_from_numpy(cfg, state, "cpu")["params"]
    b, s = tokens.shape
    decode, pspecs, cspecs = ST.jit_serve_steps(mesh, cfg, b, s + gen)
    local = S.shard_tree(mesh, params, pspecs)
    cache = S.shard_tree(mesh, B.init_cache(cfg, b, s + gen, "cpu"), cspecs)
    prefill = ST.make_prefill_step(mesh, cfg, cache_specs=cspecs)
    logits, cache = prefill(local, _rows(mesh, {"tokens": torch.from_numpy(
        tokens).long()}), cache)
    rows, tok = [logits[:, -1]], logits[:, -1].argmax(-1)
    toks = [tok]
    for j in range(gen):
        lg, cache = decode(local, cache, tok[:, None], s + j)
        rows.append(lg[:, 0])
        tok = lg[:, 0].argmax(-1)
        toks.append(tok)
    return {"prefill": _np(logits), "steps": np.stack([_np(r) for r in rows],
                                                      1),
            "tokens": torch.stack(toks, 1).numpy()}


def train(mesh, name, state, batch, opts_kw):
    """One ``make_train_step`` step from ``state`` on the mesh, with ZeRO
    on and off: the loss and metrics, and on rank 0 the gathered
    gradients (``make_grad_step``), new parameters and moments."""
    cfg = get_smoke(name)
    whole = train_state_from_numpy(cfg, state, "cpu")
    tb = _rows(mesh, {k: torch.from_numpy(v) for k, v in batch.items()})
    out, grads = {}, None
    for zero in (True, False):
        opts = ST.StepOptions(zero=zero, **opts_kw)
        step, specs = ST.make_train_step(mesh, cfg, opts)
        local = S.shard_tree(mesh, whole, specs)
        _check_blocks(mesh, local, whole, specs)
        if grads is None:       # the parameters' blocks do not see ZeRO
            loss, _, grads = ST.make_grad_step(mesh, cfg, opts)(
                local["params"], tb)
            grads = S.gather_tree(mesh, grads, specs["params"])
        new, metrics = step(local, tb)
        new = S.gather_tree(mesh, new, specs)
        rec = {"loss": float(loss),
               "metrics": {k: float(v) for k, v in metrics.items()}}
        if mesh.rank == 0:
            rec.update(grads=_np_tree(grads), new=_np_tree(new))
        out["zero" if zero else "no_zero"] = rec
    return out


def moe(mesh, p, x, w, moe_kw):
    """The MoE alone on this rank's data rows (and its experts, where the
    model axis divides them: expert-parallel; else every expert, dense),
    on both routes: the output rows, the aux loss and the gradients of
    ``sum(out * w) + aux`` (x's rows, the router's and the experts'
    gathered over ``model``)."""
    from repro_torch.models.config import MoEConfig
    mcfg = MoEConfig(**moe_kw)
    specs = {k: S.param_spec(mesh, None, ("head", "layer0", "moe", k),
                             v.shape) for k, v in p.items()}
    local = S.shard_tree(mesh, {k: torch.from_numpy(v) for k, v in p.items()},
                         specs)
    rows = S.NamedSharding(mesh, S.P("data", None, None))
    xl = rows.shard(torch.from_numpy(x)).requires_grad_(True)
    wl = rows.shard(torch.from_numpy(w))
    out = {}
    for plain in (False, True):
        live = {k: v.detach().requires_grad_(True) for k, v in local.items()}
        with ctx.use_mesh(mesh):
            y, aux = L.moe_apply(live, xl, mcfg, plain=plain)
            gx, *gp = torch.autograd.grad((y * wl).sum() + aux,
                                          [xl] + [live[k] for k in sorted(
                                              live)])
        grads = dict(zip(sorted(live), gp))
        grads = S.gather_tree(mesh, grads, specs)
        out["plain" if plain else "kernel"] = {
            "y": _np(y), "aux": float(aux), "gx": _np(gx),
            "grads": _np_tree(grads)}
    return out


def checkpoint(mesh, name, opts_kw, src, dst):
    """Restore the one-process checkpoint in ``src`` onto this rank's
    blocks and write it back to ``dst`` from the mesh, through the
    trainer's path (``CheckpointManager`` with ``shardings=``), and on
    rank 0 return the restored tree gathered."""
    cfg = get_smoke(name)
    opts = ST.StepOptions(**opts_kw)
    specs = ST.make_train_state_specs(mesh, cfg, opts)
    placed = S.named(mesh, specs)
    step, local = CheckpointManager(src).restore_latest(
        ST.train_state_shapes(cfg, opts), shardings=placed)
    assert step == 3, step
    _check_blocks(mesh, local, ST.train_state_shapes(cfg, opts), specs)
    gathered = S.gather_tree(mesh, local, specs)
    assert CheckpointManager(dst, interval=7).maybe_save(
        7, local, block=True, shardings=placed)
    mesh.barrier()
    return _np_tree(gathered) if mesh.rank == 0 else None


def job(mesh, serve_cases, train_cases, moe_cases, ckpt_case):
    """Every case on this rank, in one order on every rank."""
    torch.manual_seed(0)
    out = {"coords": dict(mesh.coords), "serve": {}, "train": {}}
    for name, args in serve_cases.items():
        out["serve"][name] = serve(mesh, name, *args)
    for name, args in train_cases.items():
        out["train"][name] = train(mesh, name, *args)
    out["moe"] = {k: moe(mesh, *args) for k, args in moe_cases.items()}
    out["checkpoint"] = checkpoint(mesh, *ckpt_case)
    return out

"""The backbone's loss and gradients in the port held to the JAX package's,
on the CPU.

For each of the ten reduced configs (``get_smoke``) the JAX parameter tree
is carried into the port (``convert.backbone_params_from_numpy``) and both
packages take the same batch from a seed (tokens, labels with masked
positions, the modality stubs' inputs):

* ``loss_fn``'s total, ``ce`` and ``aux`` within 1e-5 relative of JAX's
  ``loss_fn``, on both of the port's routes (on the CPU the kernel route
  takes each kernel's plain version, through the explicit backwards);
* for qwen2, recurrentgemma, rwkv6, olmoe and whisper, the gradient of
  every parameter leaf within 1e-4 of the JAX leaf's L2 norm (``jax.grad``
  of ``loss_fn``), on the kernel route with remat and on the plain route
  without.

The JAX side of each config is computed once, in a module-scoped fixture.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke as jget_smoke
from repro.models import backbone as JB
from repro_torch.configs import get_smoke
from repro_torch.convert import backbone_params_from_numpy
from repro_torch.models import backbone as TB

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each reference leaf's L2 norm
GRAD_ARCHS = ("qwen2_1_5b", "recurrentgemma_9b", "rwkv6_1_6b",
              "olmoe_1b_7b", "whisper_tiny")
BSZ, SEQ = 2, 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these steps are many small ops, and torch's
    default thread count in each of several test workers oversubscribes
    the cores (a 12-step RWKV6 run took 80 s instead of 2 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _batch(cfg, seed: int = 0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab, (BSZ, SEQ + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                    # masked positions carry no loss
    out = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.frontend == "vision":
        out["patches"] = (0.1 * r.standard_normal(
            (BSZ, cfg.n_patches, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "audio":
        out["frames"] = (0.1 * r.standard_normal(
            (BSZ, cfg.enc_dec.enc_seq, cfg.d_model))).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    """The JAX loss (and for ``GRAD_ARCHS`` its gradients) of one config,
    with the port's parameters and batch."""
    a = request.param
    jc, tc = jget_smoke(a), get_smoke(a)
    jp = JB.init_params(jc, jax.random.PRNGKey(0))
    batch = _batch(tc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return JB.loss_fn(jc, p, jb)
    if a in GRAD_ARCHS:
        (total, metrics), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(jp)
        grads = dict(TB.tree_leaves(_np_tree(grads)))
    else:
        (total, metrics), grads = jax.jit(loss)(jp), None
    return {"arch": a, "cfg": tc,
            "params": backbone_params_from_numpy(tc, _np_tree(jp),
                                                 device="cpu"),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "loss": float(total), "ce": float(metrics["ce"]),
            "aux": float(metrics["aux"]), "grads": grads}


def _rel(got, want) -> float:
    return abs(float(got) - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_loss_matches_jax(arch, plain):
    with torch.no_grad():
        total, metrics = TB.loss_fn(arch["cfg"], arch["params"],
                                    arch["batch"], plain=plain)
    assert _rel(total, arch["loss"]) <= LOSS_RTOL
    assert _rel(metrics["ce"], arch["ce"]) <= LOSS_RTOL
    assert abs(float(metrics["aux"]) - arch["aux"]) <= \
        LOSS_RTOL * max(abs(arch["aux"]), 1.0)


@pytest.mark.parametrize("route", ["kernel_remat", "plain"])
@pytest.mark.parametrize("arch", GRAD_ARCHS, indirect=True)
def test_gradients_match_jax(arch, route):
    live = TB.tree_map(lambda p: p.detach().requires_grad_(True),
                       arch["params"])
    total, _ = TB.loss_fn(arch["cfg"], live, arch["batch"],
                          remat=route == "kernel_remat",
                          plain=route == "plain")
    paths, leaves = zip(*TB.tree_leaves(live))
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    assert set(paths) == set(arch["grads"])
    for path, leaf, g in zip(paths, leaves, grads):
        want = arch["grads"][path]
        got = np.zeros_like(want) if g is None else g.float().numpy()
        norm = float(np.linalg.norm(want))
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOL * max(norm, 1e-30), (path, err, norm)


def test_remat_gives_the_same_gradients():
    """Recomputing each macro block in the backward changes no value."""
    cfg = get_smoke("recurrentgemma_9b")
    params = TB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = []
    for remat in (False, True):
        live = TB.tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, _ = TB.loss_fn(cfg, live, batch, remat=remat)
        leaves = [x for _, x in TB.tree_leaves(live)]
        out.append(torch.autograd.grad(total, leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

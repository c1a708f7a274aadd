"""Training through the port's elected graph against the JAX package's, on
the CPU: the backward elections of both packages, whole training runs from
the same weights (``tests/test_train_sol.py``'s transformer and Griffin
cases, and RWKV6), AdamW and the cosine schedule on the same arrays, and
``python -m repro_torch.launch.train --smoke --sol --device cpu`` for each
zoo block.  Weights are numpy, seeded, loaded into the JAX modules and
carried over with ``load_numpy_state_dict``.  Small sizes (d 32, B 2,
S 16); losses within 1e-4 and final params within rtol 1e-3, atol 1e-4
(``tests/test_train_sol.py``'s tolerances), the optimizer within f32's
1e-6."""
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.distributed.steps import StepOptions as JStepOptions
from repro.distributed.steps import make_sol_train_step as j_train_step
from repro.frontends import nn as jnn
from repro.frontends.optimize import optimize as j_optimize
from repro_torch import optim as topt
from repro_torch.convert import load_numpy_state_dict
from repro_torch.core import autotune as TAT
from repro_torch.distributed.steps import StepOptions, make_sol_train_step
from repro_torch.frontends import nn
from repro_torch.frontends.optimize import optimize

ROOT = Path(__file__).resolve().parents[1]
B, S, D = 2, 16, 32
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=1e-3, atol=1e-4)
# the port's backward impls and the JAX package's, one for one
GRAD_MAP = {"cuda.linear_bwd": "pallas.linear_mxu_bwd",
            "cuda.matmul_bwd": "pallas.matmul_mxu_bwd",
            "cuda.rglru_scan_bwd": "pallas.rglru_scan_bwd"}
BACKEND_PAIRS = [("h100", "pallas_interpret"), ("torch_ref", "xla")]


@pytest.fixture(autouse=True)
def _empty_port_autotune_cache():
    prev = TAT._CACHE
    TAT.set_cache(TAT.AutotuneCache())
    yield
    TAT.set_cache(prev)


def zoo(name: str, seed: int = 0):
    """The same zoo block in both packages: seeded numpy weights (gains
    and biases too) loaded into the JAX module, then carried over."""
    build = {"transformer": (lambda: jnn.transformer_block(D, 2),
                             lambda: nn.transformer_block(D, 2,
                                                          device="cpu")),
             "griffin": (lambda: jnn.griffin_block(D),
                         lambda: nn.griffin_block(D, device="cpu")),
             "rwkv6": (lambda: jnn.rwkv6_block(D),
                       lambda: nn.rwkv6_block(D, device="cpu"))}[name]
    jm, tm = build[0](), build[1]()
    rng = np.random.default_rng(seed)
    sd = {k: (rng.standard_normal(np.shape(v)) * 0.2).astype(np.float32)
          for k, v in jm.named_parameters().items()}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    load_numpy_state_dict(tm, sd)
    return jm, tm


@pytest.mark.parametrize("name", ["transformer", "griffin", "rwkv6"])
@pytest.mark.parametrize("port_bk,jax_bk", BACKEND_PAIRS,
                         ids=["h100-pallas_interpret", "torch_ref-xla"])
def test_backward_decisions_equal_jax(name, port_bk, jax_bk):
    """``optimize(training=True)`` elects the JAX package's backward impl
    at every node (``pallas.`` read as ``cuda.``), with the same forward
    elections and the same ``_bwd`` kinds in ``impl_report``."""
    jm, tm = zoo(name)
    js = j_optimize(jm, (B, S, D), backend=jax_bk, training=True)
    ts = optimize(tm, (B, S, D), backend=port_bk, training=True,
                  device="cpu")
    jt, tt = js.graph.topo(), ts.graph.topo()
    assert [n.op.value for n in tt] == [n.op.value for n in jt]
    assert [GRAD_MAP.get(n.impl_bwd, n.impl_bwd) for n in tt] == \
        [n.impl_bwd for n in jt]
    tk, jk = ts.impl_report(by_kind=True), js.impl_report(by_kind=True)
    assert {k for k in tk if k.endswith("_bwd")} == \
        {k for k in jk if k.endswith("_bwd")}
    for kind in (k for k in tk if k.endswith("_bwd")):
        assert {GRAD_MAP.get(i, i): c for i, c in tk[kind].items()} == \
            jk[kind]
    # no heavy kind runs a reference backward on the kernel backend
    if port_bk == "h100":
        assert not [i for k, v in tk.items() if k.endswith("_bwd")
                    for i in v if i.startswith("ref.")]


def _data():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


def _train_jax(sm, opts, x, y, steps):
    step_fn, init = j_train_step(sm, opts)
    jitted = jax.jit(step_fn)
    state, losses = init(), []
    for _ in range(steps):
        state, metrics = jitted(state, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
        losses.append(float(metrics["loss"]))
    return losses, {k: np.asarray(v) for k, v in state["params"].items()}


def _train_port(sm, opts, x, y, steps):
    step_fn, init = make_sol_train_step(sm, opts)
    state, losses = init(), []
    for _ in range(steps):
        state, metrics = step_fn(state, {"x": torch.from_numpy(x),
                                         "y": torch.from_numpy(y)})
        losses.append(float(metrics["loss"]))
    return losses, {k: v.detach().numpy() for k, v in state["params"].items()}


TRAIN_CASES = [  # (model, port backend, JAX backend, steps, lr, warmup)
    pytest.param("transformer", "h100", "xla", 8, 1e-2, 2,
                 id="transformer-h100"),
    pytest.param("transformer", "torch_ref", "xla", 8, 1e-2, 2,
                 id="transformer-torch_ref"),
    pytest.param("griffin", "h100", "pallas_interpret", 4, 1e-2, 1,
                 id="griffin-h100"),
    pytest.param("rwkv6", "h100", "xla", 4, 1e-2, 1, id="rwkv6-h100"),
]


@pytest.mark.parametrize("name,port_bk,jax_bk,steps,lr,warmup", TRAIN_CASES)
def test_training_matches_jax(name, port_bk, jax_bk, steps, lr, warmup):
    """Both packages train the same block from the same weights on the
    same data through ``make_sol_train_step``: every step's loss and the
    final params agree, and the loss falls."""
    jm, tm = zoo(name)
    x, y = _data()
    js = j_optimize(jm, (B, S, D), backend=jax_bk, training=True)
    ts = optimize(tm, (B, S, D), backend=port_bk, training=True,
                  device="cpu")
    j_losses, j_params = _train_jax(
        js, JStepOptions(lr=lr, warmup=warmup, total_steps=steps,
                         zero=False), x, y, steps)
    t_losses, t_params = _train_port(
        ts, StepOptions(lr=lr, warmup=warmup, total_steps=steps), x, y,
        steps)
    np.testing.assert_allclose(t_losses, j_losses, **LOSS_TOL)
    assert t_losses[-1] < t_losses[0]
    assert sorted(t_params) == sorted(j_params)
    for k in sorted(j_params):
        np.testing.assert_allclose(t_params[k], j_params[k], **PARAM_TOL,
                                   err_msg=f"param {k}")
    # the module's own weights are untouched: the update is functional
    for k, v in tm.state_dict().items():
        if k in ts.graph.params:
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(jm.state_dict()[k]))


# -- the optimizer ------------------------------------------------------------

@pytest.mark.parametrize("clip", [1.0, 0.0, 1e-3])
def test_adamw_equals_jax(clip):
    """Three updates of a dict of tensors, clipped (down to a tight clip)
    or not: params, f32 moments, step and grad norm as the JAX
    package's."""
    rng = np.random.default_rng(11)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jc = jopt.AdamWConfig(lr=1e-2, grad_clip=clip)
    tc = topt.AdamWConfig(lr=1e-2, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jopt.init_opt_state(jp, jc), topt.init_opt_state(tp, tc)
    for i, g in enumerate(grads):
        lr_j = jopt.cosine_schedule(jnp.asarray(i), peak_lr=1e-2, warmup=1,
                                    total=3)
        lr_t = topt.cosine_schedule(torch.tensor(i), peak_lr=1e-2,
                                    warmup=1, total=3)
        np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)
        jp, js, jm = jopt.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jc, lr_j)
        tp, ts, tm = topt.adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tc,
            lr_t)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        for mom in ("m", "v"):
            assert ts[mom][k].dtype == torch.float32
            np.testing.assert_allclose(
                ts[mom][k].numpy(),
                np.asarray(js[mom][k], np.float32), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 60, 100, 140])
def test_cosine_schedule_equals_jax(step):
    kw = dict(peak_lr=3e-3, warmup=10, total=100, min_frac=0.1)
    np.testing.assert_allclose(
        float(topt.cosine_schedule(step, **kw)),
        float(jopt.cosine_schedule(jnp.asarray(step), **kw)), rtol=1e-6)


def test_train_step_leaves_its_state_alone():
    """``train_step`` returns new tensors and writes none of the state it
    was given (the JAX step's functional contract)."""
    _, tm = zoo("transformer")
    ts = optimize(tm, (B, S, D), backend="h100", training=True, device="cpu")
    step_fn, init = make_sol_train_step(ts, StepOptions(lr=1e-2, warmup=1,
                                                        total_steps=2))
    state = init()
    before = {k: v.clone() for k, v in state["params"].items()}
    x, y = (torch.from_numpy(a) for a in _data())
    state2, metrics = step_fn(state, {"x": x, "y": y})
    state3, _ = step_fn(state2, {"x": x, "y": y})
    for k, v in state["params"].items():
        assert torch.equal(v, before[k])
    assert int(state3["step"]) == 2 and int(state3["opt"]["step"]) == 2
    assert set(metrics) == {"loss", "lr", "grad_norm"}
    assert any(not torch.equal(state3["params"][k], before[k])
               for k in before)


# -- the CLI ------------------------------------------------------------------

def _train_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("model", ["transformer", "griffin", "rwkv6"])
def test_train_cli_smoke_sol_on_cpu(model):
    """Warm-up, both gates and a falling loss, each backward election
    printed with its provenance."""
    out = _train_cli("--smoke", "--sol", "--device", "cpu", "--sol-model",
                     model, "--steps", "20")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "strict provenance clean" in out.stdout
    assert "(improved)" in out.stdout
    assert "linear_bwd → cuda.linear_bwd: {'measured'" in out.stdout
    scan = {"griffin": "rglru_scan_bwd → cuda.rglru_scan_bwd",
            "rwkv6": "rwkv6_scan_bwd → ckpt.rwkv6_scan_bwd",
            "transformer": "attention_bwd → flash.attention_bwd"}[model]
    assert scan in out.stdout


def test_train_cli_without_sol_names_the_roadmap_item():
    """Body rewritten, name kept: without --sol the driver trains the
    backbone; the production mesh (``make_production_mesh``) needs a
    process group of world size 256, and the CLI says so."""
    out = _train_cli("--smoke", "--device", "cpu", "--production-mesh")
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr
    assert "world size 256" in out.stderr

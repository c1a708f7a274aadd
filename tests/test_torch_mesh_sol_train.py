"""Training a sharded SOL graph in the port, held to the JAX package on
the CPU.

``optimize(..., training=True, mesh=...)`` of a stack of the JAX test's
transformer blocks (``tests/test_train_sol.py``: d 32, 2 heads, (2, 16, 32)
inputs; two blocks here, so the counts read per block) runs on each of the
(data, model) meshes (1, 2), (2, 1) and (2, 2): one module-scoped
``launch.mesh.run_on_mesh`` job per mesh (gloo ranks on the CPU, one
intra-op thread each), whose results the tests read:

* the gathered gradients (``steps.make_sol_grad_step``, the mean over the
  data shards) against ``jax.grad`` of the JAX package's single-device
  ``xla`` graph on the same weights and batch, at that test's tolerances
  (rtol 1e-4, atol 1e-5), and against the port's one-process gradients
  within 1e-6 of each gradient's norm;
* ``make_sol_train_step`` steps against JAX's single-device
  ``make_sol_train_step``: every loss within 1e-5, the gathered
  parameters within rtol 1e-3, atol 1e-4;
* the all-reduces: two over ``model`` in a block's forward (the
  row-parallel o and down products) and two in its backward (where the
  replicated input enters the column-parallel q/k/v and up products), one
  over ``data`` a step (the gradients and the loss) and one over
  ``model`` for the clip's global norm;
* a planted fault: with ``collectives.copy_over`` the identity (the
  backward all-reduce left out) the gradients fail the check.

The pytest process never joins a process group.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_sol_train_ranks as R
from repro.distributed.steps import StepOptions as JStepOptions
from repro.distributed.steps import make_sol_train_step as j_train_step
from repro.frontends import nn as jnn
from repro.frontends.optimize import optimize as j_optimize
from repro_torch.distributed import sharding as TS
from repro_torch.distributed import steps as TST
from repro_torch.frontends import extract as text
from repro_torch.frontends.optimize import compile_graph, optimize
from repro_torch.launch import mesh as tmesh

B, S, D, HEADS, LAYERS = 2, 16, 32, 2, 2
VOCAB = 64
STEPS = 3
OPTS = dict(lr=1e-2, warmup=1, total_steps=STEPS)
MESHES = [(1, 2), (2, 1), (2, 2)]
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_train_sol.py's
PARAM_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other mesh files pin it: many small ops
    under several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed: int = 0, head: bool = False):
    """The JAX stack (with ``head`` a Linear(D, VOCAB) after it) and its
    weights as numpy, drawn from ``seed``."""
    jm = jnn.Sequential(*[jnn.transformer_block(D, HEADS)
                          for _ in range(LAYERS)],
                        *([jnn.Linear(D, VOCAB)] if head else []))
    rng = np.random.default_rng(seed)
    sd = {k: (rng.standard_normal(np.shape(v)) * 0.2).astype(np.float32)
          for k, v in sorted(jm.named_parameters().items())}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    return jm, sd


def _data():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


def _mse(out, y):
    return ((out.astype(jnp.float32) - y) ** 2).mean()


@pytest.fixture(scope="module")
def ref():
    """The single-device references: JAX's ``jax.grad`` and training run
    on the ``xla`` graph, and the port's one-process gradients."""
    jm, sd = _weights()
    x, y = _data()
    jsm = j_optimize(jm, (B, S, D), backend="xla", training=True)
    params = {k: jnp.asarray(sd[k]) for k in jsm.graph.params}
    jloss, jgrads = jax.value_and_grad(
        lambda p: _mse(jsm._fn(p, jnp.asarray(x)), jnp.asarray(y)))(params)
    step_fn, init = j_train_step(jsm, JStepOptions(zero=False, **OPTS))
    jitted = jax.jit(step_fn)
    state, losses = init(), []
    for _ in range(STEPS):
        state, metrics = jitted(state, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
        losses.append(float(metrics["loss"]))
    tsm = optimize(R.stack(sd, D, HEADS, LAYERS), (B, S, D),
                   backend="h100", training=True, device="cpu")
    tloss, tgrads = TST.make_sol_grad_step(tsm)(
        tsm._params_for_call(), {"x": torch.from_numpy(x),
                                 "y": torch.from_numpy(y)})
    # the stack with a Linear(D, VOCAB) head, for the (2, 2) job
    hjm, hsd = _weights(head=True)
    hy = np.random.default_rng(8).standard_normal((B, S, VOCAB)).astype(
        np.float32)
    hjsm = j_optimize(hjm, (B, S, D), backend="xla", training=True)
    hloss, hgrads = jax.value_and_grad(
        lambda p: _mse(hjsm._fn(p, jnp.asarray(x)), jnp.asarray(hy)))(
            {k: jnp.asarray(hsd[k]) for k in hjsm.graph.params})
    return {"sd": sd, "x": x, "y": y, "jax_loss": float(jloss),
            "jax_grads": {k: np.asarray(v) for k, v in jgrads.items()},
            "jax_losses": losses,
            "jax_params": {k: np.asarray(v)
                           for k, v in state["params"].items()},
            "port_loss": float(tloss),
            "port_grads": {k: v.numpy() for k, v in tgrads.items()},
            "head": {"sd": hsd, "y": hy, "jax_loss": float(hloss),
                     "jax_grads": {k: np.asarray(v)
                                   for k, v in hgrads.items()}}}


_JOBS = {}


def _job(ref, mesh):
    """The ranks' results on ``mesh``, run once per module; the (2, 2)
    job also runs the stack with the vocab-parallel head."""
    if mesh not in _JOBS:
        h = ref["head"]
        head = ((h["sd"], (D, HEADS, LAYERS, VOCAB), ref["x"], h["y"])
                if mesh == (2, 2) else None)
        _JOBS[mesh] = tmesh.run_on_mesh(
            R.job, *mesh, device="cpu", dist_backend="gloo", timeout_s=120,
            args=(ref["sd"], (D, HEADS, LAYERS), ref["x"], ref["y"], OPTS,
                  STEPS, head))
    return _JOBS[mesh]


def _norm_gap(got, want) -> float:
    return max(float(np.linalg.norm(got[k] - want[k])
                     / np.linalg.norm(want[k])) for k in want)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_mesh_gradients_equal_jax_single_device(ref, mesh):
    for r in _job(ref, mesh):
        assert set(r["grads"]) == set(ref["jax_grads"])
        for k, want in ref["jax_grads"].items():
            np.testing.assert_allclose(r["grads"][k], want, **GRAD_TOL,
                                       err_msg=f"grad {k} on {mesh}")
        np.testing.assert_allclose(r["loss"], ref["jax_loss"], rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_mesh_gradients_equal_one_process(ref, mesh):
    for r in _job(ref, mesh):
        assert _norm_gap(r["grads"], ref["port_grads"]) <= 1e-6
        np.testing.assert_allclose(r["loss"], ref["port_loss"], rtol=1e-6)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_mesh_train_steps_equal_jax_single_device(ref, mesh):
    for r in _job(ref, mesh):
        np.testing.assert_allclose(r["losses"], ref["jax_losses"],
                                   rtol=1e-5)
        assert r["losses"][-1] < r["losses"][0]
        for k, want in ref["jax_params"].items():
            np.testing.assert_allclose(r["params"][k], want, **PARAM_TOL,
                                       err_msg=f"param {k} on {mesh}")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=str)
def test_backward_all_reduce_left_out_fails_the_gradient_check(ref, mesh):
    r = _job(ref, mesh)[0]
    assert _norm_gap(r["fault_grads"], ref["port_grads"]) > 1e-2
    with pytest.raises(AssertionError):
        for k, want in ref["jax_grads"].items():
            np.testing.assert_allclose(r["fault_grads"][k], want,
                                       **GRAD_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_all_reduces_per_block_and_per_step(ref, mesh):
    """Two model all-reduces in a block's forward and two in its
    backward; a step adds one data mean (gradients and loss together) and
    the global norm's one over ``model``."""
    data, model = mesh
    per_block = {("model",): 2 * LAYERS} if model > 1 else {}
    step = {}
    if model > 1:
        step[("model",)] = 4 * LAYERS + 1
    if data > 1:
        step[("data",)] = 1
    for r in _job(ref, mesh):
        assert r["forward"] == per_block
        assert r["backward"] == per_block
        assert r["step_all_reduces"] == [step] * STEPS


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_ranks_hold_their_blocks_and_agree(ref, mesh):
    res = _job(ref, mesh)
    data, model = mesh
    assert [r["coords"] for r in res] == [
        {"data": d, "model": m} for d in range(data) for m in range(model)]
    for r in res:
        assert r["losses"] == res[0]["losses"]
        assert r["grad_norm"] == res[0]["grad_norm"]
        # q/k/v and the MLP's up product column-parallel, o and down
        # row-parallel: every weight holds 1/model of its features
        for blk in range(LAYERS):
            shapes = {k[len(f"{blk}."):]: v
                      for k, v in r["local_shapes"].items()
                      if k.startswith(f"{blk}.")}
            assert shapes["0.1.wq"] == (D, D // model)
            assert shapes["0.1.wo"] == (D // model, D)
            assert shapes["1.1.weight"] == (4 * D // model, D)
            assert shapes["1.3.weight"] == (D, 4 * D // model)


def test_model_sharded_output_is_gathered_for_the_loss(ref):
    """A vocab-parallel head leaves the output sharded over ``model``: the
    loss reads it joined (``gather_over``, whose backward keeps the rank's
    block) against the target's rows, and the gradients still equal
    ``jax.grad`` on one device."""
    want = ref["head"]
    for r in _job(ref, (2, 2)):
        h = r["head"]
        assert h["out_spec"] == ("data", None, "model")
        assert h["y_spec"] == ("data", None, None)
        np.testing.assert_allclose(h["loss"], want["jax_loss"], rtol=1e-5)
        for k, g in want["jax_grads"].items():
            np.testing.assert_allclose(h["grads"][k], g, **GRAD_TOL,
                                       err_msg=f"grad {k}")


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_column_parallel_products_come_from_the_specs(mesh):
    """The products whose input gradient the lowering all-reduces, read
    from ``param_specs`` alone: each block's q, k, v and MLP up products,
    none where the model axis has one rank."""
    _, sd = _weights()
    g = TS.shard_graph(text.extract(R.stack(sd, D, HEADS, LAYERS),
                                    (B, S, D)), TS.AbstractMesh(mesh))
    cols = TS.column_parallel(g)
    name_of = {id(n): k for k, n in g.params.items()}
    got = {name_of[id(n.inputs[1])] for n in g.topo() if id(n) in cols}
    want = {f"{b}.{w}" for b in range(LAYERS)
            for w in ("0.1.wq", "0.1.wk", "0.1.wv", "1.1.weight")}
    assert got == (want if mesh[1] > 1 else set())
    assert set(cols.values()) <= {("model",)}


def test_training_on_an_abstract_mesh_needs_process_groups():
    _, sd = _weights()
    m = R.stack(sd, D, HEADS, LAYERS)
    with pytest.raises(ValueError, match="process groups"):
        compile_graph(m, text.extract(m, (B, S, D)), "h100", device="cpu",
                      mesh=TS.AbstractMesh((1, 2)), training=True)

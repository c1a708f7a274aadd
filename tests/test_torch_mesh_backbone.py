"""The model-zoo backbone's sharded execution in the port held to the JAX
package, on the CPU.

One module-scoped job (``launch.mesh.run_on_mesh``: four spawned gloo
ranks on a (2, 2) (data, model) mesh) runs every case, and the tests hold
its results to the JAX package on the same weights (one numpy train
state, carried into the port with ``convert.train_state_from_numpy``)
and the same seeded numpy batches, at the
conformance table's f32 limit (1e-5 of the reference's scale; RWKV6
1e-4):

The weights come from the port's ``init_train_state`` (seeded) as numpy
trees, which JAX takes as they are (its random init is slow eagerly); the
JAX references are computed while the ranks run.

* ``qwen2_1_5b`` (whole KV heads on each rank), ``recurrentgemma_9b``
  (one KV head: k and v gathered, a sequence-sharded cache; the RG-LRU's
  channels), ``rwkv6_1_6b`` (its heads) and ``olmoe_1b_7b`` (8 experts
  over model 2, expert-parallel) smoke configs;
* the prefill logits and 4 greedy decode steps (``jit_serve_steps``)
  against the JAX forward over the prompt and the tokens fed;
* one train step with ZeRO on and off: the loss, the gathered gradients
  and the new parameters against ``value_and_grad`` of JAX's ``loss_fn``
  on each data shard, averaged over the shards, then JAX's
  ``adamw_update`` (for olmoe what JAX's ``pmean`` over data computes);
* the expert-parallel MoE alone against JAX's ``_moe_apply_dense`` on
  each data shard, on both routes, and the dense MoE (experts the model
  axis does not divide) against it on the whole batch, as GSPMD runs it;
* a checkpoint written by this process restored onto the mesh and
  written back from it through the trainer's path
  (``CheckpointManager.restore_latest``/``maybe_save`` with
  ``shardings=``, which reach ``restore_checkpoint(shardings=)``), and
  restored here.

The pytest process never joins a process group.
"""
import concurrent.futures
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_backbone_ranks as R
from repro.configs import get_smoke as jget_smoke
from repro.models import backbone as JB
from repro.models import layers as JL
from repro.models.config import MoEConfig as JMoEConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.distributed import sharding as TS
from repro_torch.distributed import steps as TST
from repro_torch.launch import mesh as tmesh
from repro_torch.models import backbone as TB

CONFIGS = ["qwen2_1_5b", "recurrentgemma_9b", "rwkv6_1_6b", "olmoe_1b_7b"]
BSZ, PROMPT, GEN, TRAIN_SEQ = 4, 8, 4, 8
OPTS = dict(lr=1e-3, warmup=0, total_steps=10)
MOE = dict(n_experts=8, top_k=2, d_expert=16, capacity_factor=4.0,
           group_size=8)
MOE_DENSE = dict(MOE, n_experts=5)      # model 2 does not divide 5


def tol_of(name: str) -> float:
    return 1e-4 if name.startswith("rwkv") else 1e-5


def _f32_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
                        tree)


def _moe_inputs(e: int):
    r = np.random.default_rng(3)
    d, f = 32, MOE["d_expert"]
    p = {"router": (r.standard_normal((d, e)) / np.sqrt(d)),
         "wg": r.standard_normal((e, d, f)) / np.sqrt(d),
         "wu": r.standard_normal((e, d, f)) / np.sqrt(d),
         "wd": r.standard_normal((e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((BSZ, 8, d)).astype(np.float32)
    w = r.standard_normal((BSZ, 8, d)).astype(np.float32)
    return p, x, w


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other backbone files pin it: many small
    ops under several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(name: str):
    """A seeded train state in the JAX tree's nesting, numpy leaves."""
    cfg = get_smoke(name)
    state = TST.init_train_state(cfg, TST.StepOptions(**OPTS),
                                 torch.Generator().manual_seed(0), "cpu")
    return TB.tree_map(lambda x: x.numpy(), state)


def _jax_grads(states, batches):
    """Per config: JAX's loss and gradients, the mean of
    ``value_and_grad(loss_fn)`` over the two data shards."""
    out = {}
    for name in CONFIGS:
        jc = jget_smoke(name)
        params = jax.tree.map(jnp.asarray, states[name]["params"])
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: JB.loss_fn(jc, p, b)[0]))
        losses, grads = [], []
        for d in range(2):
            shard = {k: jnp.asarray(v[d * 2:(d + 1) * 2])
                     for k, v in batches[name].items()}
            lv, g = vg(params, shard)
            losses.append(float(lv))
            grads.append(g)
        out[name] = {"loss": sum(losses) / 2, "grads": _f32_tree(
            jax.tree.map(lambda a, b: (a + b) / 2, *grads))}
    return out


def _jax_moe(p, x, w, moe_kw, shards: int, aux_weight: float = 1.0):
    """The output, aux loss and gradients of ``sum(out · w) + aux_weight ·
    aux`` from JAX's ``_moe_apply_dense`` on each of ``shards`` row
    blocks."""
    mcfg = JMoEConfig(**moe_kw)

    def loss(p_, x_, w_):
        y, aux = JL._moe_apply_dense(p_, x_, mcfg)
        return (y * w_).sum() + aux_weight * aux, (y, aux)

    vg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    per, n = [], BSZ // shards
    for d in range(shards):
        (_, (y, aux)), (gp, gx) = vg(
            {k: jnp.asarray(v) for k, v in p.items()},
            jnp.asarray(x[d * n:(d + 1) * n]), jnp.asarray(w[d * n:(d + 1) * n]))
        per.append({"y": np.asarray(y), "aux": float(aux),
                    "gx": np.asarray(gx), "gp": _f32_tree(gp)})
    return per


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The states and batches, the one (2, 2) job, a checkpoint this
    process wrote for it, and the JAX references computed meanwhile."""
    states, prompts, batches = {}, {}, {}
    r = np.random.default_rng(0)
    for name in CONFIGS:
        states[name] = _state(name)
        prompts[name] = r.integers(0, get_smoke(name).vocab,
                                   (BSZ, PROMPT)).astype(np.int32)
        batches[name] = SyntheticTokenDataset(DataConfig(
            seed=0, vocab=get_smoke(name).vocab, seq_len=TRAIN_SEQ,
            global_batch=BSZ)).batch(0)
    tmp = tmp_path_factory.mktemp("mesh_backbone")
    src, dst = str(tmp / "one_process"), str(tmp / "from_mesh")
    ckpt_name = "recurrentgemma_9b"
    save_checkpoint(src, 3, train_state_from_numpy(
        get_smoke(ckpt_name), states[ckpt_name], "cpu"))
    moe = {"ep": (*_moe_inputs(MOE["n_experts"]), MOE),
           "dense": (*_moe_inputs(MOE_DENSE["n_experts"]), MOE_DENSE)}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            tmesh.run_on_mesh, R.job, 2, 2, device="cpu",
            dist_backend="gloo", timeout_s=480,
            args=({n: (states[n], prompts[n], GEN) for n in CONFIGS},
                  {n: (states[n], batches[n], OPTS) for n in CONFIGS},
                  moe, (ckpt_name, {"zero": True, **OPTS}, src, dst)))
        grads = _jax_grads(states, batches)
        moe_ref = {"ep": _jax_moe(*moe["ep"], shards=2),
                   # each data rank adds the whole batch's aux to its
                   # loss, so the ranks' gradients sum to those of
                   # sum(out · w) + 2 · aux
                   "dense": _jax_moe(*moe["dense"], shards=1,
                                     aux_weight=2.0)[0]}
        ranks = ranks.result()
    return {"ranks": ranks, "states": states, "prompts": prompts,
            "batches": batches, "moe": moe, "ckpt": (ckpt_name, src, dst),
            "jax_grads": grads, "jax_moe": moe_ref}


def _rows_of(rank, x):
    d = rank["coords"]["data"]
    n = x.shape[0] // 2
    return x[d * n:(d + 1) * n]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_sharded_prefill_and_decode_match_jax(job, name):
    """Every rank's rows: the prefill logits, then each greedy step's
    logits against the JAX forward over the prompt and the tokens fed,
    and each token its argmax; both model ranks of a data shard alike."""
    jc = jget_smoke(name)
    params = jax.tree.map(jnp.asarray, job["states"][name]["params"])
    ranks = job["ranks"]
    toks = np.zeros((BSZ, GEN + 1), np.int32)
    for rank in ranks:
        d = rank["coords"]["data"]
        toks[d * 2:(d + 1) * 2] = rank["serve"][name]["tokens"]
    fed = np.concatenate([job["prompts"][name], toks[:, :GEN]], 1)
    logits = np.asarray(jax.jit(lambda p, t: JB.forward(
        jc, p, {"tokens": t})[0])(params, jnp.asarray(fed)))
    tol = tol_of(name)
    for rank in ranks:
        got = rank["serve"][name]
        want = _rows_of(rank, logits)
        assert rel(got["prefill"], want[:, :PROMPT]) <= tol
        steps = want[:, PROMPT - 1:]
        for j in range(GEN + 1):
            assert rel(got["steps"][:, j], steps[:, j]) <= tol, (name, j)
        np.testing.assert_array_equal(got["tokens"], steps.argmax(-1))
    for a in ranks:
        for b in ranks:
            if a["coords"]["data"] == b["coords"]["data"]:
                np.testing.assert_array_equal(a["serve"][name]["steps"],
                                              b["serve"][name]["steps"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero", ["zero", "no_zero"])
@pytest.mark.parametrize("name", CONFIGS)
def test_sharded_train_step_matches_jax(job, name, zero):
    """The loss (every rank) and each gathered gradient leaf within the
    limit of the reference's scale; the new parameters and moments within
    the limit of each leaf's scale of JAX's ``adamw_update`` at step 0 on
    the gathered gradients (on the gradients themselves, AdamW's first
    update m̂/(√v̂ + eps) is sign(g)·lr wherever |g| ≫ eps, so an element
    near eps turns a gradient's last bits into its whole update), and the
    clipping norm JAX computes from them."""
    ref, tol = job["jax_grads"][name], tol_of(name)
    for rank in job["ranks"]:
        got = rank["train"][name][zero]
        assert abs(got["loss"] - ref["loss"]) <= tol * abs(ref["loss"])
        assert abs(got["metrics"]["loss"] - ref["loss"]) <= \
            tol * abs(ref["loss"])
    got = job["ranks"][0]["train"][name][zero]
    grads = dict(TB.tree_leaves(ref["grads"]))
    for path, g in TB.tree_leaves(got["grads"]):
        assert rel(g, grads[path]) <= tol, path
    state = jax.tree.map(jnp.asarray, job["states"][name])
    lr = jcosine(state["step"], peak_lr=OPTS["lr"], warmup=0,
                 total=OPTS["total_steps"])
    new_p, new_opt, om = jax.jit(lambda p, g, o, lr: jadamw_update(
        p, g, o, JAdamWConfig(lr=OPTS["lr"]), lr))(
        state["params"], jax.tree.map(jnp.asarray, got["grads"]),
        state["opt"], lr)
    for rank in job["ranks"]:
        gn = rank["train"][name][zero]["metrics"]["grad_norm"]
        assert abs(gn - float(om["grad_norm"])) <= tol * float(
            om["grad_norm"])
    want = dict(TB.tree_leaves(_f32_tree({"params": new_p,
                                          "opt": new_opt})))
    for path, leaf in TB.tree_leaves(got["new"]):
        if path[-1] == "step":
            assert int(leaf) == 1
            continue
        assert rel(leaf, want[path]) <= 1e-5, path


# ---------------------------------------------------------------------------
# the expert-parallel MoE alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_expert_parallel_moe_matches_dense_per_data_shard(job, route):
    """This rank's rows of the output within 1e-5 of the scale, the aux
    loss within 1e-6 of the shards' mean, and the gradients of ``sum(out ·
    w) + aux`` (x's rows, the router's, every expert's) within 1e-5 of the
    scale of each data shard's own from JAX's ``_moe_apply_dense``."""
    per = job["jax_moe"]["ep"]
    aux_mean = (per[0]["aux"] + per[1]["aux"]) / 2
    for rank in job["ranks"]:
        got = rank["moe"]["ep"][route]
        ref = per[rank["coords"]["data"]]
        assert rel(got["y"], ref["y"]) <= 1e-5
        assert abs(got["aux"] - aux_mean) <= 1e-6 * abs(aux_mean)
        assert rel(got["gx"], ref["gx"]) <= 1e-5
        for k, g in got["grads"].items():
            assert rel(g, ref["gp"][k]) <= 1e-5, k


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_dense_moe_on_a_data_sharded_mesh_matches_the_whole_batch(job,
                                                                  route):
    """Experts the model axis does not divide run dense on every rank, as
    GSPMD runs JAX's dense MoE: each rank's output rows, the balance loss
    and x's gradient rows those of the whole batch's, and the router's
    and experts' gradients summed over the data ranks, within 1e-5 of the
    scale (the aux loss 1e-6)."""
    ref = job["jax_moe"]["dense"]
    summed = {}
    for rank in job["ranks"]:
        got = rank["moe"]["dense"][route]
        assert rel(got["y"], _rows_of(rank, ref["y"])) <= 1e-5
        assert abs(got["aux"] - ref["aux"]) <= 1e-6 * abs(ref["aux"])
        assert rel(got["gx"], _rows_of(rank, ref["gx"])) <= 1e-5
        if rank["coords"]["model"] == 0:
            for k, g in got["grads"].items():
                summed[k] = summed.get(k, 0) + g
    for k, g in summed.items():
        assert rel(g, ref["gp"][k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# a checkpoint across the mesh
# ---------------------------------------------------------------------------

def test_checkpoint_restores_onto_the_mesh_and_back(job):
    """The one-process checkpoint restored onto the (2, 2) ranks
    (``shardings=``) and gathered equals what was written, and the
    checkpoint the mesh wrote restores here to the same arrays."""
    name, src, dst = job["ckpt"]
    cfg = get_smoke(name)
    written = dict(TB.tree_leaves(job["states"][name]))
    gathered = job["ranks"][0]["checkpoint"]
    assert all(r["checkpoint"] is None for r in job["ranks"][1:])
    for path, leaf in TB.tree_leaves(gathered):
        np.testing.assert_array_equal(leaf, written[path])
    shapes = TST.train_state_shapes(cfg, TST.StepOptions(**OPTS))
    back = restore_checkpoint(dst, TB.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype), shapes))
    for path, leaf in TB.tree_leaves(back):
        np.testing.assert_array_equal(leaf.float().numpy(), written[path])


def test_steps_on_an_abstract_mesh_name_the_process_groups():
    """A sharded step runs on ranks: an abstract mesh of several devices
    raises, naming what it lacks."""
    cfg = get_smoke("qwen2_1_5b")
    for make in (TST.make_prefill_step, TST.make_decode_step):
        with pytest.raises(ValueError, match="process groups"):
            make(TS.AbstractMesh((2, 2)), cfg)
    with pytest.raises(ValueError, match="process groups"):
        TST.make_train_step(TS.AbstractMesh((2, 1)), cfg, TST.StepOptions())

"""The port's sharded serving on the CPU.

* **Decisions** (in process): ``repro_torch.distributed.sharding.
  shard_graph`` against JAX's ``shard_graph`` on an ``AbstractMesh`` for
  the full, prefill and decode programs at meshes (2, 2), (1, 2) and
  (2, 1): every node's local shape, RESHAPE target, LINEAR out_features and
  ``psum_axes``, and the input, output and parameter specs, identical; the
  ``ShardingError`` cases raise in both.
* **Numerics and serving** (4 spawned ranks, gloo): one module-scoped job
  (``launch.mesh.run_on_mesh``, 120 s limit) runs the programs on a (2, 2)
  mesh, a cold and a strict mesh server; the tests hold its results to the
  port's single-device compile and server and to the JAX package's
  single-device output on the same weights (1e-5).
* **Per-shard autotune keys**: the mesh tag keeps per-shard and global
  entries apart, in both directions.

The pytest process never joins a process group: every ``torch.distributed``
call runs in a rank that ``run_on_mesh`` spawned, joined and reaped.
"""
import dataclasses
import multiprocessing
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
from _hypo import hypothesis, st
from jax.sharding import AbstractMesh as JaxAbstractMesh
from repro.core import ir as jir
from repro.distributed import sharding as jshd
from repro.frontends import extract as jext
from repro.frontends import nn as jnn
from repro.frontends.optimize import compile_graph as jcompile
from repro.frontends.optimize import optimize as joptimize
from repro.launch import serve as jserve
from repro_torch.backends import get_backend
from repro_torch.core import autotune as TAT
from repro_torch.core import ir as tir
from repro_torch.core import passes
from repro_torch.distributed import sharding as tshd
from repro_torch.frontends import extract as text
from repro_torch.frontends.extract import extract_decode, extract_prefill
from repro_torch.frontends.offload import NoDeviceError
from repro_torch.frontends.optimize import compile_graph, optimize
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.runtime import packed

D, H, KV, LAYERS, VOCAB = 32, 2, 2, 1, 64
DIMS = (D, H, KV, LAYERS, VOCAB)
CFG_KW = dict(d_model=D, n_heads=H, n_layers=LAYERS, vocab=VOCAB,
              max_seq=32, max_batch=4, slots=4)
GEN = 5


def _weights(seed: int = 0):
    jm = jnn.Sequential(*[jnn.transformer_block(D, H, n_kv_heads=KV)
                          for _ in range(LAYERS)], jnn.Linear(D, VOCAB))
    rng = np.random.default_rng(seed)
    sd = {k: (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
          for k, v in jm.named_parameters().items()}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    return jm, sd


def _inputs(tm):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    xd = rng.standard_normal((2, 1, D)).astype(np.float32)
    lens = np.array([5, 9], np.int32)
    g = extract_decode(tm, 2, 16, D)
    caches = [(rng.standard_normal(n.spec.shape) * 0.5).astype(np.float32)
              for n in g.inputs[2:]]
    return x, xd, lens, caches


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, VOCAB, int(rng.integers(3, 14)), dtype=np.int32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def mesh_job():
    """The one (2, 2) job: four spawned ranks, every case's result."""
    jm, sd = _weights()
    tm = R.lm(sd, *DIMS)
    x, xd, lens, caches = _inputs(tm)
    results = tmesh.run_on_mesh(
        R.job, 2, 2, device="cpu", dist_backend="gloo", timeout_s=120,
        args=(sd, DIMS, (x, xd, lens, caches), (CFG_KW, _prompts(), GEN)))
    return {"results": results, "jm": jm, "tm": tm,
            "inputs": (x, xd, lens, caches)}


# ---------------------------------------------------------------------------
# decisions: the port's shard_graph against JAX's, in process
# ---------------------------------------------------------------------------

def _programs(kind, jm, tm):
    if kind == "full":
        return jext.extract(jm, (4, 8, D)), text.extract(tm, (4, 8, D))
    if kind == "prefill":
        return (jext.extract_prefill(jm, (4, 8, D)),
                text.extract_prefill(tm, (4, 8, D)))
    return (jext.extract_decode(jm, 4, 16, D),
            text.extract_decode(tm, 4, 16, D))


def _decisions(g):
    nodes = [(n.op.value, tuple(n.spec.shape),
              tuple(n.attrs.get("psum_axes", ())),
              tuple(n.attrs["shape"]) if "shape" in n.attrs else None,
              n.attrs.get("out_features")) for n in g.topo()]
    return {"nodes": nodes,
            "inputs": [tuple(s) for s in g.input_specs],
            "outputs": [tuple(s) for s in g.output_specs],
            "params": {k: tuple(v) for k, v in g.param_specs.items()}}


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("kind", ["full", "prefill", "decode"])
def test_shard_graph_decisions_equal_jax(kind, mesh):
    jm, sd = _weights()
    tm = R.lm(sd, *DIMS)
    jg, tg = _programs(kind, jm, tm)
    jg = jshd.shard_graph(jg, JaxAbstractMesh(mesh, ("data", "model")))
    tg = tshd.shard_graph(tg, tshd.AbstractMesh(mesh))
    assert _decisions(tg) == _decisions(jg)
    psums = [n for n in tg.topo() if n.attrs.get("psum_axes")]
    # the o-projection and the MLP's down product are row-parallel
    assert len(psums) == (2 if mesh[1] > 1 else 1) * LAYERS
    assert all(n.attrs["psum_axes"] == ("model",) for n in psums)


def test_heads_not_divisible_replicate_attention_as_jax_does():
    """3 heads on a model axis of 2: head-parallel attention is infeasible,
    so q/k/v stay whole on every rank (the MLP still shards), in both."""
    jcfg = jserve.ServeConfig(d_model=48, n_heads=3, n_layers=1, vocab=64,
                              max_seq=32)
    tcfg = tserve.ServeConfig(d_model=48, n_heads=3, n_layers=1, vocab=64,
                              max_seq=32)
    jg = jext.extract_decode(jserve.build_lm(jcfg), 2, 16, 48)
    tg = text.extract_decode(tserve.build_lm(tcfg, device="meta"), 2, 16, 48)
    jg = jshd.shard_graph(jg, JaxAbstractMesh((1, 2), ("data", "model")))
    tg = tshd.shard_graph(tg, tshd.AbstractMesh((1, 2)))
    assert _decisions(tg) == _decisions(jg)
    att = tg.nodes_of(tir.OpKind.DECODE_ATTENTION)[0]
    assert att.spec.shape[2] == 3                      # all heads local
    assert [s[2] for s in tg.input_specs[2:]] == [None, None]  # caches


def _norm_graph(ir):
    """A batch-sharded dim transposed into a norm's feature dim."""
    x = ir.input_node((4, 8), name="input")
    t = ir.Node(ir.OpKind.TRANSPOSE, [x], ir.TensorSpec((8, 4), "float32"),
                attrs={"perm": (1, 0)})
    g_, b_ = ir.param_node((4,), name="g"), ir.param_node((4,), name="b")
    ln = ir.Node(ir.OpKind.LAYERNORM, [t, g_, b_],
                 ir.TensorSpec((8, 4), "float32"), attrs={"eps": 1e-5})
    return ir.Graph([x], [ln], {"g": g_, "b": b_})


def _head_graph(ir):
    """A decode step whose cache is head-sharded (2 KV heads on a model
    axis of 2) while its query is an input with whole heads."""
    f32 = "float32"
    q = ir.input_node((2, 1, 2, 8), name="q")
    kc = ir.input_node((2, 16, 2, 8), name="l0.k_cache")
    vc = ir.input_node((2, 16, 2, 8), name="l0.v_cache")
    kn = ir.input_node((2, 1, 2, 8), name="k_new")
    vn = ir.input_node((2, 1, 2, 8), name="v_new")
    lens = ir.input_node((2,), "int32", name="lens")
    att = ir.Node(ir.OpKind.DECODE_ATTENTION, [q, kc, vc, kn, vn, lens],
                  ir.TensorSpec((2, 1, 2, 8), f32))
    return ir.Graph([q, kc, vc, kn, vn, lens], [att], {})


@pytest.mark.parametrize("build,match", [(_norm_graph, "normalization"),
                                         (_head_graph, "head sharding")])
def test_sharding_errors_raise_in_both_packages(build, match):
    with pytest.raises(jshd.ShardingError, match=match):
        jshd.shard_graph(build(jir),
                         JaxAbstractMesh((2, 2), ("data", "model")))
    with pytest.raises(tshd.ShardingError, match=match):
        tshd.shard_graph(build(tir), tshd.AbstractMesh((2, 2)))


def test_partition_spec_canonicalizes_as_jax():
    assert tshd.P(("data",), None, "model") == ("data", None, "model")
    assert tshd.P(("pod", "data")) == (("pod", "data"),)
    assert tshd.P(None, None) != tshd.P()


def test_full_width_shards_elect_the_kernels():
    """Two blocks of the chip's serve at full width (d 1536, 12/2 heads,
    vocab 151936) on a (2, 2) mesh, decided on the meta device: every
    LINEAR, MATMUL, ATTENTION, DECODE_ATTENTION and FUSED node at its
    per-shard shape elects a hand-written kernel."""
    cfg = tserve.ServeConfig(d_model=1536, n_heads=12, n_layers=2,
                             vocab=151936, max_seq=256)
    lm = tserve.build_lm(cfg, n_kv_heads=2, device="meta")
    bk = tshd.mesh_backend(get_backend("h100"), tshd.AbstractMesh((2, 2)))
    shapes = set()
    for g in (extract_prefill(lm, (4, 128, 1536)),
              extract_decode(lm, 4, 128, 1536)):
        g = passes.run_pipeline(tshd.shard_graph(
            g, tshd.AbstractMesh((2, 2))), bk)
        for n in g.topo():
            if n.op.value in ("linear", "matmul", "attention",
                              "decode_attention", "fused"):
                assert (n.impl or "").startswith("cuda."), (n, n.impl)
                shapes.add((n.op.value, tuple(n.spec.shape)))
    # heads 6 and KV heads 1 a shard; q 768 and k/v 128 features; the
    # vocab-parallel head 75968
    assert ("decode_attention", (2, 1, 6, 128)) in shapes
    assert ("matmul", (2, 1, 768)) in shapes
    assert ("matmul", (2, 1, 128)) in shapes
    assert ("linear", (2, 1, 75968)) in shapes


# ---------------------------------------------------------------------------
# numerics and serving on four ranks
# ---------------------------------------------------------------------------

def _single_device(tm, x, xd, lens, caches):
    tx = torch.from_numpy(x)
    return {
        "full": [optimize(tm, x.shape, device="cpu")(tx).numpy()],
        "prefill": [o.numpy() for o in compile_graph(
            tm, extract_prefill(tm, x.shape), "h100", device="cpu")(tx)],
        "decode": [o.numpy() for o in compile_graph(
            tm, extract_decode(tm, 2, 16, D), "h100", device="cpu")(
                xd, lens, *caches)]}


def _jax(jm, x, xd, lens, caches):
    return {
        "full": [np.asarray(joptimize(jm, x.shape)(x))],
        "prefill": [np.asarray(o) for o in jcompile(
            jm, jext.extract_prefill(jm, x.shape), "xla")(x)],
        "decode": [np.asarray(o) for o in jcompile(
            jm, jext.extract_decode(jm, 2, 16, D), "xla")(
                xd, lens, *caches)]}


@pytest.mark.parametrize("kind", ["full", "prefill", "decode"])
def test_mesh_programs_equal_single_device_compile(mesh_job, kind):
    ref = _single_device(mesh_job["tm"], *mesh_job["inputs"])[kind]
    for r in mesh_job["results"]:
        got = r["programs"][kind]
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["full", "prefill", "decode"])
def test_mesh_programs_equal_jax_single_device(mesh_job, kind):
    ref = _jax(mesh_job["jm"], *mesh_job["inputs"])[kind]
    got = mesh_job["results"][0]["programs"][kind]
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_mesh_server_serves_the_single_device_tokens(mesh_job):
    server = tserve.SolServer(tserve.ServeConfig(**CFG_KW),
                              model=mesh_job["tm"], device="cpu")
    reqs = [server.submit(p, GEN) for p in _prompts()]
    server.run()
    server.close()
    for r in mesh_job["results"]:
        cold = r["serve"]["cold"]
        assert cold["tokens"] == [q.generated for q in reqs]
        for a, q in zip(cold["logits"], reqs):
            np.testing.assert_allclose(a, q.last_logits, rtol=0, atol=1e-5)
        s = cold["summary"]
        assert s["mesh"] == [2, 2] and s["dmas"] == s["forwards"]
        # the smallest batch bucket shards the batch over data = 2
        assert all(b >= 2 for _, b, _ in cold["buckets"])


def test_every_rank_holds_the_same_state(mesh_job):
    res = mesh_job["results"]
    assert [r["serve"]["coords"] for r in res] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    for r in res[1:]:
        assert r["serve"]["cold"]["tokens"] == res[0]["serve"]["cold"][
            "tokens"]
        assert r["serve"]["strict"]["tokens"] == res[0]["serve"]["strict"][
            "tokens"]


def test_mesh_strict_provenance_on_per_shard_keys(mesh_job):
    for r in mesh_job["results"]:
        strict = r["serve"]["strict"]
        assert strict["counts"]["nodes"] > 0 and strict["counts"]["impls"] > 0
        assert strict["tokens"] == r["serve"]["cold"]["tokens"]
        for key, m in strict["models"].items():
            assert m["cache_name"] == "h100@data2model2", key
            assert m["violations"] == [], key
            for name, srcs in m["sources"].items():
                assert srcs and set(srcs) <= {"measured"}, (key, name, srcs)
            # per-shard shapes: q/k/v features H·hd / model = 16
            assert 16 in m["matmul_out"], (key, m["matmul_out"])
            assert m["psum"] == 2 * LAYERS
            if key[0] == "decode":
                assert m["decode_batch"] == [key[1] // 2]


def test_mesh_measurements_never_land_on_global_keys(mesh_job):
    for r in mesh_job["results"]:
        strict = r["serve"]["strict"]
        assert strict["global_hits"] == 0
        assert strict["cache_backends"] == ["h100@data2model2"]


def test_export_artifacts_refuses_a_mesh_server(mesh_job):
    for r in mesh_job["results"]:
        assert "export_artifacts" in r["serve"]["export"]


def test_make_debug_mesh_checks_the_world_size(mesh_job):
    for r in mesh_job["results"]:
        assert "needs world size 8" in r["serve"]["too_few"]
    with pytest.raises(RuntimeError, match="world size 4"):
        tmesh.make_debug_mesh(2, 2)
    with pytest.raises(RuntimeError, match="world size 256"):
        tmesh.make_production_mesh()
    one = tmesh.make_debug_mesh(1, 1, device="cpu")
    assert one.shape == {"data": 1, "model": 1} and one.size == 1
    assert packed.replicated(one) == torch.device("cpu")
    # with no device asked for, a one-process mesh stands on the card
    if torch.cuda.is_available():
        card = tmesh.make_debug_mesh(1, 1)
        assert card.device.type == "cuda"
        assert packed.replicated(card) == card.device
    else:
        with pytest.raises(NoDeviceError):
            tmesh.make_debug_mesh(1, 1)


@pytest.mark.parametrize("make", [
    lambda **kw: tmesh.make_debug_mesh(1, 1, **kw),
    lambda **kw: tmesh.Mesh((1, 1), ("data", "model"), **kw),
    lambda **kw: tmesh.Mesh((1,), ("model",), **kw),
], ids=["make_debug_mesh", "Mesh", "Mesh_1d"])
def test_one_process_mesh_resolves_the_card(make):
    """The device of a mesh made with no device is the card; ``device=``
    is honoured, and a card that is not there raises."""
    assert make(device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert make().device == torch.device(
            "cuda", torch.cuda.current_device())
    else:
        with pytest.raises(NoDeviceError, match="device='cpu'"):
            make()
        with pytest.raises(NoDeviceError):
            make(device="cuda")


def test_mesh_collectives(mesh_job):
    for r in mesh_job["results"]:
        c = r["collectives"]
        d, m = c["coords"]["data"], c["coords"]["model"]
        assert c["sum_model"] == [[float(4 * d + 1)] * 3] * 2
        assert c["sum_all"] == [[6.0] * 3] * 2
        assert c["gather_data"] == [[float(m)] * 3] * 2 + [
            [float(2 + m)] * 3] * 2


def test_run_on_mesh_fails_loudly_and_reaps_its_ranks():
    with pytest.raises(RuntimeError, match="(?s)rank 1:.*ValueError"):
        tmesh.run_on_mesh(R.fail_on_rank_1, 2, 1, device="cpu",
                          dist_backend="gloo", timeout_s=60)
    assert not multiprocessing.active_children()


def test_serve_cli_mesh_smoke():
    assert tserve.main(["--smoke", "--device", "cpu", "--mesh", "2,2"]) == 0
    assert not multiprocessing.active_children()


def test_sharded_graph_needs_process_groups_and_no_training():
    """Body rewritten, name kept: a sharded graph now trains on a mesh of
    ranks (``tests/test_torch_mesh_sol_train.py``), so an abstract mesh,
    which has no process groups, is refused for training as it is for
    serving: its row-parallel all-reduces and, for training, its
    column-parallel inputs' backward all-reduces have no ranks to run
    on."""
    _, sd = _weights()
    tm = R.lm(sd, *DIMS)
    am = tshd.AbstractMesh((1, 2))
    with pytest.raises(ValueError, match="process groups"):
        compile_graph(tm, extract_prefill(tm, (2, 8, D)), "h100",
                      device="cpu", mesh=am)
    with pytest.raises(ValueError, match="process groups") as err:
        compile_graph(tm, extract_prefill(tm, (2, 8, D)), "h100",
                      device="cpu", mesh=am, training=True)
    # 4 column-parallel products (q, k, v, up) and 2 row-parallel (o, down)
    # a block, and the vocab-parallel head
    assert f"{2 * LAYERS} row-parallel and {4 * LAYERS + 1} " \
        "column-parallel" in str(err.value)


# ---------------------------------------------------------------------------
# per-shard autotune keys (single process)
# ---------------------------------------------------------------------------

def test_mesh_backend_tags_cache_key():
    bk = get_backend("h100")
    assert bk.cache_name == bk.name
    mk = tshd.mesh_backend(bk, tmesh.make_debug_mesh(1, 1, device="cpu"))
    assert mk.name == bk.name
    assert mk.cache_name == "h100@data1model1"
    assert tshd.mesh_backend(bk, tshd.AbstractMesh((2, 2))).cache_name == \
        "h100@data2model2"


def test_per_shard_keys_never_hit_global_entries():
    bk = get_backend("h100")
    mk = dataclasses.replace(bk, shard_tag="data2model2")
    cache = TAT.AutotuneCache()
    cache.record("linear", (8, 64, 64), "float32", mk.cache_name,
                 "cuda.linear", 5.0)
    cache.record("linear", (8, 64, 64), "float32", bk.cache_name,
                 "ref.linear", 9.0)
    assert set(cache.lookup("linear", (8, 64, 64), "float32",
                            mk.cache_name)) == {"cuda.linear"}
    assert set(cache.lookup("linear", (8, 64, 64), "float32",
                            bk.cache_name)) == {"ref.linear"}
    assert set(cache.lookup("linear", (4, 64, 64), "float32",
                            mk.cache_name)) == {"cuda.linear"}
    assert not cache.lookup("attention", (8, 64, 64), "float32",
                            bk.cache_name)


@hypothesis.given(
    op=st.sampled_from(["linear", "matmul", "attention",
                        "decode_attention"]),
    shape=st.lists(st.integers(1, 1024), min_size=1, max_size=4),
    dtype=st.sampled_from(["float32", "bfloat16"]),
    data=st.integers(1, 16),
    model=st.integers(1, 16),
)
@hypothesis.settings(max_examples=80, deadline=None, derandomize=True)
def test_hypothesis_per_shard_and_global_keys_disjoint(op, shape, dtype,
                                                       data, model):
    """An entry under the mesh-tagged key is invisible to the untagged
    lookup and the reverse, for any op, shape, dtype and mesh."""
    bk = get_backend("h100")
    mk = tshd.mesh_backend(bk, tshd.AbstractMesh((data, model)))
    assert mk.cache_name != bk.cache_name
    shape = tuple(shape)
    cache = TAT.AutotuneCache()
    cache.record(op, shape, dtype, mk.cache_name, "impl.shard", 1.0)
    assert not cache.lookup(op, shape, dtype, bk.cache_name)
    assert not cache.has_bucket(op, shape, dtype, bk.cache_name)
    cache2 = TAT.AutotuneCache()
    cache2.record(op, shape, dtype, bk.cache_name, "impl.global", 1.0)
    assert not cache2.lookup(op, shape, dtype, mk.cache_name)
    assert not cache2.has_bucket(op, shape, dtype, mk.cache_name)


@hypothesis.given(sizes=st.sampled_from([(2, 2), (1, 4), (4, 1), (2, 1)]),
                  rows=st.integers(1, 3), cols=st.integers(1, 3))
@hypothesis.settings(max_examples=30, deadline=None, derandomize=True)
def test_hypothesis_shard_slices_tile_the_tensor(sizes, rows, cols):
    """Every rank's block under a (data, model) spec, laid back in rank
    order, rebuilds the global tensor exactly once."""
    mesh = tshd.AbstractMesh(sizes)
    shape = (rows * sizes[0], cols * sizes[1])
    t = torch.arange(shape[0] * shape[1]).reshape(shape)
    seen = torch.zeros(shape, dtype=torch.int64)
    for d in range(sizes[0]):
        for m in range(sizes[1]):
            sl = tshd.shard_slices(mesh, {"data": d, "model": m}, shape,
                                   tshd.P("data", "model"))
            assert t[sl].shape == (rows, cols)
            seen[sl] += 1
    assert bool((seen == 1).all())

"""The port's measurement and measured election on the CPU, held against
the JAX package: the autotune cache's mechanics, the Tunable protocol and
every kernel family's space (each config covering every element or step
exactly once, on the plan alone), measured-first election (pinning,
clearing, flips, provenance), the doctored-cache decisions of the serving
programs in both packages, the calibration fit (equal to the JAX fit's
coefficients within 1e-9 relative), ``core.measure`` (min and mean,
restored attrs, the unpin on a raise) and the ``autotune`` driver end to
end.  On the CPU every kernel impl runs its plain version, so no test here
asserts which impl wins by timing."""
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from _hypo import hypothesis, st  # real hypothesis, or skip-stubs when absent
import numpy as np
import pytest
import torch

from benchmarks import calibrate as jcalibrate
from repro.backends import get_backend as j_backend
from repro.backends import registry as JR
from repro.core import autotune as JAT
from repro.core import passes as jpasses
from repro.kernels.dfp_fused import program as jprogram
from repro_torch.backends import get_backend
from repro_torch.backends import registry as R
from repro_torch.benchmarks import autotune as drv
from repro_torch.benchmarks import calibrate
from repro_torch.core import autotune, ir, measure, passes
from repro_torch.core.autotune import (AutotuneCache, Tunable, bucket_dim,
                                       bucket_shape)
from repro_torch.core.ir import Graph, Node, OpKind, TensorSpec
from repro_torch.frontends import nn
from repro_torch.frontends.optimize import optimize
from repro_torch.kernels.avgpool import ops as avg_ops
from repro_torch.kernels.decode_attention import kernel as dec_k
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.dfp_fused import kernel as dfp_k
from repro_torch.kernels.dfp_fused import ops as dfp_ops
from repro_torch.kernels.dfp_fused import program as tprogram
from repro_torch.kernels.flash_attention import kernel as fa_k
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.matmul import kernel as mm_k
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.rglru_scan import kernel as rg_k
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rwkv6_scan import kernel as rw_k
from repro_torch.kernels.rwkv6_scan import ops as rw_ops

from test_torch_pipeline import IMPL_MAP, _programs, models

ROOT = Path(__file__).resolve().parents[1]
HW = get_backend("h100").hw


def _chip_smoke():
    """``chip_smoke.py``, loaded from the checkout: it holds the plain
    version every tunable config is held against on the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh_cache():
    """Every test starts and leaves the process with a cold port cache (an
    explicit empty cache: None would re-read SOL_AUTOTUNE_CACHE)."""
    prev = autotune._CACHE
    autotune.set_cache(AutotuneCache())
    yield
    autotune.set_cache(prev)


def _linear_graph(b=2, d_in=16, d_out=32):
    x = ir.input_node((b, d_in), name="x")
    w = ir.param_node((d_out, d_in), name="w")
    lin = Node(OpKind.LINEAR, [x, w], TensorSpec((b, d_out)),
               attrs={"out_features": d_out})
    return Graph([x], [lin], {"w": w}), lin


def _attention_graph(b=1, s=64, h=2, hd=16):
    q, k, v = (ir.input_node((b, s, h, hd), name=nm) for nm in "qkv")
    node = Node(OpKind.ATTENTION, [q, k, v], TensorSpec((b, s, h, hd)),
                attrs={"causal": True})
    return Graph([q, k, v], [node], {}), node


# -- cache mechanics -----------------------------------------------------------

def test_cache_roundtrip(tmp_path):
    path = str(tmp_path / "cache.json")
    c = AutotuneCache()
    c.record("matmul", (256, 256, 256), "float32", "h100", "cuda.matmul",
             12.5, config=(4,), flops=2 * 256 ** 3, nbytes=3 * 256 * 256 * 4,
             mean_us=13.0)
    c.record("matmul", (256, 256, 256), "float32", "h100", "ref.matmul", 20.0)
    c.set_calibration("h100", "matmul",
                      {"s_per_flop": 1e-14, "s_per_byte": 2e-12, "n": 2.0})
    c.save(path)
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    c2 = AutotuneCache.load(path)
    got = c2.lookup("matmul", (256, 256, 256), "float32", "h100")
    assert got["cuda.matmul"].us == 12.5 and got["cuda.matmul"].mean_us == 13.0
    assert got["cuda.matmul"].config == (4,)
    assert got["ref.matmul"].us == 20.0
    assert c2.calibrations() == {("h100", "matmul"): {
        "s_per_flop": 1e-14, "s_per_byte": 2e-12, "n": 2.0}}
    assert c2.to_json() == JAT.AutotuneCache.load(path).to_json()


def test_stale_and_corrupt_files_come_back_empty(tmp_path):
    stale = tmp_path / "old.json"
    stale.write_text(json.dumps({
        "schema": autotune.SCHEMA_VERSION + 1,
        "entries": {"matmul|float32|h100|256x256x256":
                    {"ref.matmul": {"us": 1.0}}}}))
    c = AutotuneCache.load(str(stale))
    assert c.stale and len(c) == 0
    torn = tmp_path / "torn.json"
    torn.write_text('{"schema": 1, "entr')
    c = AutotuneCache.load(str(torn))
    assert len(c) == 0 and not c.stale


def test_record_keeps_best_time_and_entries_are_sorted():
    c = AutotuneCache()
    c.record("matmul", (64, 64, 64), "float32", "h100", "ref.matmul", 9.0)
    c.record("matmul", (64, 64, 64), "float32", "h100", "ref.matmul", 5.0,
             config=(2,))
    c.record("matmul", (64, 64, 64), "float32", "h100", "ref.matmul", 7.0)
    c.record("linear", (8, 8, 8), "float32", "h100", "cuda.linear", 3.0)
    m = c.lookup("matmul", (64, 64, 64), "float32", "h100")["ref.matmul"]
    assert m.us == 5.0 and m.config == (2,)
    keys = [(k, b, nm) for k, b, nm, _ in c.entries()]
    assert keys == sorted(keys) and len(keys) == len(c) == 2


def test_lookup_with_confidence_says_where_the_hit_came_from():
    c = AutotuneCache()
    c.record("matmul", (256, 256, 256), "float32", "h100", "ref.matmul", 3.0)
    c.record("matmul", (2048, 2048, 2048), "float32", "h100", "ref.matmul",
             90.0)
    hit, conf = c.lookup_with_confidence("matmul", (250, 260, 255),
                                         "float32", "h100")
    assert conf == "exact" and hit["ref.matmul"].us == 3.0
    hit, conf = c.lookup_with_confidence("matmul", (4096, 4096, 4096),
                                         "float32", "h100")
    assert conf == "nearest" and hit["ref.matmul"].us == 90.0
    assert c.lookup_with_confidence("matmul", (8, 8), "float32",
                                    "h100") == ({}, "")
    assert c.lookup_with_confidence("matmul", None, "float32",
                                    "h100") == ({}, "")
    assert bucket_shape((100, 70, 36)) == (128, 64, 32)
    jc = JAT.AutotuneCache()
    for (op, dtype, backend), b, nm, m in c.entries():
        jc.record(op, b, dtype, backend, nm, m.us)
    for probe in ((250, 260, 255), (4096, 4096, 4096), (8, 8)):
        got, conf = c.lookup_with_confidence("matmul", probe, "float32",
                                             "h100")
        jgot, jconf = jc.lookup_with_confidence("matmul", probe, "float32",
                                                "h100")
        assert conf == jconf
        assert {k: v.us for k, v in got.items()} == \
            {k: v.us for k, v in jgot.items()}


def test_load_cache_installs_the_file(tmp_path):
    path = str(tmp_path / "c.json")
    c = AutotuneCache()
    c.record("linear", (2, 16, 32), "float32", "h100", "ref.linear", 1.0)
    c.save(path)
    installed = autotune.load_cache(path)
    assert autotune.get_cache() is installed and len(installed) == 1


@hypothesis.settings(max_examples=100, deadline=None)
@hypothesis.given(a=st.integers(1, 1 << 20), b=st.integers(1, 1 << 20))
def test_bucket_dim_monotone_pow2_and_equal_to_jax(a, b):
    lo, hi = sorted((a, b))
    assert bucket_dim(lo) <= bucket_dim(hi)
    for d in (a, b):
        bd = bucket_dim(d)
        assert bd >= 1 and (bd & (bd - 1)) == 0
        assert bd == JAT.bucket_dim(d)
        assert autotune.ceil_pow2(d) == JAT.ceil_pow2(d)


@hypothesis.settings(max_examples=50, deadline=None)
@hypothesis.given(
    shape=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
    probe=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
    us=st.floats(1e-3, 1e6, allow_nan=False, allow_infinity=False))
def test_lookup_never_crosses_ops_dtypes_backends(shape, probe, us):
    c = AutotuneCache()
    c.record("matmul", tuple(shape), "float32", "h100", "ref.matmul", us)
    assert c.lookup("linear", tuple(probe), "float32", "h100") == {}
    assert c.lookup("matmul", tuple(probe), "bfloat16", "h100") == {}
    assert c.lookup("matmul", tuple(probe), "float32", "torch_ref") == {}
    got = c.lookup("matmul", tuple(probe), "float32", "h100")
    if len(probe) == len(shape):
        assert got["ref.matmul"].us == us
    else:
        assert got == {}


_ENTRY = st.tuples(
    st.sampled_from(["matmul", "linear", "attention", "fused"]),
    st.lists(st.integers(1, 2048), min_size=1, max_size=4),
    st.sampled_from(["float32", "bfloat16"]),
    st.sampled_from(["h100", "torch_ref"]),
    st.sampled_from(["ref.x", "cuda.y"]),
    st.floats(1e-3, 1e6, allow_nan=False, allow_infinity=False),
    st.one_of(st.none(), st.lists(st.integers(1, 512), min_size=1,
                                  max_size=3)))


@hypothesis.settings(max_examples=25, deadline=None,
                     suppress_health_check=[
                         hypothesis.HealthCheck.function_scoped_fixture])
@hypothesis.given(entries=st.lists(_ENTRY, max_size=12))
def test_cache_save_load_roundtrip_idempotent(tmp_path, entries):
    c = AutotuneCache()
    for op, shape, dtype, backend, impl, us, cfg in entries:
        c.record(op, tuple(shape), dtype, backend, impl, us,
                 config=tuple(cfg) if cfg else None,
                 flops=us * 2, nbytes=us * 3, mean_us=us * 1.5)
    p1 = str(tmp_path / "c1.json")
    c.save(p1)
    c2 = AutotuneCache.load(p1)
    assert c2.to_json() == c.to_json() and len(c2) == len(c)
    p2 = str(tmp_path / "c2.json")
    c2.save(p2)
    assert AutotuneCache.load(p2).to_json() == c2.to_json()


# -- the Tunable protocol --------------------------------------------------------

# one node per kernel family at full width, where each space has a choice
FAMILY_NODES = {
    "cuda.matmul": ("matmul", (512, 1536, 1536)),
    "cuda.linear": ("linear", (512, 1536, 6144)),
    "cuda.flash_attention": ("attention", (4, 128, 12, 2, 128)),
    "cuda.decode_attention": ("decode_attention", (4, 128, 12, 2, 128)),
    "cuda.dfp_fused": ("fused", (512, 6144)),
    "cuda.rglru_scan": ("rglru_scan", (4, 512, 4096)),
    "cuda.rwkv6_scan": ("rwkv6_scan", (4, 512, 32, 64)),
    "cuda.avgpool": ("avgpool", (64, 32, 222, 222)),
}


@pytest.mark.parametrize("impl_name", sorted(FAMILY_NODES))
def test_registry_declares_a_tunable_for_every_kernel_family(impl_name):
    R._load_entry_points()
    impl = R.get_impl(impl_name)
    assert impl is not None and impl.tunable is not None
    for dtype in ("float32", "bfloat16"):
        node = drv._node(*FAMILY_NODES[impl_name], dtype)
        assert impl.admissible(get_backend("h100"), node)
        space = impl.tunable.tune_space(node, HW)
        assert len(space) >= 2, (impl_name, dtype, space)
        assert len(set(space)) == len(space)
        impl.tunable.bind_config(node, space[0])
        assert tuple(node.attrs[impl.tunable.attr]) == tuple(space[0])
        impl.tunable.bind_config(node, None)
        assert impl.tunable.attr not in node.attrs
    attrs = {R.get_impl(n).tunable.attr for n in FAMILY_NODES}
    assert len(attrs) == 7          # one key a family (the matmul shares)


@pytest.mark.parametrize("win", [(4,), (64, 2), (8, 3, 16)])
def test_refine_space_equals_jax(win):
    space = [(1,) * len(win), tuple(2 * d for d in win)]
    t = Tunable("a", lambda n, hw: space)
    j = JAT.Tunable("a", lambda n, hw: space)
    assert t.refine_space(None, HW, win) == j.refine_space(None, HW, win)
    assert win not in t.refine_space(None, HW, win)
    legal = [tuple(d + 1 for d in win)]
    t2 = Tunable("a", lambda n, hw: [], refine=lambda n, hw, c: legal)
    assert t2.refine_space(None, HW, win) == legal


# -- every config covers every element or step exactly once (plans) ----------

def _cover(n: int, starts_ends) -> np.ndarray:
    count = np.zeros(n, np.int64)
    for lo, hi in starts_ends:
        count[lo:min(hi, n)] += 1
    return count


@pytest.mark.parametrize("op,shape", [
    ("linear", (4, 1536, 151936)), ("linear", (512, 6144, 1536)),
    ("linear", (4, 6144, 1536)), ("matmul", (512, 1536, 256)),
    ("matmul", (4, 1536, 1536)), ("matmul", (2048, 4, 2048)),
    ("matmul", (2048, 2048, 4)), ("linear", (37, 1000, 70)),
    ("matmul", (4, 12288, 1024))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_configs_cover_k_and_the_output_once(op, shape, dtype):
    node = drv._node(op, shape, dtype)
    m, k, n = shape
    default = mm_ops.node_plan(node, HW)
    space = mm_ops.mm_tune_space(node, HW)
    assert (default.splits,) in space
    for (splits,) in space:
        p = mm_ops.node_plan(node, HW, splits)
        assert p.splits == splits and p.kernel == default.kernel
        chunks = [(s * p.k_chunk, (s + 1) * p.k_chunk)
                  for s in range(p.splits)]
        assert (_cover(k, chunks) == 1).all()
        assert (p.splits - 1) * p.k_chunk < k      # no empty split
        if p.kernel == "tensor_core":
            bm, bn, _ = mm_k.TC_TILE
            assert p.k_chunk % (mm_k.TC_BK_16BIT if dtype != "float32"
                                else mm_k.TC_TILE[2]) == 0
            assert p.grid == (-(-m // bm) * -(-n // bn), p.splits)
            least = mm_k.TC_MIN_K_CHUNK
        else:
            kc_max = mm_k.SKINNY_S_FLOATS // p.rows
            assert p.k_chunk <= kc_max and p.grid[1] == p.splits
            least = mm_k.SKINNY_MIN_K_CHUNK[p.big_kmajor]
        if splits not in (1, default.splits):
            assert -(-k // splits) >= least or p.k_chunk >= least


@pytest.mark.parametrize("b,cache,h,kv,hd", [
    (4, 128, 12, 2, 128), (1, 8, 4, 4, 16), (2, 300, 8, 2, 64),
    (4, 256, 12, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_configs_cover_the_cache_once(b, cache, h, kv, hd, dtype):
    node = drv._node("decode_attention", (b, cache, h, kv, hd), dtype)
    rows = dec_k.tile_rows(hd, 4 if dtype == "float32" else 2)
    for (splits,) in dec_ops.decode_tune_space(node, HW):
        p = dec_ops.node_plan(node, HW, splits)
        assert p.splits == splits <= dec_k.MAX_SPLITS
        assert p.chunk % rows == 0 and p.grid == (splits, kv, b)
        assert (_cover(cache, [(s * p.chunk, (s + 1) * p.chunk)
                               for s in range(splits)]) == 1).all()
        assert (splits - 1) * p.chunk < cache


@pytest.mark.parametrize("s,hd", [(128, 128), (1, 16), (65, 64), (300, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_configs_cover_every_query_row_once(s, hd, dtype):
    node = drv._node("attention", (2, s, 4, 2, hd), dtype)
    space = fa_ops.attn_tune_space(node, HW)
    assert space == [(bq,) for bq in fa_k.BLOCK_QS]
    size = 4 if dtype == "float32" else 2
    for (bq,) in space:
        nb = -(-s // bq)            # the source's grid.x
        assert (_cover(s, [(i * bq, (i + 1) * bq) for i in range(nb)])
                == 1).all()
        assert fa_k.flash_smem_bytes(hd, size, bq) <= HW.smem_bytes
    # the space holds only the instances whose shared memory fits a block
    small = types.SimpleNamespace(
        smem_bytes=fa_k.flash_smem_bytes(hd, size, 32))
    assert fa_ops.attn_tune_space(node, small) == [(32,)]


@pytest.mark.parametrize("rows,d", [(512, 6144), (4, 1536), (3, 5),
                                    (65536, 64), (1000, 1536)])
def test_dfp_row_blocks_cover_every_row_once(rows, d):
    node = drv._node("fused", (rows, d))
    space = dfp_ops.dfp_tune_space(node, HW)
    assert space and {g for _, g in space} == {4, 2}
    for br, _grp in space:
        block_r, block_d, warps = dfp_k.block_shape(rows, d, br)
        assert block_r == br and block_d >= d and warps in (4, 8)
        nb = -(-rows // block_r)
        assert (_cover(rows, [(i * block_r, (i + 1) * block_r)
                              for i in range(nb)]) == 1).all()
        assert block_r * block_d <= 4 * dfp_k.BLOCK_ELEMS


def _jax_and_port_programs():
    """The serving programs' DFP groups and the driver's four-op chain,
    encoded by both packages (groups whose vec operands stay bias or norm
    gains, where both encoders agree)."""
    from repro.kernels.dfp_fused.program import encode_program as jenc
    jm, tm = models()
    out = []
    for jg, tg in _programs(jm, tm):
        jg = jpasses.run_pipeline(jg, j_backend("pallas_interpret"))
        tg = passes.run_pipeline(tg, get_backend("h100"))
        for jn, tn in zip(jg.topo(), tg.topo()):
            if tn.op is OpKind.FUSED and tn.impl == "cuda.dfp_fused":
                out.append((jenc(jn, {id(i): i.spec for i in jn.inputs})[0],
                            tprogram.encode_program(
                                tn, {id(i): i.spec for i in tn.inputs})[0]))
    from benchmarks.autotune import _node as j_node
    jn, tn = j_node("fused", (8, 16)), drv._node("fused", (8, 16))
    out.append((jenc(jn, {id(i): i.spec for i in jn.inputs})[0],
                tprogram.encode_program(
                    tn, {id(i): i.spec for i in tn.inputs})[0]))
    return out


def test_split_program_equals_jax_and_places_every_instruction_once():
    progs = _jax_and_port_programs()
    assert len(progs) >= 4
    for jprog, tprog in progs:
        assert tprog.instrs == jprog.instrs
        assert tprogram.split_points(tprog) == jprogram.split_points(jprog)
        for max_len in range(1, len(tprog.instrs) + 1):
            tsegs = tprogram.split_program(tprog, max_len)
            jsegs = jprogram.split_program(jprog, max_len)
            assert [(s.instrs, s.operand_kinds, s.out_reg, sel)
                    for s, sel in tsegs] == \
                [(s.instrs, s.operand_kinds, s.out_reg, sel)
                 for s, sel in jsegs]
            assert sum(len(s.instrs) for s, _ in tsegs) == len(tprog.instrs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dfp_segmented_equals_the_whole_program(dtype):
    """A max_group config runs successive launches (plain versions here);
    each instruction rounds its result to the storage type, so the cut
    values lose nothing and the result is the whole program's, bit for
    bit."""
    from repro_torch.core.executor import TORCH_DTYPES
    tdt = TORCH_DTYPES[dtype]
    g = torch.Generator().manual_seed(0)
    for _jprog, prog in _jax_and_port_programs():
        rows, d = 6, 16
        ops = [torch.randn((rows, d) if k == "full" else (d,), generator=g)
               .to(tdt) for k in prog.operand_kinds]
        whole = dfp_ops.dfp_fused(prog, ops)
        for max_len in range(1, len(prog.instrs)):
            seg = dfp_ops.dfp_fused_segmented(prog, ops, max_len)
            assert torch.equal(seg, whole), (prog.instrs, max_len)


@pytest.mark.parametrize("b,t,d", [(4, 512, 4096), (1, 1, 24), (1, 300, 4100),
                                   (2, 37, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_configs_cover_every_channel_and_step_once(b, t, d, dtype):
    node = drv._node("rglru_scan", (b, t, d), dtype)
    space = rg_ops.rglru_tune_space(node, HW)
    assert {lanes for lanes, _ in space} == set(rg_k.LANES)
    for lanes, chunks in space:
        p = rg_ops.node_plan(node, HW, lanes, chunks)
        assert (p.lanes, p.chunks) == (lanes, chunks)
        assert p.chunks <= rg_k.MAX_CHUNKS and p.chunks % (32 // lanes) == 0
        assert p.warps * (32 // lanes) == p.chunks
        assert (_cover(d, [(c * p.channels, (c + 1) * p.channels)
                           for c in range(p.grid[0])]) == 1).all()
        span = p.chunks * p.chunk
        steps = [(tile * span + c * p.chunk, tile * span + (c + 1) * p.chunk)
                 for tile in range(-(-t // span)) for c in range(p.chunks)]
        assert (_cover(t, steps) == 1).all()
        assert rg_k.static_smem_bytes(lanes) <= HW.smem_bytes


@pytest.mark.parametrize("b,t,h,hd", [(4, 512, 32, 64), (1, 3, 2, 8),
                                      (1, 300, 2, 64), (8, 64, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_configs_cover_every_step_once(b, t, h, hd, dtype):
    node = drv._node("rwkv6_scan", (b, t, h, hd), dtype)
    space = rw_ops.rwkv6_tune_space(node, HW)
    assert (rw_ops.node_plan(node, HW).chunk,) in space
    for (chunk,) in space:
        p = rw_ops.node_plan(node, HW, chunk)
        assert p.chunk == chunk
        assert chunk >= t or (chunk % rw_k.STEP == 0
                              and chunk <= rw_k.MAX_CHUNK)
        assert p.tile % rw_k.STEP == 0 and p.smem <= HW.smem_bytes
        assert p.grid == (p.chunks, h, b)
        assert (_cover(t, [(c * chunk, (c + 1) * chunk)
                           for c in range(p.chunks)]) == 1).all()
        assert (p.chunks - 1) * chunk < max(t, 1)
    # a chunk that is neither all of T nor a legal cut rounds down to one
    assert rw_k.rwkv6_plan(b, 600, h, hd, 4, chunk=20).chunk == rw_k.STEP


@pytest.mark.parametrize("shape", [(64, 32, 222, 222), (64, 64, 109, 109),
                                   (1, 2, 18, 4998), (2, 3, 7, 38)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avgpool_configs_cover_every_output_once(shape, dtype):
    node = drv._node("avgpool", shape, dtype)
    _n, _c, oh, ow = shape
    space = avg_ops.avgpool_tune_space(node, HW)
    assert (avg_ops.node_plan(node).rows,) in space
    for (rows,) in space:
        p = avg_ops.node_plan(node, rows)
        assert p.rows == rows and p.smem <= HW.smem_bytes
        assert (_cover(oh, [(i * p.rows, (i + 1) * p.rows)
                            for i in range(p.bands)]) == 1).all()
        assert (_cover(ow, [(i * p.cols, (i + 1) * p.cols)
                            for i in range(p.tiles)]) == 1).all()
        assert p.groups * p.group_rows >= p.rows
        assert p.tx * p.cols_per_thread >= p.cols



def _planned(impl_name: str, node, cfg):
    """The config the kernel runs with ``cfg`` pinned on ``node``, read
    off its plan, which must be legal at the node's shapes (raises
    otherwise)."""
    if impl_name in ("cuda.matmul", "cuda.linear"):
        p = mm_ops.node_plan(node, HW, cfg[0])
        assert (p.splits - 1) * p.k_chunk < autotune.node_shape(node)[1]
        return (p.splits,)
    if impl_name == "cuda.decode_attention":
        p = dec_ops.node_plan(node, HW, cfg[0])
        itemsize = 4 if node.spec.dtype == "float32" else 2
        assert p.splits <= dec_k.MAX_SPLITS
        assert p.chunk % dec_k.tile_rows(node.spec.shape[-1], itemsize) == 0
        return (p.splits,)
    if impl_name == "cuda.flash_attention":
        assert cfg in fa_ops.attn_tune_space(node, HW)
        return tuple(cfg)
    if impl_name == "cuda.dfp_fused":
        rows, d = int(np.prod(node.spec.shape[:-1])), node.spec.shape[-1]
        br, bd, _ = dfp_k.block_shape(rows, d, cfg[0])
        assert 4 * br * bd <= HW.smem_bytes
        prog, _ = tprogram.encode_program(
            node, {id(i): i.spec for i in node.inputs})
        segs = dfp_ops.segments(prog, cfg[1])
        assert all("full" in seg.operand_kinds for seg, _ in segs)
        return (br, cfg[1])
    if impl_name == "cuda.rglru_scan":
        p = rg_ops.node_plan(node, HW, *cfg)
        assert p.chunks <= rg_k.MAX_CHUNKS and p.chunks % (32 // p.lanes) == 0
        assert rg_k.static_smem_bytes(p.lanes) <= HW.smem_bytes
        return (p.lanes, p.chunks)
    if impl_name == "cuda.rwkv6_scan":
        p = rw_ops.node_plan(node, HW, cfg[0])
        t = node.spec.shape[1]
        assert p.chunk >= t or (p.chunk % rw_k.STEP == 0
                                and p.chunk <= rw_k.MAX_CHUNK)
        assert p.smem <= HW.smem_bytes and (p.chunks - 1) * p.chunk < t
        return (p.chunk,)
    if impl_name == "cuda.avgpool":
        p = avg_ops.node_plan(node, cfg[0])
        assert p.smem <= HW.smem_bytes
        return (p.rows,)
    raise KeyError(impl_name)


@pytest.mark.parametrize("impl_name", sorted(FAMILY_NODES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_refine_space_configs_are_legal_plans(impl_name, dtype):
    """Around every config of a family's space, the neighbourhood a
    gap-driven planner would probe holds only configs the plan builds and
    keeps as they are."""
    R._load_entry_points()
    tunable = R.get_impl(impl_name).tunable
    node = drv._node(*FAMILY_NODES[impl_name], dtype)
    for win in tunable.tune_space(node, HW):
        for cfg in tunable.refine_space(node, HW, win):
            assert _planned(impl_name, node, cfg) == cfg, (win, cfg)


# a family's config measured at the first shape is pinned by the election at
# the second (the same cache bucket) and the third (the nearest bucket)
PIN_CASES = [
    ("cuda.linear", "linear", (512, 1536, 6144), (560, 1700, 6000),
     (4, 1536, 6144)),
    ("cuda.matmul", "matmul", (512, 1536, 1536), (480, 1600, 1500),
     (4, 1536, 1536)),
    ("cuda.flash_attention", "attention", (4, 128, 12, 2, 128),
     (4, 100, 12, 2, 128), (4, 256, 12, 2, 128)),
    ("cuda.decode_attention", "decode_attention", (4, 128, 12, 2, 128),
     (4, 100, 12, 2, 128), (4, 256, 12, 2, 128)),
    ("cuda.dfp_fused", "fused", (512, 6144), (600, 7000), (4, 1536)),
    ("cuda.rglru_scan", "rglru_scan", (4, 512, 4096), (4, 600, 5000),
     (4, 1024, 4096)),
    ("cuda.rwkv6_scan", "rwkv6_scan", (4, 512, 32, 64), (4, 600, 32, 64),
     (4, 1024, 32, 64)),
    ("cuda.rwkv6_scan", "rwkv6_scan", (32, 40, 32, 64), (32, 45, 32, 64),
     (32, 100, 32, 64)),
    ("cuda.rwkv6_scan", "rwkv6_scan", (32, 512, 32, 64), (32, 600, 32, 64),
     (32, 1024, 32, 64)),
    ("cuda.avgpool", "avgpool", (64, 32, 222, 222), (64, 32, 200, 250),
     (64, 64, 109, 109)),
]


@pytest.mark.parametrize("impl_name,op,at,same,near", PIN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pinned_configs_plan_across_the_bucket(impl_name, op, at, same, near,
                                               dtype):
    """Every config measured at one shape, pinned by a measured election
    on another shape of its bucket or on one whose nearest bucket it is,
    builds a legal plan there."""
    R._load_entry_points()
    impl = R.get_impl(impl_name)
    nodes = [drv._node(op, shape, dtype) for shape in (at, same, near)]
    key, same_key, near_key = (bucket_shape(autotune.node_shape(n))
                               for n in nodes)
    assert same_key == key != near_key
    space = impl.tunable.tune_space(nodes[0], HW)
    assert space
    cache = AutotuneCache()
    cache.record(impl.op.value, autotune.node_shape(nodes[0]), dtype, "h100",
                 impl_name, 1.0, config=space[-1])
    for node, where in ((nodes[1], "exact"), (nodes[2], "nearest")):
        hit, conf = cache.lookup_with_confidence(
            impl.op.value, autotune.node_shape(node), dtype, "h100")
        assert conf == where and hit[impl_name].config == space[-1]
        for cfg in space:       # whichever of them won
            _planned(impl_name, node, cfg)
            impl.tunable.bind_config(node, cfg)
            assert impl.admissible(get_backend("h100"), node)
            impl.tunable.bind_config(node, None)


# -- measured election ----------------------------------------------------------

def test_measured_attention_election_pins_and_clears_block():
    c = AutotuneCache()
    c.record("attention", (1, 64, 2, 16), "float32", "h100",
             "cuda.flash_attention", 3.0, config=(32,))
    c.record("attention", (1, 64, 2, 16), "float32", "h100",
             "ref.attention", 9.0)
    autotune.set_cache(c)
    g, node = _attention_graph()
    passes.elect_implementations(g, get_backend("h100"))
    assert node.impl == "cuda.flash_attention"
    assert node.attrs["cuda_attn_block"] == (32,)
    assert g.election_pinned["cuda.flash_attention"] == [(32,)]
    autotune.set_cache(AutotuneCache())
    passes.elect_implementations(g, get_backend("h100"))
    assert "cuda_attn_block" not in node.attrs


def test_reelection_on_the_reference_backend_clears_the_pin():
    c = AutotuneCache()
    c.record("attention", (1, 64, 2, 16), "float32", "h100",
             "cuda.flash_attention", 3.0, config=(32,))
    autotune.set_cache(c)
    g, node = _attention_graph()
    passes.elect_implementations(g, get_backend("h100"))
    assert node.attrs["cuda_attn_block"] == (32,)
    passes.elect_implementations(g, get_backend("torch_ref"))
    assert node.impl == "ref.attention"
    assert "cuda_attn_block" not in node.attrs


def test_measured_entry_flips_the_roofline_choice():
    g, lin = _linear_graph()
    passes.elect_implementations(g, get_backend("h100"))
    assert lin.impl == "cuda.linear"
    assert g.election_provenance["cuda.linear"] == {"analytical": 1}
    c = AutotuneCache()
    c.record("linear", (2, 16, 32), "float32", "h100", "cuda.linear", 50.0,
             config=(1,))
    c.record("linear", (2, 16, 32), "float32", "h100", "ref.linear", 2.0)
    autotune.set_cache(c)
    g, lin = _linear_graph()
    passes.elect_implementations(g, get_backend("h100"))
    assert lin.impl == "ref.linear"
    assert g.election_provenance["ref.linear"] == {"measured": 1}
    assert "cuda_mm_block" not in lin.attrs     # the loser's config


def test_warm_cache_election_pins_and_reelection_clears(tmp_path):
    path = str(tmp_path / "cache.json")
    c = AutotuneCache()
    c.record("linear", (2, 16, 32), "float32", "h100", "cuda.linear", 4.0,
             config=(1,))
    c.record("linear", (2, 16, 32), "float32", "h100", "ref.linear", 9.0)
    c.save(path)
    autotune.load_cache(path)
    g, lin = _linear_graph()
    passes.elect_implementations(g, get_backend("h100"))
    assert lin.impl == "cuda.linear" and lin.attrs["cuda_mm_block"] == (1,)
    assert g.election_provenance["cuda.linear"] == {"measured": 1}
    autotune.set_cache(AutotuneCache())
    passes.elect_implementations(g, get_backend("h100"))
    assert "cuda_mm_block" not in lin.attrs


def test_pinned_configs_execute_and_match_the_reference():
    """Every family's impl with each config of its space pinned runs on
    the CPU (its plain version) and equals the reference impl."""
    backend = get_backend("h100")
    for impl_name, (op, _shape) in FAMILY_NODES.items():
        node, vals = drv._build(op, drv.TINY_SHAPES[op][0], device="cpu")
        impl = R.get_impl(impl_name)
        want = _chip_smoke().plain_version(node, vals)
        for cfg in impl.tunable.tune_space(node, HW):
            impl.tunable.bind_config(node, cfg)
            got = impl.fn(node, vals, backend)
            impl.tunable.bind_config(node, None)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_impl_report_shows_measured_provenance():
    model = nn.mlp_8192(2, 32, 16, 4, device="cpu")
    c = AutotuneCache()
    c.record("linear", (2, 16, 32), "float32", "h100", "cuda.linear", 3.0)
    autotune.set_cache(c)
    sol = optimize(model, (2, 16), backend="h100", device="cpu")
    report = sol.impl_report(provenance=True)
    assert report["cuda.linear"]["sources"].get("measured", 0) >= 1
    autotune.set_cache(AutotuneCache())
    cold = optimize(model, (2, 16), backend="h100",
                    device="cpu").impl_report(provenance=True)
    assert all("measured" not in e["sources"] for e in cold.values())


def test_calibrated_cost_model_drives_a_cold_election():
    c = AutotuneCache()
    c.set_calibration("h100", "linear",
                      {"s_per_flop": 1e-12, "s_per_byte": 1e-11, "n": 4.0})
    autotune.set_cache(c)
    g, lin = _linear_graph()
    passes.elect_implementations(g, get_backend("h100"))
    assert lin.impl == "cuda.linear"
    assert g.election_provenance["cuda.linear"] == {"calibrated": 1}


def _doctored_caches(tg, jg, shared_faster: bool):
    """One cache a package: every candidate of every node of its own graph
    timed, the shared tier (cuda.* / pallas.*) at 1 µs and the reference
    at 2 µs, or the other way round."""
    fast, slow = (1.0, 2.0) if shared_faster else (2.0, 1.0)
    tc, jc = AutotuneCache(), JAT.AutotuneCache()
    tb, jb = get_backend("h100"), j_backend("pallas_interpret")
    for g, cache, bk, reg, at in ((tg, tc, tb, R, autotune),
                                  (jg, jc, jb, JR, JAT)):
        for n in g.topo():
            if n.op.value in ("input", "param", "const", "output"):
                continue
            for impl in reg.candidates(bk, n):
                us = fast if impl.tier == reg.TIER_SHARED else slow
                cache.record(n.op.value, at.node_shape(n), n.spec.dtype,
                             bk.cache_name, impl.name, us)
    return tc, jc


@pytest.mark.parametrize("shared_faster", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_doctored_cache_decisions_equal_jax(shared_faster, dtype):
    """The measured counterpart of test_decisions_equal_jax: under a cache
    where the shared tier is faster, then one where the reference is, both
    packages elect the same tier on every node of the full, prefill and
    decode programs, from measured provenance."""
    jm, tm = models()
    for jg, tg in _programs(jm, tm, dtype):
        jg = jpasses.run_pipeline(jg, j_backend("pallas_interpret"))
        tg = passes.run_pipeline(tg, get_backend("h100"))
        tc, jc = _doctored_caches(tg, jg, shared_faster)
        autotune.set_cache(tc)
        prev = JAT.get_cache()
        JAT.set_cache(jc)
        try:
            jpasses.elect_implementations(jg, j_backend("pallas_interpret"))
            passes.elect_implementations(tg, get_backend("h100"))
        finally:
            JAT.set_cache(prev)
        tt, jt = tg.topo(), jg.topo()
        assert [IMPL_MAP.get(n.impl, n.impl) for n in tt] == \
            [n.impl for n in jt]
        tiers = {n.impl.split(".")[0] for n in tt if n.impl
                 and n.op.value in ("linear", "matmul", "attention",
                                    "decode_attention")}
        assert tiers == ({"cuda"} if shared_faster else {"ref"})
        assert all(set(v) == {"measured"}
                   for v in tg.election_provenance.values())


# -- calibration -----------------------------------------------------------------

def _entries(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i, m in enumerate((64, 128, 256, 512, 1024)):
        flops = 2.0 * m ** 3
        nbytes = 3.0 * m * m * 4.0 * (1 + rng.random())
        us = float((5e-12 * flops + 2e-10 * nbytes) * 1e6
                   * (1 + 0.2 * rng.standard_normal()))
        out.append(("matmul", (m, m, m), "float32", "h100",
                    f"impl{i % 2}", abs(us), flops, nbytes))
    out.append(("linear", (8, 8, 8), "float32", "h100", "ref.linear", 3.0,
                1e3, 0.0))
    out.append(("fused", (64, 32), "float32", "h100", "ref.compose", 2.0,
                0.0, 5e3))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_fit_equals_jax(seed):
    tc, jc = AutotuneCache(), JAT.AutotuneCache()
    for op, shape, dtype, bk, impl, us, flops, nbytes in _entries(seed):
        for c in (tc, jc):
            c.record(op, shape, dtype, bk, impl, us, flops=flops,
                     nbytes=nbytes)
    got, want = calibrate.fit(tc), jcalibrate.fit(jc)
    assert got.keys() == want.keys()
    for key in want:
        for coef, v in want[key].items():
            assert got[key][coef] == pytest.approx(v, rel=1e-9, abs=0.0)
    assert calibrate.csv_rows(tc) == jcalibrate.csv_rows(jc)


def test_calibration_fit_recovers_coefficients():
    a_true, b_true = 5e-12, 2e-10
    c = AutotuneCache()
    for m in (64, 128, 256, 512):
        flops, nbytes = 2.0 * m ** 3, 3.0 * m * m * 4.0
        c.record("matmul", (m, m, m), "float32", "h100", "ref.matmul",
                 (a_true * flops + b_true * nbytes) * 1e6, flops=flops,
                 nbytes=nbytes)
    coeffs = calibrate.fit(c)[("h100", "matmul")]
    assert coeffs["s_per_flop"] == pytest.approx(a_true, rel=1e-3)
    assert coeffs["s_per_byte"] == pytest.approx(b_true, rel=1e-3)
    assert coeffs["n"] == 4.0


def test_calibrate_cli_applies_the_fit(tmp_path, capsys):
    path = str(tmp_path / "c.json")
    assert calibrate.main(["--cache", path]) == 1       # nothing measured
    c = AutotuneCache()
    for op, shape, dtype, bk, impl, us, flops, nbytes in _entries(0):
        c.record(op, shape, dtype, bk, impl, us, flops=flops, nbytes=nbytes)
    c.save(path)
    assert calibrate.main(["--cache", path, "--apply"]) == 0
    assert "calibrate_h100_matmul" in capsys.readouterr().out
    assert AutotuneCache.load(path).calibrations() == {
        ("h100", op): coeffs for (_b, op), coeffs in calibrate.fit(c).items()}


# -- core.measure ------------------------------------------------------------------

def test_time_call_is_min_of_individually_timed_iters(monkeypatch):
    ticks = iter([0.0, 30e-6, 1.0, 1.0 + 10e-6, 2.0, 2.0 + 20e-6])
    monkeypatch.setattr(measure.time, "perf_counter", lambda: next(ticks))
    t = measure.time_call_stats(lambda: 0, warmup=1, iters=3)
    assert t.min_us == pytest.approx(10.0)
    assert t.mean_us == pytest.approx(20.0)
    ticks = iter([0.0, 30e-6, 1.0, 1.0 + 10e-6, 2.0, 2.0 + 20e-6])
    monkeypatch.setattr(measure.time, "perf_counter", lambda: next(ticks))
    assert measure.time_call(lambda: 0, warmup=1, iters=3) == \
        pytest.approx(10.0)


def test_measure_unpins_swept_config_when_impl_raises():
    _g, lin = _linear_graph()
    backend = get_backend("h100")
    calls = []

    def exploding(node, vals, bk):
        calls.append(tuple(node.attrs.get("boom_block") or ()))
        if len(calls) >= 3:         # the warmup and timed calls of (8,) pass
            raise RuntimeError("kernel rejects this config")
        return vals[0]

    impl = types.SimpleNamespace(
        fn=exploding, tunable=Tunable("boom_block", lambda n, hw: []))
    with pytest.raises(RuntimeError):
        measure.measure_impl_configs(lin, [torch.ones(2, 16)], backend, impl,
                                     [(8,), (16,), (32,)], warmup=1, iters=1)
    assert "boom_block" not in lin.attrs
    assert calls == [(8,), (8,), (16,)]
    calls.clear()
    out = measure.measure_impl_configs(
        lin, [torch.ones(2, 16)], backend, impl, [(8,), (16,), (32,)],
        warmup=1, iters=1, skip_errors=True)
    assert "boom_block" not in lin.attrs
    assert [m.error is None for m in out] == [True, False, False]
    assert all(m.us == float("inf") for m in out if m.error)


def test_sweep_node_records_min_and_mean_and_restores_attrs():
    backend = get_backend("h100")
    for op in ("linear", "attention", "fused", "rglru_scan"):
        node, vals = drv._build(op, drv.TINY_SHAPES[op][0], device="cpu")
        before = dict(node.attrs)
        cache = AutotuneCache()
        out = measure.sweep_node(node, vals, backend, cache, warmup=0,
                                 iters=3)
        assert node.attrs == before
        assert {m.impl for m in out} == \
            {i.name for i in R.candidates(backend, node)}
        got = cache.lookup(node.op.value, autotune.node_shape(node),
                           "float32", "h100")
        for m in out:
            assert got[m.impl].mean_us >= got[m.impl].us > 0.0
            assert got[m.impl].mean_us == m.mean_us
            assert got[m.impl].flops > 0 or got[m.impl].nbytes > 0


def test_sweep_node_unpins_when_an_impl_raises(monkeypatch):
    node, vals = drv._build("linear", (8, 64, 32), device="cpu")
    impl = R.get_impl("cuda.linear")

    def boom(n, v, bk):
        assert n.attrs.get("cuda_mm_block")
        raise RuntimeError("launch refused")

    raising = R.Impl(impl.name, impl.op, boom, impl.tier,
                     requires=impl.requires, supports=impl.supports,
                     tunable=impl.tunable)
    monkeypatch.setattr(R, "candidates", lambda bk, n: [raising])
    with pytest.raises(RuntimeError, match="launch refused"):
        measure.sweep_node(node, vals, get_backend("h100"), AutotuneCache())
    assert "cuda_mm_block" not in node.attrs


# -- the driver --------------------------------------------------------------------

def test_driver_measures_every_admissible_impl():
    cache = AutotuneCache()
    rows = drv.tune("h100", ("linear",), tiny=True, warmup=0, iters=1,
                    cache=cache, device="cpu")
    names = {r[0] for r in rows}
    assert any("cuda.linear" in n for n in names)
    assert any("ref.linear" in n for n in names)
    got = cache.lookup("linear", (8, 64, 32), "float32", "h100")
    assert got["cuda.linear"].config is not None
    assert got["cuda.linear"].flops > 0


def test_driver_sweeps_every_family_and_dtype():
    for dtype in ("float32", "bfloat16"):
        cache = AutotuneCache()
        drv.tune("h100", drv.DEFAULT_OPS, tiny=True, warmup=0, iters=1,
                 cache=cache, device="cpu", dtype=dtype)
        tuned = {nm for (op, dt, bk), _b, nm, m in cache.entries()
                 if m.config is not None}
        assert tuned == set(FAMILY_NODES), dtype
        assert {dt for (_op, dt, _bk), *_ in cache.entries()} == {dtype}


def test_csv_rows_leave_the_process_cache_alone():
    rows = drv.csv_rows(device="cpu")
    assert len(autotune.get_cache()) == 0
    assert any("_h100_" in r[0] for r in rows)
    assert any("_torch_ref_" in r[0] for r in rows)


def test_verify_cache_roundtrip_with_attention_flip(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = AutotuneCache()
    for ops in (("linear",), ("attention",)):
        drv.tune("h100", ops, tiny=True, warmup=0, iters=1, cache=cache,
                 device="cpu")
    cache.save(path)
    assert drv.verify_cache(path, "cpu") == 0
    assert drv.verify_cache(str(tmp_path / "missing.json"), "cpu") == 1


def test_autotune_cli_tiny_verify_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.autotune", "--tiny",
         "--device", "cpu", "--verify", "--warmup", "0", "--iters", "1",
         "--cache", str(tmp_path / "c.json")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "attention flip" in out.stdout
    assert (tmp_path / "c.json").is_file()


@pytest.mark.parametrize("op", drv.DEFAULT_OPS)
def test_plain_version_equals_the_reference_impl(op):
    """The plain version a config is held against computes the node's
    function: on the CPU it equals the reference tier's lowering."""
    node, vals = drv._build(op, drv.TINY_SHAPES[op][0], device="cpu")
    ref = get_backend("torch_ref").resolve(node)
    assert ref.name.startswith("ref.")
    want = ref.fn(node, vals, get_backend("torch_ref"))
    torch.testing.assert_close(_chip_smoke().plain_version(node, vals), want,
                               rtol=1e-5, atol=1e-5)

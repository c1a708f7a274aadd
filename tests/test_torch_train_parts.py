"""The backbone trainer's parts in the port held to the JAX package's, on
the CPU.

* The explicit backwards: ``models.flash.flash_mha`` on both of its
  forwards (the flash kernel's entry, whose plain version runs on the
  CPU, and the chunked scan), the RG-LRU and RWKV6 scan entries
  (``recurrent.rglru_scan_kernel`` / ``rwkv6_scan_kernel``, with an
  initial state and cotangents on both outputs) and the MoE dispatch
  gather and combine scatter, against ``jax.grad`` of their JAX
  counterparts (``flash_mha``, ``rglru_seq``, ``_wkv_chunked``,
  ``_moe_gather``, ``_moe_scatter``).  Each port gradient comes from the
  ``torch.autograd.Function``'s own backward (the tests check the graph
  node), within 1e-4 of the reference gradient's L2 norm in f32.
* One ``make_train_step`` step of each package from the same state
  (``convert.train_state_from_numpy``) and batch, with remat on and off,
  2 microbatches, bf16 gradient compression and bf16 moments: the loss
  and metrics within 1e-5 relative, new parameters and moments within
  rtol 1e-4, atol 1e-5.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.distributed import steps as JST
from repro.launch.mesh import make_debug_mesh as jmake_debug_mesh
from repro.models import flash as JF
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro.models.config import TRAIN_4K
from repro_torch.configs import get_smoke
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.distributed import sharding as TS
from repro_torch.distributed import steps as TST
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import train_batch_specs
from repro_torch.models import backbone as TB
from repro_torch.models import flash as TF
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR

GRAD_TOL = 1e-4          # of each reference gradient's L2 norm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these steps are many small ops, and torch's
    default thread count in each of several test workers oversubscribes
    the cores (a 12-step RWKV6 run took 80 s instead of 2 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def grad_close(got, want, tol=GRAD_TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    norm = float(np.linalg.norm(want))
    err = float(np.abs(got - want).max())
    assert err <= tol * max(norm, 1e-30), (what, err, norm)


# ---------------------------------------------------------------------------
# flash attention's backward
# ---------------------------------------------------------------------------

# (B, S, H, KV, hd, causal, window, cap): GQA, windows, softcaps, and the
# encoder's non-causal form
FLASH_CASES = [(2, 48, 4, 2, 16, True, 0, 0.0),
               (1, 64, 4, 1, 32, True, 16, 0.0),
               (2, 40, 6, 3, 16, True, 0, 30.0),
               (1, 32, 2, 2, 16, True, 8, 20.0),
               (2, 24, 4, 4, 16, False, 0, 0.0)]


def _flash_inputs(b, s, h, kvh, hd, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, s, h, hd)).astype(np.float32)
    k = r.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = r.standard_normal((b, s, kvh, hd)).astype(np.float32)
    w = r.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v, w


def _flash_grads(case, kernel: bool, chunk: int = 1024):
    """(port grads, JAX grads) of Σ w·flash_mha(q, k, v) over q, k, v."""
    b, s, h, kvh, hd, causal, window, cap = case
    q, k, v, w = _flash_inputs(b, s, h, kvh, hd)

    def jloss(q, k, v):
        return (JF.flash_mha(q, k, v, causal, window, cap, chunk)
                * w).sum()
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o = TF.flash_mha(tq, tk, tv, causal, window, cap, chunk, kernel=kernel)
    assert type(o.grad_fn).__name__ == "_FlashMHABackward"
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    return got, want


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_matches_jax_grad(case, kernel):
    got, want = _flash_grads(case, kernel)
    for g, wt, name in zip(got, want, "qkv"):
        grad_close(g, wt, what=f"d{name}")


def test_flash_backward_in_chunks_matches_jax_grad():
    """Several KV chunks (the plain scan's forward and both backwards)."""
    got, want = _flash_grads((1, 80, 4, 2, 16, True, 24, 0.0), False,
                             chunk=32)
    for g, wt, name in zip(got, want, "qkv"):
        grad_close(g, wt, what=f"d{name}")


def test_flash_backward_without_dsum_fails_the_check(monkeypatch):
    """A backward that drops D = Σ dO·O (the planted fault of the chip
    check) misses the reference: the check is live."""
    monkeypatch.setattr(TF, "row_dsum",
                        lambda dog, og: torch.zeros_like(dog[..., 0]))
    got, want = _flash_grads(FLASH_CASES[0], True)
    with pytest.raises(AssertionError):
        grad_close(got[0], want[0])


# ---------------------------------------------------------------------------
# the scans' backwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 24, 16), (1, 7, 8)], ids=str)
def test_rglru_scan_backward_matches_jax_grad(shape):
    """The RG-LRU from its gates through the scan entry, from an initial
    state, with cotangents on h and h_last, against ``jax.grad`` of
    JAX's ``rglru_seq``."""
    b, t, d = shape
    r = np.random.default_rng(1)
    p = {"wa": (r.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32),
         "wx": (r.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32),
         "lam": r.uniform(0.5, 4.0, d).astype(np.float32)}
    u = r.standard_normal((b, t, d)).astype(np.float32)
    h0 = r.standard_normal((b, d)).astype(np.float32)
    w = r.standard_normal((b, t, d)).astype(np.float32)
    wl = r.standard_normal((b, d)).astype(np.float32)

    def jloss(p, u, h0):
        h, hl = JR.rglru_seq(p, u, h0)
        return (h * w).sum() + (hl * wl).sum()
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(p, u, h0)

    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tu, th0 = (torch.from_numpy(x).requires_grad_(True) for x in (u, h0))
    log_a, bb = TR.rglru_gates(tp, tu)
    h, hl = TR.rglru_scan_kernel(torch.exp(log_a), bb, th0)
    assert type(h.grad_fn).__name__ == "_RGLRUScanBackward"
    loss = (h * torch.from_numpy(w)).sum() + (hl * torch.from_numpy(wl)).sum()
    got = torch.autograd.grad(loss, [tp["wa"], tp["wx"], tp["lam"], tu, th0])
    for g, wt, name in zip(got, [want[0]["wa"], want[0]["wx"],
                                 want[0]["lam"], want[1], want[2]],
                           ["wa", "wx", "lam", "u", "h0"]):
        grad_close(g, wt, what=name)


@pytest.mark.parametrize("shape", [(2, 40, 2, 8), (1, 16, 3, 16)], ids=str)
def test_rwkv6_scan_backward_matches_jax_grad(shape):
    """The WKV scan entry from an initial state, with cotangents on o and
    s_last, against ``jax.grad`` of JAX's ``_wkv_chunked``."""
    b, t, h, hd = shape
    r = np.random.default_rng(2)
    rr, kk, vv = (0.5 * r.standard_normal((b, t, h, hd))).astype(
        np.float32), (0.5 * r.standard_normal((b, t, h, hd))).astype(
        np.float32), r.standard_normal((b, t, h, hd)).astype(np.float32)
    logw = -np.exp(r.standard_normal((b, t, h, hd)) - 1.0).astype(
        np.float32)
    u = (0.3 * r.standard_normal((h, hd))).astype(np.float32)
    s0 = (0.2 * r.standard_normal((b, h, hd, hd))).astype(np.float32)
    wo = r.standard_normal((b, t, h, hd)).astype(np.float32)
    ws = r.standard_normal((b, h, hd, hd)).astype(np.float32)
    ins = (rr, kk, vv, logw, u, s0)

    def jloss(*xs):
        o, s_last = JR._wkv_chunked(*xs)
        return (o * wo).sum() + (s_last * ws).sum()
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*ins)
    tin = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    o, s_last = TR.rwkv6_scan_kernel(*tin)
    assert type(o.grad_fn).__name__ == "_RWKV6ScanBackward"
    loss = (o * torch.from_numpy(wo)).sum() + \
        (s_last * torch.from_numpy(ws)).sum()
    got = torch.autograd.grad(loss, tin)
    for g, wt, name in zip(got, want, ["r", "k", "v", "logw", "u", "s0"]):
        grad_close(g, wt, what=name)


# ---------------------------------------------------------------------------
# the MoE's dispatch and combine
# ---------------------------------------------------------------------------

def _slots(seed=3, ng=2, gs=12, e=4, cap=8):
    """Slot tables as the router makes them: token ids in [0, gs], the pad
    row gs in unused slots, a token in up to two experts' slots."""
    r = np.random.default_rng(seed)
    st = np.full((ng, e, cap), gs, np.int32)
    for g in range(ng):
        for t in range(gs):
            for ex in r.choice(e, 2, replace=False):
                free = np.nonzero(st[g, ex] == gs)[0]
                if len(free):
                    st[g, ex, free[0]] = t
    return st


def test_moe_gather_backward_matches_jax_grad():
    st = _slots()
    ng, e, cap = st.shape
    gs = 12
    r = np.random.default_rng(4)
    x = r.standard_normal((ng, gs + 1, 8)).astype(np.float32)
    w = r.standard_normal((ng, e, cap, 8)).astype(np.float32)
    want = jax.grad(lambda x: (JL._moe_gather(x, jnp.asarray(st)) * w
                               ).sum())(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = TL.moe_gather(tx, torch.from_numpy(st).long())
    assert type(out.grad_fn).__name__ == "_MoEGatherBackward"
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(JL._moe_gather(x, jnp.asarray(st))))
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tx)
    grad_close(got, want)


def test_moe_scatter_backward_matches_jax_grad():
    st = _slots(seed=5)
    ng, e, cap = st.shape
    gs = 12
    r = np.random.default_rng(6)
    yw = r.standard_normal((ng, e, cap, 8)).astype(np.float32)
    w = r.standard_normal((ng, gs + 1, 8)).astype(np.float32)

    def jloss(yw):
        return (JL._moe_scatter(yw, jnp.asarray(st), gs) * w).sum()
    want = jax.grad(jloss)(yw)
    ty = torch.from_numpy(yw).requires_grad_(True)
    out = TL.moe_scatter(ty, torch.from_numpy(st).long(), gs)
    assert type(out.grad_fn).__name__ == "_MoEScatterBackward"
    grad_close(out, JL._moe_scatter(yw, jnp.asarray(st), gs), 1e-6)
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ty)
    grad_close(got, want)


# ---------------------------------------------------------------------------
# one train step of each package
# ---------------------------------------------------------------------------

STEP_CASES = {"remat": dict(remat=True), "no_remat": dict(remat=False),
              "microbatch2": dict(microbatch=2),
              "bf16_compression": dict(grad_compression="bf16"),
              "bf16_moments": dict(moment_dtype="bfloat16")}


def _f32_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32))
                        if x.dtype == jnp.bfloat16 else np.asarray(x), tree)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    """One step from the same state and batch (qwen2's reduced config,
    lr 1e-3 at step 0).  Where a gradient element lies below 1e-7 (ten
    times AdamW's eps) the update m̂/(√v̂ + eps) is set by the gradient's
    rounding, not its value, so there the new parameter is held to the
    update's bound, 2·lr, instead."""
    opts = dict(remat=False, zero=False, lr=1e-3, warmup=0, total_steps=10)
    opts.update(STEP_CASES[case])
    jc, tc = jget_smoke("qwen2-1.5b"), get_smoke("qwen2-1.5b")
    jo, to = JST.StepOptions(**opts), TST.StepOptions(**opts)
    batch = SyntheticTokenDataset(DataConfig(
        seed=0, vocab=tc.vocab, seq_len=16, global_batch=4)).batch(0)
    jstate = JST.init_train_state(jc, jo, jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(tc, _f32_tree(jstate), device="cpu",
                                    moment_dtype=to.moment_dtype)
    mesh = jmake_debug_mesh(1, 1)
    jstep, _ = JST.make_train_step(mesh, jc, jo)
    with mesh:
        jnew, jm = jax.jit(jstep)(jstate, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tstep, _ = TST.make_train_step(make_debug_mesh(1, 1, device="cpu"), tc,
                                   to)
    tnew, tm = tstep(tstate, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert set(tm) == set(jm)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    assert int(tnew["opt"]["step"]) == 1
    want = dict(TB.tree_leaves(_f32_tree(jnew)))
    grad = dict(TB.tree_leaves(_f32_tree(jnew["opt"]["m"])))
    for path, leaf in TB.tree_leaves(tnew):
        got, ref = leaf.float().numpy(), want[path]
        ok = np.isclose(got, ref, rtol=1e-4, atol=1e-5)
        if path[0] == "params":
            g = np.abs(grad[path[1:]]) / 0.1          # m = (1 - β1)·g
            ok |= (g < 1e-7) & (np.abs(got - ref) <= 2 * opts["lr"])
        if path[:2] == ("opt", "m") and to.moment_dtype == "bfloat16":
            # one bf16 rounding step apart where the f32 values straddle
            ok |= np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref)
        assert ok.all(), (path, float(np.abs(got - ref).max()))
        if path[:2] == ("opt", "m"):
            assert leaf.dtype == getattr(torch, to.moment_dtype)


def test_train_step_writes_nothing_and_refuses_a_larger_mesh():
    """Body rewritten, name kept: a larger abstract mesh now raises
    ``ValueError`` naming the process groups it lacks (a mesh of ranks
    trains: tests/test_torch_mesh_backbone.py)."""
    cfg = get_smoke("qwen2-1.5b")
    opts = TST.StepOptions(lr=1e-2, warmup=0, total_steps=4)
    state = TST.init_train_state(cfg, opts, torch.Generator().manual_seed(0),
                                 "cpu")
    before = [x.clone() for _, x in TB.tree_leaves(state)]
    step, specs = TST.make_train_step(make_debug_mesh(1, 1, device="cpu"),
                                      cfg, opts)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokenDataset(
        DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)).batch(0)
        .items()}
    new, metrics = step(state, batch)
    assert all(torch.equal(a, b) for a, (_, b) in
               zip(before, TB.tree_leaves(state)))
    assert set(metrics) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert int(new["step"]) == 1
    assert specs["step"] == TS.P()
    with pytest.raises(ValueError, match="process groups"):
        TST.make_train_step(AbstractMesh((2, 2)), cfg, opts)
    jstep, _, bspecs = TST.jit_train_step(
        AbstractMesh((1, 1)), cfg, opts, train_batch_specs(cfg, TRAIN_4K))
    assert bspecs == {"tokens": TS.P("data", None),
                      "labels": TS.P("data", None)}
    shapes = TST.train_state_shapes(cfg, opts)
    assert shapes["params"]["embed"].device.type == "meta"

"""The model-zoo backbone in the port held to the JAX package's, on the CPU.

For each of the ten reduced configs (``get_smoke``) the JAX package's
``init_params`` tree is carried into the port (``convert.
backbone_params_from_numpy``) and both packages run the same tokens (and
the modality stubs' inputs) from a seed:

* ``forward`` logits within 1e-5 of their scale (RWKV6 1e-4), on both of
  the port's routes (on the CPU the kernel route takes each kernel's plain
  version);
* the port's ``decode_step`` loop equals its own ``forward``, and a
  prefill that fills the cache followed by decode steps equals it too;
* greedy tokens from a decode loop equal the JAX ``decode_step`` loop's;
* the local layers' ring cache equals a full-length cache (the
  counterpart of ``test_local_ring_cache_matches_full``);
* the serve steps on a one-process CPU mesh equal the backbone's
  functions.

The JAX side of each config is computed once, in a module-scoped fixture.
"""
import dataclasses
import functools
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
from repro_torch.convert import (backbone_cache_from_numpy,
                                 backbone_params_from_numpy)
from repro_torch.distributed import steps as TS
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import backbone as TB

KEY = jax.random.PRNGKey(0)
BSZ, PROMPT, GEN = 2, 8, 4


def tol_of(cfg) -> float:
    return 1e-4 if "rwkv" in cfg.layer_pattern else 1e-5


def rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _inputs(cfg, seed: int = 0):
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(0, cfg.vocab, (BSZ, PROMPT)).astype(
        np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = (0.1 * r.standard_normal(
            (BSZ, cfg.n_patches, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "audio":
        out["frames"] = (0.1 * r.standard_normal(
            (BSZ, cfg.enc_dec.enc_seq, cfg.d_model))).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _jax_decode_loop(cfg, params, tokens, gen, max_seq, enc_out=None):
    """Feed ``tokens`` one at a time, then ``gen`` greedy tokens: (every
    step's logits (B, steps, V), the greedy tokens (B, gen))."""
    dec = jax.jit(functools.partial(JB.decode_step, cfg))
    cache = JB.init_cache(cfg, tokens.shape[0], max_seq)
    rows, out = [], []
    tok = None
    for t in range(tokens.shape[1] + gen):
        feed = tokens[:, t:t + 1] if t < tokens.shape[1] else tok[:, None]
        lg, cache = dec(params, cache, jnp.asarray(feed), jnp.asarray(t),
                        enc_out)
        rows.append(np.asarray(lg[:, 0]))
        tok = np.asarray(jnp.argmax(lg[:, 0], -1)).astype(np.int32)
        if t >= tokens.shape[1] - 1 and len(out) < gen:
            out.append(tok)
    return np.stack(rows, 1), np.stack(out, 1) if out else None


def _port_decode_loop(cfg, params, tokens, gen, max_seq, enc_out=None,
                      plain=False):
    cache = TB.init_cache(cfg, tokens.shape[0], max_seq, "cpu")
    rows, out = [], []
    tok = None
    with torch.inference_mode():
        for t in range(tokens.shape[1] + gen):
            feed = tokens[:, t:t + 1] if t < tokens.shape[1] \
                else tok[:, None]
            lg, cache = TB.decode_step(cfg, params, cache, feed, t, enc_out,
                                       plain=plain)
            rows.append(lg[:, 0])
            tok = lg[:, 0].argmax(-1)
            if t >= tokens.shape[1] - 1 and len(out) < gen:
                out.append(tok)
    return torch.stack(rows, 1), torch.stack(out, 1) if out else None


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    """One reduced config, its JAX parameters carried into the port, and
    the JAX package's forward logits and greedy decode loop, computed
    once."""
    name = request.param
    jcfg, cfg = jget_smoke(name), get_smoke(name)
    jparams = JB.init_params(jcfg, KEY)
    params = backbone_params_from_numpy(cfg, _np_tree(jparams), "cpu")
    batch = _inputs(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = jax.jit(functools.partial(JB.forward, jcfg))(jparams,
                                                               jbatch)
    enc_out = None
    if jcfg.frontend == "audio":
        enc_out = JB.run_encoder(jcfg, jparams, jbatch["frames"])
    rows, greedy = _jax_decode_loop(jcfg, jparams, batch["tokens"], GEN,
                                    PROMPT + GEN, enc_out)
    return {"name": name, "cfg": cfg, "jcfg": jcfg, "jparams": jparams,
            "params": params, "batch": batch, "logits": np.asarray(logits),
            "aux": float(aux), "enc_out": enc_out, "rows": rows,
            "greedy": greedy}


def _port_enc_out(a):
    if a["cfg"].frontend != "audio":
        return None
    with torch.inference_mode():
        return TB.run_encoder(a["cfg"], a["params"],
                              torch.from_numpy(a["batch"]["frames"]))


def test_param_tree_carries_over_leaf_for_leaf(arch):
    """The port's own init draws the JAX tree's keys, shapes and dtypes,
    with its constants and its scales."""
    cfg = arch["cfg"]
    own = TB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jl = dict(TB.tree_leaves(jax.tree.map(np.asarray, arch["jparams"])))
    tl = dict(TB.tree_leaves(own))
    assert sorted(tl) == sorted(jl)
    for path, t in tl.items():
        j = jl[path]
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype)[6:] == str(j.dtype), path
        if j.std() == 0:                 # ones, zeros, 0.5, -1
            assert torch.equal(t, torch.from_numpy(j.astype(np.float32))), \
                path
        elif j.size >= 1024:
            assert abs(float(t.std()) / float(j.std()) - 1) < 0.1, path
    carried = dict(TB.tree_leaves(arch["params"]))
    assert sorted(carried) == sorted(jl)


def test_forward_matches_jax_on_both_routes(arch):
    cfg = arch["cfg"]
    with torch.inference_mode():
        for plain in (False, True):
            logits, aux = TB.forward(cfg, arch["params"],
                                     _torch_batch(arch["batch"]),
                                     plain=plain)
            assert rel_err(logits, arch["logits"]) <= tol_of(cfg)
            assert abs(float(aux) - arch["aux"]) <= 1e-5 * max(
                1.0, abs(arch["aux"]))
            assert torch.isfinite(logits).all()


def test_decode_loop_matches_own_forward_and_jax_greedy(arch):
    """Token by token from an empty cache (tokens alone: a VLM's patches
    reach the cache through a prefill), every step's logits equal the
    forward's row (and JAX's decode step's); the greedy continuation
    equals JAX's tokens."""
    cfg = arch["cfg"]
    batch = {k: v for k, v in _torch_batch(arch["batch"]).items()
             if k != "patches"}
    enc_out = _port_enc_out(arch)
    with torch.inference_mode():
        full, _ = TB.forward(cfg, arch["params"], batch)
    for plain in (False, True):
        rows, greedy = _port_decode_loop(cfg, arch["params"],
                                         batch["tokens"], GEN, PROMPT + GEN,
                                         enc_out, plain)
        assert rel_err(rows[:, :PROMPT], full.numpy()) <= tol_of(cfg)
        assert rel_err(rows, arch["rows"]) <= tol_of(cfg)
        assert np.array_equal(greedy.numpy(), arch["greedy"])


def test_prefill_fills_the_cache_for_decode(arch):
    """A prefill into a fresh cache, then greedy decode steps: the first
    rows equal the forward, each step equals a forward over its prefix."""
    cfg = arch["cfg"]
    batch = _torch_batch(arch["batch"])
    params = arch["params"]
    enc_out = _port_enc_out(arch)
    s = PROMPT + (cfg.n_patches if cfg.frontend == "vision" else 0)
    with torch.inference_mode():
        full, _ = TB.forward(cfg, params, batch)
        cache = TB.init_cache(cfg, BSZ, s + GEN, "cpu")
        logits, cache = TB.prefill(cfg, params, batch, cache)
        assert rel_err(logits, full.numpy()) <= tol_of(cfg)
        toks, rows = [logits[:, -1].argmax(-1)], [logits[:, -1]]
        for j in range(GEN):
            lg, cache = TB.decode_step(cfg, params, cache, toks[-1][:, None],
                                       s + j, enc_out)
            rows.append(lg[:, 0])
            toks.append(lg[:, 0].argmax(-1))
        fed = torch.stack(toks[:GEN], 1)
        longer, _ = TB.forward(cfg, params, dict(
            batch, tokens=torch.cat([batch["tokens"], fed], 1)))
    assert rel_err(torch.stack(rows, 1), longer[:, s - 1:].numpy()) <= \
        tol_of(cfg)


def test_serve_steps_on_a_one_process_cpu_mesh(arch):
    cfg = arch["cfg"]
    mesh = make_debug_mesh(1, 1, device="cpu")
    prefill = TS.make_prefill_step(mesh, cfg)
    decode = TS.make_decode_step(mesh, cfg)
    batch = _torch_batch(arch["batch"])
    logits = prefill(arch["params"], batch)
    assert rel_err(logits, arch["logits"]) <= tol_of(cfg)
    s = logits.shape[1]
    cache = TB.init_cache(cfg, BSZ, s + 1, "cpu")
    logits2, cache = prefill(arch["params"], batch, cache)
    assert torch.equal(logits2, logits)
    lg, _ = decode(arch["params"], cache, logits[:, -1].argmax(-1)[:, None],
                   s, _port_enc_out(arch))
    with torch.inference_mode():
        want, _ = TB.decode_step(cfg, arch["params"], cache,
                                 logits[:, -1].argmax(-1)[:, None], s,
                                 _port_enc_out(arch))
    assert torch.equal(lg, want)


def test_cache_tree_carries_over(arch):
    cfg, jcfg = arch["cfg"], arch["jcfg"]
    jcache = JB.init_cache(jcfg, BSZ, 16)
    cache = backbone_cache_from_numpy(cfg, _np_tree(jcache), BSZ, 16, "cpu")
    own = TB.init_cache(cfg, BSZ, 16, "cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in TB.tree_leaves(cache)] \
        == [(p, tuple(t.shape), t.dtype) for p, t in TB.tree_leaves(own)]


@pytest.mark.parametrize("kernel_route", [True, False])
def test_local_ring_cache_matches_full(kernel_route):
    """Griffin's local attention with a cache of exactly ``window`` slots
    (a ring, written at pos % window) decodes like the forward, and like
    JAX's ring; a prefill longer than the window fills the ring."""
    jcfg = dataclasses.replace(jget_smoke("recurrentgemma_9b"), window=8)
    cfg = dataclasses.replace(get_smoke("recurrentgemma_9b"), window=8)
    jparams = JB.init_params(jcfg, KEY)
    params = backbone_params_from_numpy(cfg, _np_tree(jparams), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 16)).astype(
        np.int32)
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full, _ = TB.forward(cfg, params, {"tokens": tt})
    rows, _ = _port_decode_loop(cfg, params, tt, 0, cfg.window,
                                plain=not kernel_route)
    jrows, _ = _jax_decode_loop(jcfg, jparams, toks, 0, jcfg.window)
    assert rel_err(rows, full.numpy()) <= 1e-5
    assert rel_err(rows, jrows) <= 1e-5
    with torch.inference_mode():
        cache = TB.init_cache(cfg, 1, cfg.window, "cpu")
        _, cache = TB.prefill(cfg, params, {"tokens": tt[:, :12]}, cache,
                              plain=not kernel_route)
        for t in range(12, 16):
            lg, cache = TB.decode_step(cfg, params, cache, tt[:, t:t + 1], t,
                                       plain=not kernel_route)
            assert rel_err(lg[:, 0], full[:, t].numpy()) <= 1e-5


def test_params_from_numpy_refuses_a_wrong_tree():
    cfg = get_smoke("qwen2_1_5b")
    tree = _np_tree(JB.init_params(jget_smoke("qwen2_1_5b"), KEY))
    extra = dict(tree, spare=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="unexpected"):
        backbone_params_from_numpy(cfg, extra, "cpu")
    missing = dict(tree)
    del missing["ln_f"]
    with pytest.raises(KeyError, match="missing"):
        backbone_params_from_numpy(cfg, missing, "cpu")
    wrong = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        backbone_params_from_numpy(cfg, wrong, "cpu")
    bf16 = backbone_params_from_numpy(cfg, tree, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16
               for _, t in TB.tree_leaves(bf16))

"""The backbone trainer's rules and optimizer in the port held to the JAX
package's, on the CPU.

* The spec rules (``distributed.sharding.param_specs``, ``cache_specs``,
  ``batch_specs``, ``zero.zero_opt_specs``, ``optim.opt_state_specs``)
  equal JAX's entry for entry for the ten full configs on the (16, 16)
  and (2, 16, 16) meshes (``AbstractMesh`` on both sides: no devices).
* AdamW over a nested tree with f32 and bf16 moments against JAX's
  ``adamw_update`` (f32 within rtol 1e-5; bf16 moments within one bf16
  rounding, rtol 1e-2); gradient compression; the sharding context.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.distributed import sharding as JS
from repro.distributed.zero import zero_opt_specs as jzero_opt_specs
from repro.launch.specs import train_batch_specs as jtrain_batch_specs
from repro.models import backbone as JB
from repro.models.config import TRAIN_4K
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch.configs import get_config
from repro_torch.distributed import compress as TC
from repro_torch.distributed import ctx as TCTX
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.distributed.zero import zero_opt_specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import train_batch_specs
from repro_torch.models import backbone as TB
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               opt_state_specs)


def _f32_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32))
                        if x.dtype == jnp.bfloat16 else np.asarray(x), tree)


# ---------------------------------------------------------------------------
# the spec rules
# ---------------------------------------------------------------------------

def _jmesh(multi_pod):
    from jax.sharding import AbstractMesh as JAbstractMesh
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    try:
        return JAbstractMesh(sizes, names)
    except TypeError:
        return JAbstractMesh(tuple(zip(names, sizes)))


def _tmesh(multi_pod):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16))


def _jspecs(tree):
    from jax.sharding import PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(spec) for path, spec in flat}


def _tspecs(tree):
    out = {}

    def walk(t, prefix):
        if isinstance(t, TS.P):
            out[prefix] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + (k,))
        else:
            for i, v in enumerate(t):
                walk(v, prefix + (i,))
    walk(tree, ())
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "2pods"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch, multi_pod):
    jc, tc = jget_config(arch), get_config(arch)
    jm, tm = _jmesh(multi_pod), _tmesh(multi_pod)
    jshapes, tshapes = JB.param_specs(jc), TB.param_specs(tc)
    jp = JS.param_specs(jm, jc, jshapes)
    tp = TS.param_specs(tm, tc, tshapes)
    assert _tspecs(tp) == _jspecs(jp)
    assert _tspecs(zero_opt_specs(tm, tp, tshapes)) == \
        _jspecs(jzero_opt_specs(jm, jp, jshapes))
    assert _tspecs(opt_state_specs(tp)) == _jspecs(
        {"m": jp, "v": jp, "step": jax.sharding.PartitionSpec()})
    shp = TRAIN_4K
    jcache = JB.cache_specs(jc, shp.global_batch, 32768)
    tcache = TB.cache_specs(tc, shp.global_batch, 32768)
    assert _tspecs(TS.cache_specs(tm, tc, tcache)) == \
        _jspecs(JS.cache_specs(jm, jc, jcache))
    assert _tspecs(TS.batch_specs(tm, tc, train_batch_specs(tc, shp))) == \
        _jspecs(JS.batch_specs(jm, jc, jtrain_batch_specs(jc, shp)))


# ---------------------------------------------------------------------------
# AdamW, compression, the context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_on_a_nested_tree_matches_jax(moment_dtype):
    r = np.random.default_rng(7)
    params = {"a": {"w": r.standard_normal((4, 3)).astype(np.float32),
                    "b": r.standard_normal(3).astype(np.float32)},
              "z": r.standard_normal((2, 2)).astype(np.float32)}
    grads = jax.tree.map(lambda x: (0.5 * x + 0.1).astype(np.float32),
                         params)
    jcfg = JAdamWConfig(lr=0.1, moment_dtype=moment_dtype)
    tcfg = AdamWConfig(lr=0.1, moment_dtype=moment_dtype)
    jp, js = params, jinit_opt_state(params, jcfg)
    tp = TB.tree_map(torch.from_numpy, params)
    ts = init_opt_state(tp, tcfg)
    assert ts["m"]["a"]["w"].dtype == getattr(torch, moment_dtype)
    for _ in range(3):
        jp, js, jm = jadamw_update(jp, grads, js, jcfg, jnp.asarray(0.1))
        tp, ts, tm = adamw_update(tp, TB.tree_map(torch.from_numpy, grads),
                                  ts, tcfg, torch.tensor(0.1))
    for (path, got), (_, want) in zip(TB.tree_leaves(tp),
                                      TB.tree_leaves(_f32_tree(jp))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for (path, got), (_, want) in zip(TB.tree_leaves(ts["v"]),
                                      TB.tree_leaves(_f32_tree(js["v"]))):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2)
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < 1e-5


def test_grad_compression_rounds_to_bf16_and_refuses_other_names():
    g = {"a": torch.tensor([1.0 + 2 ** -12, 3.0]),
         "b": torch.ones(2, dtype=torch.bfloat16)}
    c = TC.compress_grads(g, "bf16")
    assert c["a"].dtype == torch.bfloat16 and c["b"].dtype == torch.bfloat16
    d = TC.decompress_grads(c, "bf16")
    assert d["a"].tolist() == [1.0, 3.0]
    assert TC.compress_grads(g, "none") is g
    with pytest.raises(ValueError, match="unknown compression"):
        TC.compress_grads(g, "fp8")


def test_constrain_is_the_identity_on_one_process():
    """Body rewritten, name kept: the identity with no mesh and on 1×1; an
    abstract mesh of several devices has no process groups to place an
    activation on and raises naming them."""
    x = torch.ones(4, 2)
    assert TCTX.constrain(x, ("dp", None)) is x
    with TCTX.use_mesh(make_debug_mesh(1, 1, device="cpu")):
        assert TCTX.constrain(x, ("dp", "model")) is x
    with TCTX.use_mesh(AbstractMesh((2, 2))):
        with pytest.raises(ValueError, match="process groups"):
            TCTX.constrain(x, ("dp", None))
    assert TCTX.constrain(x, ("dp", None)) is x

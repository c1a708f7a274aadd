"""The port's ``host_cpu`` backend against the JAX package's, on the CPU.

``repro_torch/backends/host_cpu.py`` stands the backend up through the
dispatch table alone (``register_backend`` and two ``register_impl``
tier-0 impls), as ``repro/backends/host_cpu.py`` does.  The tests hold
its hardware spec to JAX's ``HOST_CPU`` field for field, its elections
node for node to JAX ``host_cpu``'s on the small CNN, the depthwise CNN,
the MLP and the transformer, Griffin and RWKV6 blocks (the models of
``tests/test_dispatch.py`` and ``tests/test_sequence_models.py``), and
its outputs to the port's ``torch_ref`` and to JAX ``host_cpu`` on the
same numpy weights within 1e-5 (README's f32 row).  A backend bound to
the host runs there with no device given and refuses a CUDA device.
"""
import inspect
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import get_backend as j_backend
from repro.backends import registry as jreg
from repro.core import passes as jpasses
from repro.frontends import extract as jex
from repro.frontends import nn as jnn
from repro.frontends.optimize import optimize as j_optimize
from repro_torch.backends import available_backends, get_backend, registry
from repro_torch.convert import load_numpy_state_dict
from repro_torch.core import autotune as TAT
from repro_torch.core import executor as texec
from repro_torch.core import passes
from repro_torch.core.ir import OpKind
from repro_torch.frontends import extract as tex
from repro_torch.frontends import nn
from repro_torch.frontends.optimize import optimize

TOL = dict(rtol=1e-5, atol=1e-5)           # README: f32 row
CPU = dict(device="cpu")
# name: (JAX builder, port builder, input shape)
MODELS = {
    "small_cnn": (jnn.small_cnn, lambda: nn.small_cnn(**CPU),
                  (2, 3, 16, 16)),
    "depthwise_cnn": (jnn.depthwise_cnn, lambda: nn.depthwise_cnn(**CPU),
                      (2, 3, 16, 16)),
    "mlp_8192": (lambda: jnn.mlp_8192(3, 64, 32, 10),
                 lambda: nn.mlp_8192(3, 64, 32, 10, **CPU), (2, 32)),
    "transformer": (lambda: jnn.transformer_block(32, 4),
                    lambda: nn.transformer_block(32, 4, **CPU), (2, 16, 32)),
    "griffin": (lambda: jnn.griffin_block(24),
                lambda: nn.griffin_block(24, **CPU), (2, 16, 24)),
    "rwkv6": (lambda: jnn.rwkv6_block(32, 4),
              lambda: nn.rwkv6_block(32, 4, **CPU), (2, 32, 32)),
}


@pytest.fixture(autouse=True)
def _empty_port_autotune_cache():
    prev = TAT._CACHE
    TAT.set_cache(TAT.AutotuneCache())
    yield
    TAT.set_cache(prev)


def _draw(name: str, shape, rng) -> np.ndarray:
    """One parameter from the numpy generator alone, by its role: matrices
    and conv kernels at a fan-in scale, gains near 1, running variances in
    (0.5, 1.5), the recurrences' mixes, decays and bonus in the ranges the
    modules initialize them to, small biases and means."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return rng.uniform(0.5, 1.5, shape)
    if leaf == "lam" or leaf.startswith("mu_"):
        return rng.uniform(0.0, 1.0, shape)
    n = rng.standard_normal(shape)
    if len(shape) >= 2:
        fan_in = np.prod(shape[1:]) if leaf == "weight" else shape[0]
        return n / np.sqrt(fan_in)
    if leaf == "w0":
        return n * 0.3 - 2.0
    if leaf == "u":
        return n * 0.5
    if leaf in ("weight", "gn_gain"):
        return 1.0 + 0.1 * n
    return 0.1 * n                          # biases, gn_bias, running_mean


def models(name: str, seed: int = 0):
    """The same model in both packages on one numpy draw (the port's in
    ``eval()`` mode: the JAX batch norm normalizes with its running
    stats)."""
    jb, tb, shape = MODELS[name]
    jm, tm = jb(), tb().eval()
    rng = np.random.default_rng(seed)
    sd = {k: _draw(k, np.shape(v), rng).astype(np.float32)
          for k, v in sorted(jm.named_parameters().items())}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    load_numpy_state_dict(tm, sd)
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    return jm, tm, shape, x


def test_host_cpu_spec_equals_jax():
    """``HOST_CPU``'s fields are JAX's, the TPU names mapped to the port's
    (ICI → link, VMEM → a block's shared memory, the MXU tile → the mma
    tile, lanes → warp, sublanes → SMs); with no tensor cores every unit
    runs at the one peak."""
    j, t = jreg.HOST_CPU, registry.HOST_CPU
    assert (t.name, t.peak_flops_bf16, t.hbm_bandwidth, t.link_bandwidth,
            t.hbm_bytes, t.smem_bytes, t.mma_dim, t.warp, t.sms) == \
        (j.name, j.peak_flops_bf16, j.hbm_bandwidth, j.ici_bandwidth,
         j.hbm_bytes, j.vmem_bytes, j.mxu_dim, j.lanes, j.sublanes)
    assert {t.peak_flops(u) for u in registry.UNITS} == {j.peak_flops_bf16}
    assert t.roofline_s(1e9, 4e6) == j.roofline_s(1e9, 4e6)


def test_host_cpu_registered_with_own_hw():
    assert "host_cpu" in available_backends()
    bk, jb = get_backend("host_cpu"), j_backend("host_cpu")
    assert bk.hw is registry.HOST_CPU
    assert (bk.linear_weight_layout, bk.conv_layout) == \
        (jb.linear_weight_layout, jb.conv_layout) == ("oi", "nchw")
    assert "cuda" not in bk.capabilities and bk.device_type == "cpu"
    impls = {op: [i.name for i in registry._BACKEND_IMPLS[("host_cpu", op)]]
             for op in (OpKind.LINEAR, OpKind.CONV2D)}
    assert impls == {OpKind.LINEAR: ["host_cpu.linear_oi"],
                     OpKind.CONV2D: ["host_cpu.conv2d_nchw"]}
    # the paper's point: a backend is declarations on the shared table,
    # and the executor knows none of them
    assert "host_cpu" not in inspect.getsource(texec)


@pytest.mark.parametrize("name", list(MODELS))
def test_elections_equal_jax_host_cpu(name):
    """Per node, in topological order: the ops, layouts and elected impls
    of the pipeline on ``host_cpu`` equal JAX ``host_cpu``'s; every LINEAR
    and CONV2D elects its tier-0 impl and every fusion group composes."""
    jm, tm, shape, _ = models(name)
    jg = jpasses.run_pipeline(jex.extract(jm, shape), j_backend("host_cpu"))
    tg = passes.run_pipeline(tex.extract(tm, shape), get_backend("host_cpu"))
    jt, tt = jg.topo(), tg.topo()
    assert [n.op.value for n in tt] == [n.op.value for n in jt]
    assert [n.layout for n in tt] == [n.layout for n in jt]
    assert [n.impl for n in tt] == [n.impl for n in jt]
    want = {OpKind.LINEAR: "host_cpu.linear_oi",
            OpKind.CONV2D: "host_cpu.conv2d_nchw",
            OpKind.FUSED: "ref.compose"}
    for n in tt:
        if n.op in want:
            assert n.impl == want[n.op], n


def test_small_cnn_elects_both_overrides_as_jax_does():
    """``tests/test_dispatch.py``'s election check on the port."""
    _, tm, shape, _ = models("small_cnn")
    report = optimize(tm, shape, backend="host_cpu").impl_report()
    assert {"host_cpu.linear_oi", "host_cpu.conv2d_nchw",
            "ref.compose"} <= set(report)


@pytest.mark.parametrize("name", list(MODELS))
def test_outputs_equal_torch_ref_and_jax_host_cpu(name):
    jm, tm, shape, x = models(name)
    sol = optimize(tm, shape, backend="host_cpu")
    assert sol.device == torch.device("cpu")
    got = sol(torch.from_numpy(x)).numpy()
    ref = optimize(tm, shape, backend="torch_ref", device="cpu")(
        torch.from_numpy(x)).numpy()
    jax_out = np.asarray(j_optimize(jm, shape, backend="host_cpu")(x))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jax_out, **TOL)


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_host_cpu_refuses_a_cuda_device(device):
    _, tm, shape, _ = models("small_cnn")
    with pytest.raises(ValueError, match="host_cpu.*cpu device"):
        optimize(tm, shape, backend="host_cpu", device=device)


def test_linear_oi_takes_either_weight_orientation():
    """A weight stored (in, out) is read back as (out, in): both give
    x @ Wᵀ + b."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    impl = registry.get_impl("host_cpu.linear_oi")

    class _N:
        attrs = {"out_features": 5}
    want = x @ w.T + b
    for weight in (w, w.T.contiguous()):
        torch.testing.assert_close(impl.fn(_N, [x, weight, b], None), want)

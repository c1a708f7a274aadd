"""The port's architecture configs held to the JAX package's.

``repro_torch.configs`` and ``repro_torch.models.config`` are the port's
own copies of ``repro.configs`` and ``repro.models.config``: every field of
the ten full and ten reduced configs, the derived sizes, the analytic
parameter counts and the parameter tree's counts (``count_params``,
``count_active_params``) must equal JAX's.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest

from repro import configs as JC
from repro.models import backbone as JB
from repro.models import config as JMC
from repro_torch import configs as TC
from repro_torch.models import backbone as TB
from repro_torch.models import config as TMC

ARCHS = JC.ARCH_IDS


def _pair(arch: str, smoke: bool):
    if smoke:
        return JC.get_smoke(arch), TC.get_smoke(arch)
    return JC.get_config(arch), TC.get_config(arch)


def test_arch_ids_and_aliases_equal():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert TC.ALIASES == JC.ALIASES
    assert sorted(TC.all_configs()) == sorted(JC.all_configs())


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch, smoke):
    j, t = _pair(arch, smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.hd, t.vocab_padded, t.drnn) == (j.hd, j.vocab_padded, j.drnn)
    for n in range(1, 9):
        assert t.pattern_for(n) == j.pattern_for(n)
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert t.source and t.source == j.source


@pytest.mark.parametrize("arch", ARCHS)
def test_aliases_name_the_same_config(arch):
    alias = next(a for a, m in TC.ALIASES.items() if m == arch)
    assert TC.get_config(alias) == TC.get_config(arch)
    assert TC.get_smoke(alias) == TC.get_smoke(arch)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_counts_equal(arch, smoke):
    """The parameter tree's counts, read on the meta device in the port
    and from ``eval_shape`` in JAX."""
    j, t = _pair(arch, smoke)
    assert TB.count_params(t) == JB.count_params(j)
    assert TB.count_active_params(t) == JB.count_active_params(j)


def test_param_counts_match_assignment():
    """Full-size configs hit their published parameter classes (the
    counterpart of the JAX package's test)."""
    expect = {
        "stablelm_3b": (2.5e9, 3.3e9),
        "command_r_plus_104b": (100e9, 108e9),
        "qwen2_1_5b": (1.3e9, 1.8e9),
        "gemma2_9b": (8.5e9, 10.5e9),
        "recurrentgemma_9b": (8.5e9, 10.5e9),
        "kimi_k2_1t_a32b": (0.95e12, 1.1e12),
        "olmoe_1b_7b": (6.5e9, 7.3e9),
        "rwkv6_1_6b": (1.4e9, 1.8e9),
        "internvl2_26b": (18e9, 21e9),   # LM backbone (ViT is a stub)
    }
    for arch, (lo, hi) in expect.items():
        n = TB.count_params(TC.get_config(arch))
        assert lo <= n <= hi, f"{arch}: {n:,} outside [{lo:,},{hi:,}]"


def test_moe_active_params():
    assert 28e9 <= TB.count_active_params(TC.get_config("kimi_k2_1t_a32b")) \
        <= 36e9


@pytest.mark.parametrize("kw", [{}, {"n_layers": 5}, {"d_model": 64},
                                {"vocab": 300}])
def test_reduced_equals_jax(kw):
    for arch in ARCHS:
        assert dataclasses.asdict(TMC.reduced(TC.get_config(arch), **kw)) \
            == dataclasses.asdict(JMC.reduced(JC.get_config(arch), **kw))


def test_shapes_and_padding_equal():
    assert {k: dataclasses.asdict(v) for k, v in TMC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JMC.SHAPES.items()}
    for x, m in ((1, 128), (128, 128), (151936, 128), (92553, 128),
                 (51865, 16), (0, 8)):
        assert TMC.pad_to_multiple(x, m) == JMC.pad_to_multiple(x, m)

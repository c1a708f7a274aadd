"""The framework modules SOL extracts from — real ``torch.nn`` modules.

The paper built SOL for PyTorch: it extracts the graph from the framework's
own modules and injects an optimized module back, without touching the
framework's source.  So extraction (``frontends/extract.py``) keys on
``torch.nn.Linear``, ``torch.nn.LayerNorm``, ``torch.nn.GELU``,
``torch.nn.ReLU``, ``torch.nn.Dropout``, ``torch.nn.Conv2d``, the pools,
``torch.nn.BatchNorm2d``, ``torch.nn.Flatten`` and ``torch.nn.Sequential``
themselves.  The subclasses below only fix the defaults the JAX frontend
(``repro.frontends.nn``) uses, so both packages describe the same model:

* ``Linear`` stores ``weight`` as (out, in), as torch does, initialized
  N(0, 2/fan_in) with a zero bias;
* ``GELU`` is the tanh form (``jax.nn.gelu`` defaults to it; torch's
  ``GELU()`` defaults to erf);
* ``LayerNorm`` has eps 1e-5 with gain ones and bias zeros;
* ``Conv2d`` stores ``weight`` as (out, in/groups, kh, kw), as both
  frameworks do, initialized N(0, 2/fan_in) with a zero bias.

The pools and ``BatchNorm2d`` are torch's own, whose defaults are the
JAX frontend's.  The JAX batch norm always normalizes with its running
stats, so compare against the port's models in ``eval()`` mode.

``Residual``, ``GlobalAvgPool`` (torch has no module with an (N, C)
output), ``MultiHeadAttention``, ``RGLRU`` and ``RWKV6TimeMix`` are
port-owned and keep the JAX parameter names and layouts: MHA's
``wq``/``wk``/``wv``/``wo``, RG-LRU's ``wa``/``wx`` and RWKV6's
``wr``/``wk``/``wv``/``wg``/``wo`` and ``lora_a_*`` (d, r) are stored
(in, out).  Dotted ``state_dict`` names equal the JAX ``named_parameters``.
Every constructor of a module with parameters takes an explicit
``device``, and of one with random parameters a ``generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn as tnn

# torch's own defaults are the JAX frontend's: a pool's stride defaults to
# its kernel, a batch norm has eps 1e-5, gain ones, bias zeros and running
# stats 0 and 1
ReLU = tnn.ReLU
Dropout = tnn.Dropout
Flatten = tnn.Flatten
MaxPool2d = tnn.MaxPool2d
AvgPool2d = tnn.AvgPool2d
BatchNorm2d = tnn.BatchNorm2d
Sequential = tnn.Sequential


def _kaiming_(t: torch.Tensor, fan_in: int,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(generator=generator).mul_(math.sqrt(2.0 / fan_in))


class Linear(tnn.Linear):
    """``torch.nn.Linear`` initialized like the JAX frontend."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        _kaiming_(self.weight, in_features, generator)
        if bias:
            with torch.no_grad():
                self.bias.zero_()


class Conv2d(tnn.Conv2d):
    """``torch.nn.Conv2d`` with the JAX frontend's arguments and init."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, groups=groups, bias=bias,
                         device=device)
        _kaiming_(self.weight, in_ch // groups * kernel * kernel, generator)
        if bias:
            with torch.no_grad():
                self.bias.zero_()


class GlobalAvgPool(tnn.Module):
    """Mean over H and W: (N, C, H, W) → (N, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3))


class LayerNorm(tnn.LayerNorm):
    def __init__(self, dim: int, *, device=None):
        super().__init__(dim, eps=1e-5, device=device)


class GELU(tnn.GELU):
    """The tanh-form GELU, the function ``jax.nn.gelu`` computes."""

    def __init__(self):
        super().__init__(approximate="tanh")


class Residual(tnn.Sequential):
    """y = x + chain(x): extraction emits the inner chain plus an ADD."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + super().forward(x)


class MultiHeadAttention(tnn.Module):
    """Bias-free multi-head attention with GQA, sliding window and logit
    softcap.  Weights are stored (in, out), so projections extract as MATMUL
    nodes.  The eager forward runs the plain attention of
    ``kernels/flash_attention/ref.py``."""

    def __init__(self, d_model: int, n_heads: int,
                 n_kv_heads: Optional[int] = None, causal: bool = True,
                 window: int = 0, cap: float = 0.0, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by {n_heads}")
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        if n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        self.head_dim = d_model // n_heads
        self.causal, self.window, self.cap = causal, window, cap
        hd = self.head_dim

        def param(rows: int, cols: int) -> tnn.Parameter:
            t = torch.empty(rows, cols, device=device)
            return tnn.Parameter(_kaiming_(t, rows, generator))

        self.wq = param(d_model, n_heads * hd)
        self.wk = param(d_model, self.n_kv_heads * hd)
        self.wv = param(d_model, self.n_kv_heads * hd)
        self.wo = param(n_heads * hd, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..kernels.flash_attention.ref import flash_attention_ref
        b, s, _ = x.shape
        hd = self.head_dim
        q = (x @ self.wq).reshape(b, s, self.n_heads, hd)
        k = (x @ self.wk).reshape(b, s, self.n_kv_heads, hd)
        v = (x @ self.wv).reshape(b, s, self.n_kv_heads, hd)
        o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=self.causal,
                                window=self.window, cap=self.cap)
        return o.transpose(1, 2).reshape(b, s, -1) @ self.wo


def _uniform_(t: torch.Tensor, generator: Optional[torch.Generator]
              ) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(generator=generator)


def _normal_(t: torch.Tensor, std: float, mean: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(generator=generator).mul_(std).add_(mean)


class RGLRU(tnn.Module):
    """Griffin's real-gated linear recurrent unit (the recurrence only):
    h_t = a_t·h_{t-1} + b_t with input/recurrence gates over x: (B, S, D).
    The eager forward is ``models.recurrent.rglru_seq``."""

    def __init__(self, dim: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        self.wa = tnn.Parameter(_kaiming_(
            torch.empty(dim, dim, device=device), dim, generator))
        self.wx = tnn.Parameter(_kaiming_(
            torch.empty(dim, dim, device=device), dim, generator))
        # softplus(lam) ∈ ~(0.7, 1.3) → decay a well inside (0, 1)
        self.lam = tnn.Parameter(_uniform_(torch.empty(dim, device=device),
                                           generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..models.recurrent import rglru_seq
        return rglru_seq(dict(self.named_parameters()), x)[0]


class RWKV6TimeMix(tnn.Module):
    """RWKV6 (Finch) time mix: data-dependent token-shift lerp + LoRA decay
    feeding the WKV linear recurrence, per-head group norm, silu gate.  The
    eager forward is ``models.recurrent.rwkv_time_mix_seq``."""

    def __init__(self, dim: int, n_heads: int, lora_rank: int = 4, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by {n_heads} heads")
        self.dim = dim
        self.n_heads = n_heads
        self.lora_rank = lora_rank

        def u01(*shape: int) -> tnn.Parameter:
            return tnn.Parameter(_uniform_(
                torch.empty(*shape, device=device), generator))

        def nrm(std: float, *shape: int, mean: float = 0.0) -> tnn.Parameter:
            return tnn.Parameter(_normal_(
                torch.empty(*shape, device=device), std, mean, generator))

        self.mu_x = u01(dim)
        for t in ("r", "k", "v", "w", "g"):
            setattr(self, f"mu_{t}", u01(dim))
            setattr(self, f"lora_a_{t}", nrm(0.1, dim, lora_rank))
            setattr(self, f"lora_b_{t}", nrm(0.1, lora_rank, dim))
        self.w0 = nrm(0.3, dim, mean=-2.0)        # decay exp(-e^{w0}) ≈ .9
        self.u = nrm(0.5, dim)
        for t in ("r", "k", "v", "g", "o"):
            setattr(self, f"w{t}", tnn.Parameter(_kaiming_(
                torch.empty(dim, dim, device=device), dim, generator)))
        self.gn_gain = nrm(0.1, dim, mean=1.0)
        self.gn_bias = nrm(0.1, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..models.recurrent import rwkv_time_mix_seq
        return rwkv_time_mix_seq(dict(self.named_parameters()), x,
                                 self.n_heads)


def _mlp(d_model: int, mlp_mult: int, device,
         generator: Optional[torch.Generator]) -> Residual:
    """Pre-norm MLP: LayerNorm → Linear → tanh-GELU → Linear, residual."""
    return Residual(LayerNorm(d_model, device=device),
                    Linear(d_model, mlp_mult * d_model, device=device,
                           generator=generator),
                    GELU(),
                    Linear(mlp_mult * d_model, d_model, device=device,
                           generator=generator))


def transformer_block(d_model: int = 64, n_heads: int = 4,
                      n_kv_heads: Optional[int] = None, mlp_mult: int = 4,
                      causal: bool = True, *, device=None,
                      generator: Optional[torch.Generator] = None
                      ) -> tnn.Sequential:
    """Pre-norm transformer block: attention + MLP, both residual."""
    return tnn.Sequential(
        Residual(LayerNorm(d_model, device=device),
                 MultiHeadAttention(d_model, n_heads, n_kv_heads,
                                    causal=causal, device=device,
                                    generator=generator)),
        _mlp(d_model, mlp_mult, device, generator),
    )


def griffin_block(d_model: int = 64, mlp_mult: int = 2, *, device=None,
                  generator: Optional[torch.Generator] = None
                  ) -> tnn.Sequential:
    """RecurrentGemma/Griffin-style block: RG-LRU recurrence + MLP, both
    residual."""
    return tnn.Sequential(
        Residual(LayerNorm(d_model, device=device),
                 RGLRU(d_model, device=device, generator=generator)),
        _mlp(d_model, mlp_mult, device, generator),
    )


def rwkv6_block(d_model: int = 64, n_heads: int = 4, mlp_mult: int = 2, *,
                device=None, generator: Optional[torch.Generator] = None
                ) -> tnn.Sequential:
    """RWKV6 (Finch) block: time mix + MLP, both residual."""
    return tnn.Sequential(
        Residual(LayerNorm(d_model, device=device),
                 RWKV6TimeMix(d_model, n_heads, device=device,
                              generator=generator)),
        _mlp(d_model, mlp_mult, device, generator),
    )


# -- the paper's MLP and CNNs ------------------------------------------------

def mlp_8192(n_layers: int = 3, features: int = 8192,
             in_features: int = 8192, classes: int = 1000, *, device=None,
             generator: Optional[torch.Generator] = None) -> tnn.Sequential:
    """The paper's MLP: 3 layers, 8192 features, ReLU."""
    mods = []
    d = in_features
    for _ in range(n_layers - 1):
        mods += [Linear(d, features, device=device, generator=generator),
                 ReLU()]
        d = features
    mods.append(Linear(d, classes, device=device, generator=generator))
    return tnn.Sequential(*mods)


def small_cnn(in_ch: int = 3, classes: int = 10, *, device=None,
              generator: Optional[torch.Generator] = None) -> tnn.Sequential:
    """VGG-flavoured small CNN (conv-relu-pool blocks → MLP head)."""
    kw = dict(device=device, generator=generator)
    return tnn.Sequential(
        Conv2d(in_ch, 32, 3, padding=1, **kw), ReLU(), MaxPool2d(2),
        Conv2d(32, 64, 3, padding=1, **kw), ReLU(), MaxPool2d(2),
        Conv2d(64, 128, 3, padding=1, **kw), BatchNorm2d(128, device=device),
        ReLU(), GlobalAvgPool(), Flatten(),
        Linear(128, 256, **kw), ReLU(), Dropout(0.1),
        Linear(256, classes, **kw),
    )


def depthwise_cnn(in_ch: int = 3, classes: int = 10, *, device=None,
                  generator: Optional[torch.Generator] = None
                  ) -> tnn.Sequential:
    """MobileNet-flavoured: depthwise convs (groups == channels) — the
    paper's special case that routes to the DFP module as WeightedPooling."""
    kw = dict(device=device, generator=generator)
    return tnn.Sequential(
        Conv2d(in_ch, 32, 3, padding=1, **kw), ReLU(),
        Conv2d(32, 32, 3, padding=1, groups=32, bias=False, **kw),
        Conv2d(32, 64, 1, **kw), ReLU(), MaxPool2d(2),
        Conv2d(64, 64, 3, padding=1, groups=64, bias=False, **kw),
        Conv2d(64, 128, 1, **kw), ReLU(),
        GlobalAvgPool(), Flatten(), Linear(128, classes, **kw),
    )

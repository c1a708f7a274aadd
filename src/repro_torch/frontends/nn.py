"""The framework modules SOL extracts from — real ``torch.nn`` modules.

The paper built SOL for PyTorch: it extracts the graph from the framework's
own modules and injects an optimized module back, without touching the
framework's source.  So extraction (``frontends/extract.py``) keys on
``torch.nn.Linear``, ``torch.nn.LayerNorm``, ``torch.nn.GELU``,
``torch.nn.ReLU``, ``torch.nn.Dropout`` and ``torch.nn.Sequential``
themselves.  The subclasses below only fix the defaults the JAX frontend
(``repro.frontends.nn``) uses, so both packages describe the same model:

* ``Linear`` stores ``weight`` as (out, in), as torch does, initialized
  N(0, 2/fan_in) with a zero bias;
* ``GELU`` is the tanh form (``jax.nn.gelu`` defaults to it; torch's
  ``GELU()`` defaults to erf);
* ``LayerNorm`` has eps 1e-5 with gain ones and bias zeros.

``Residual`` and ``MultiHeadAttention`` are port-owned and keep the JAX
parameter names and layouts: MHA's ``wq``/``wk``/``wv``/``wo`` are stored
(in, out).  Dotted ``state_dict`` names equal the JAX ``named_parameters``.
Every constructor takes an explicit ``device`` and ``generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn as tnn

ReLU = tnn.ReLU
Dropout = tnn.Dropout
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
        Residual(LayerNorm(d_model, device=device),
                 Linear(d_model, mlp_mult * d_model, device=device,
                        generator=generator),
                 GELU(),
                 Linear(mlp_mult * d_model, d_model, device=device,
                        generator=generator)),
    )

"""Architecture configuration (counterpart of ``repro.models.config``; the
port keeps its own copy, field for field).

One ``ArchConfig`` instance per assigned architecture lives in
``repro_torch.configs.<id>``; ``reduced()`` derives the CPU smoke-test
version.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_dense_layers: int = 0       # leading dense layers (Kimi K2 style)
    d_ff_dense: int = 0           # FFN dim of those dense layers
    capacity_factor: float = 1.25
    group_size: int = 1024        # token group for dispatch


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    enc_seq: int                  # encoder sequence length (frames/patches)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 → d_model // n_heads
    # repeating block pattern; kinds: attn | local | rglru | rwkv
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0               # local-attention window
    softcap_attn: float = 0.0     # gemma2 attn logit softcap
    softcap_final: float = 0.0    # gemma2 final logit softcap
    qkv_bias: bool = False
    attn_out_bias: bool = False
    moe: Optional[MoEConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    frontend: str = ""            # '' | 'audio' | 'vision'  (stub embeddings)
    n_patches: int = 0            # vision stub patch count
    ffn: str = "swiglu"           # swiglu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    parallel_block: bool = False  # command-r: attn & FFN in parallel
    post_norms: bool = False      # gemma2: norm after attn/ffn too
    tie_embeddings: bool = False
    d_rnn: int = 0                # RG-LRU recurrence width (0 → d_model)
    rwkv_head_dim: int = 64
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # long-context capability: True only for sub-quadratic (SSM/hybrid/linear)
    subquadratic: bool = False
    vocab_pad_multiple: int = 128
    source: str = ""              # provenance tag from the assignment table

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return pad_to_multiple(self.vocab, self.vocab_pad_multiple)

    @property
    def drnn(self) -> int:
        return self.d_rnn or self.d_model

    def pattern_for(self, n_layers: int) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """(macro pattern repeated n_macro times, tail kinds)."""
        p = len(self.layer_pattern)
        n_macro = n_layers // p
        tail = n_layers - n_macro * p
        return self.layer_pattern, tuple(self.layer_pattern[:tail])

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline."""
        D, V = self.d_model, self.vocab_padded
        total = V * D                       # embed
        if not self.tie_embeddings:
            total += V * D                  # lm head
        kinds = [self.layer_pattern[i % len(self.layer_pattern)]
                 for i in range(self.n_layers)]
        for li, kind in enumerate(kinds):
            total += self._block_params(kind, li)
        if self.enc_dec is not None:
            for _ in range(self.enc_dec.n_enc_layers):
                total += self._block_params("attn", -1, enc=True)
        total += D                          # final norm
        return total

    def _block_params(self, kind: str, li: int, enc: bool = False) -> int:
        D, H, KV, hd = self.d_model, self.n_heads, self.n_kv, self.hd
        n = 2 * D if self.norm == "layernorm" else D   # pre-norm
        if self.post_norms:
            n *= 2
        n *= 2 if not self.parallel_block else 1        # attn norm + ffn norm
        p = n
        if kind in ("attn", "local"):
            p += D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
            if self.qkv_bias:
                p += H * hd + 2 * KV * hd
            if enc or (self.enc_dec is not None and not enc):
                pass
        elif kind == "rglru":
            dr = self.drnn
            p += 2 * D * dr + dr * D + 4 * dr + 3 * dr  # in/gate/out + conv4 + lru
        elif kind == "rwkv":
            p += 4 * D * D + D * D          # r,k,v,g,out
            p += 6 * (D * 64 + 64 * D)      # data-dependent lerp LoRAs (approx)
        if self.enc_dec is not None and not enc and kind in ("attn", "local"):
            # cross-attention in decoder blocks
            p += D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D + n // 2
        # FFN
        if self.moe is not None and li >= self.moe.n_dense_layers and \
                kind not in ("rglru", "rwkv"):
            p += self.moe.n_experts * 3 * D * self.moe.d_expert + \
                D * self.moe.n_experts
        elif kind == "rwkv":
            p += 2 * D * self.d_ff          # rwkv channel-mix (k, v)
        else:
            dff = self.d_ff if not (self.moe and li < self.moe.n_dense_layers) \
                else (self.moe.d_ff_dense or self.d_ff)
            mult = 3 if self.ffn == "swiglu" else 2
            p += mult * D * dff
        return p

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.n_params()
        total = self.n_params()
        dead = (self.moe.n_experts - self.moe.top_k) * 3 * self.d_model * \
            self.moe.d_expert
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if i >= self.moe.n_dense_layers and
            self.layer_pattern[i % len(self.layer_pattern)] not in
            ("rglru", "rwkv"))
        return total - dead * n_moe_layers


def reduced(cfg: ArchConfig, *, n_layers: int = 0, d_model: int = 128,
            vocab: int = 512) -> ArchConfig:
    """Smoke-test shrink of the same family: tiny widths, few experts,
    tiny vocab, same block pattern (one full period + tail coverage)."""
    p = len(cfg.layer_pattern)
    nl = n_layers or (p + min(2, p))      # ≥ one full period + partial tail
    h = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv, h))
    hd = max(8, d_model // h)
    moe = None
    if cfg.moe is not None:
        # capacity_factor = n_experts/top_k → capacity == group size: no
        # token is ever dropped, so decode ≡ forward exactly (capacity
        # drops depend on group partitioning and would make the smoke
        # decode-consistency check routing-luck-dependent)
        moe = MoEConfig(n_experts=8, top_k=2, d_expert=64,
                        n_dense_layers=min(cfg.moe.n_dense_layers, 1),
                        d_ff_dense=128 if cfg.moe.d_ff_dense else 0,
                        capacity_factor=4.0, group_size=64)
    enc_dec = None
    if cfg.enc_dec is not None:
        enc_dec = EncDecConfig(n_enc_layers=2, enc_seq=16)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=nl, d_model=d_model,
        n_heads=h, n_kv=kv, head_dim=hd, d_ff=4 * d_model, vocab=vocab,
        window=min(cfg.window, 32) if cfg.window else 0,
        moe=moe, enc_dec=enc_dec, d_rnn=d_model if cfg.d_rnn else 0,
        n_patches=8 if cfg.n_patches else 0,
        dtype="float32", vocab_pad_multiple=16)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

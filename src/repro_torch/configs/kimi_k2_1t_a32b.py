"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE (paper-table).
Layer 0 is dense (K2 style); d_ff=2048 is the per-expert hidden dim.
[arXiv:2501.kimi2; unverified]"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv=8,
    d_ff=2048,                         # per-expert FFN hidden dim
    vocab=163840,
    head_dim=128,
    layer_pattern=("attn",),
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                  n_dense_layers=1, d_ff_dense=18432,
                  capacity_factor=1.25, group_size=1024),
    ffn="swiglu",
    norm="rmsnorm",
    rope_theta=50000.0,
    subquadratic=False,
    source="arXiv:2501.kimi2; unverified",
)

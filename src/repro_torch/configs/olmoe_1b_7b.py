"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8.  [arXiv:2409.02060; hf]"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,                         # per-expert FFN hidden dim
    vocab=50304,
    head_dim=128,
    layer_pattern=("attn",),
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024,
                  n_dense_layers=0, capacity_factor=1.25, group_size=1024),
    ffn="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    subquadratic=False,
    source="arXiv:2409.02060; hf",
)

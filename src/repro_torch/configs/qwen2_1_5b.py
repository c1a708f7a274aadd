"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias.  [arXiv:2407.10671; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    layer_pattern=("attn",),
    ffn="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    subquadratic=False,
    source="arXiv:2407.10671; hf",
)

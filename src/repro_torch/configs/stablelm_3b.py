"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_ff=6912,
    vocab=50304,
    head_dim=80,
    layer_pattern=("attn",),
    ffn="swiglu",
    norm="layernorm",
    qkv_bias=False,
    rope_theta=10000.0,
    subquadratic=False,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)

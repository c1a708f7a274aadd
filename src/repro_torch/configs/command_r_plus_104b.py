"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, parallel attn+FFN blocks.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
    layer_pattern=("attn",),
    ffn="swiglu",
    norm="layernorm",
    parallel_block=True,     # Cohere-style parallel attention/FFN
    qkv_bias=False,
    tie_embeddings=True,     # Command-R ties input/output embeddings
    rope_theta=75000.0,
    subquadratic=False,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)

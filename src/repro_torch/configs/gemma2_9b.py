"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    layer_pattern=("local", "attn"),   # alternating local/global (1:1)
    window=4096,
    softcap_attn=50.0,
    softcap_final=30.0,
    post_norms=True,                   # gemma2 post-layernorms
    ffn="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=10000.0,
    subquadratic=False,                # global layers are full attention
    source="arXiv:2408.00118; hf",
)

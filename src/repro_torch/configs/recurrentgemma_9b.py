"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1)
d_ff=12288 vocab=256000 — RG-LRU + local attn, 1:2 (Griffin).
[arXiv:2402.19427; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,                            # MQA in Griffin's local attention
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    layer_pattern=("rglru", "rglru", "local"),  # 2 recurrent : 1 local attn
    window=2048,
    d_rnn=4096,
    ffn="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=10000.0,
    subquadratic=True,                 # O(1) state + bounded window
    source="arXiv:2402.19427; unverified",
)

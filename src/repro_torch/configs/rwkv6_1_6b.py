"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 —
Finch, data-dependent decay.  [arXiv:2404.05892; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                        # 2048 / rwkv_head_dim(64)
    n_kv=32,
    d_ff=7168,                         # channel-mix hidden dim
    vocab=65536,
    layer_pattern=("rwkv",),
    rwkv_head_dim=64,
    norm="layernorm",
    subquadratic=True,                 # attention-free, O(1) state
    source="arXiv:2404.05892; unverified",
)

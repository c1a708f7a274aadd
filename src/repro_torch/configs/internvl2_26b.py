"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT frontend (STUB: input_specs supplies precomputed
patch embeddings) + InternLM2 backbone.  [arXiv:2404.16821; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=16384,
    vocab=92553,                       # padded to 92672 (model axis 16 | 128)
    head_dim=128,
    layer_pattern=("attn",),
    frontend="vision",
    n_patches=256,
    ffn="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    subquadratic=False,
    source="arXiv:2404.16821; hf",
)

"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
enc-dec, conv frontend (STUB: input_specs supplies precomputed frame
embeddings).  [arXiv:2212.04356; unverified]"""
from ..models.config import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                        # decoder layers
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    layer_pattern=("attn",),
    enc_dec=EncDecConfig(n_enc_layers=4, enc_seq=1500),
    frontend="audio",
    ffn="gelu",
    norm="layernorm",
    rope_theta=10000.0,
    subquadratic=False,
    source="arXiv:2212.04356; unverified",
)

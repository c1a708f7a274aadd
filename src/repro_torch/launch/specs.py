"""Input stand-ins for every (arch × shape) cell (counterpart of
``repro.launch.specs``): meta tensors where JAX has ``ShapeDtypeStruct``s,
so nothing is allocated.  The modality frontends are stubs: the audio and
vision entries take precomputed frame and patch embeddings as inputs.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models import backbone as B
from ..models.config import ArchConfig, ShapeConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    gb, s = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if cfg.frontend == "vision":
        batch["tokens"] = _meta((gb, s - cfg.n_patches), torch.int32)
        batch["patches"] = _meta((gb, cfg.n_patches, cfg.d_model),
                                 torch.bfloat16)
        batch["labels"] = _meta((gb, s - cfg.n_patches), torch.int32)
    else:
        batch["tokens"] = _meta((gb, s), torch.int32)
        batch["labels"] = _meta((gb, s), torch.int32)
    if cfg.frontend == "audio":
        batch["frames"] = _meta((gb, cfg.enc_dec.enc_seq, cfg.d_model),
                                torch.bfloat16)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    b = train_batch_specs(cfg, shape)
    b.pop("labels", None)
    return b


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig):
    """(cache, tokens, pos, enc_out or None), on the meta device."""
    gb, s = shape.global_batch, shape.seq_len
    cache = B.cache_specs(cfg, gb, s)
    tokens = _meta((gb, 1), torch.int32)
    pos = _meta((), torch.int32)
    enc_out = None
    if cfg.enc_dec is not None:
        enc_out = _meta((gb, cfg.enc_dec.enc_seq, cfg.d_model),
                        torch.bfloat16)
    return cache, tokens, pos, enc_out


def input_specs(cfg: ArchConfig, shape: ShapeConfig):
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    cache, tokens, pos, enc_out = decode_input_specs(cfg, shape)
    out = {"cache": cache, "tokens": tokens, "pos": pos}
    if enc_out is not None:
        out["enc_out"] = enc_out
    return out


def cell_is_applicable(cfg: ArchConfig, shape: ShapeConfig
                       ) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic attention (the assignment's
    rule)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure/global full-attention architecture — "
                       "524k-token dense decode is not sub-quadratic")
    return True, ""

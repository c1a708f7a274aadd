"""Carry parameters from the JAX package into the port's modules.

The JAX frontend's ``named_parameters()`` and the port's ``state_dict()``
use the same dotted names and layouts (Linear weights (out, in), Conv2d
weights (out, in/groups, kh, kw), BatchNorm2d running stats; attention,
RG-LRU and RWKV6 projections and LoRA factors (in, out)), so a checkpoint
moves over name for name.  The caller turns the JAX arrays into numpy
first (``np.asarray``); this module imports neither JAX nor the JAX
package.

The backbone's trees (``models.backbone``) move over leaf for leaf: the
JAX ``init_params`` and ``init_cache`` trees, and its train state
(``{"params", "opt": {"m", "v", "step"}, "step"}``), as numpy arrays
(bfloat16 leaves as float32), become the port's trees of tensors in the
leaves' own dtypes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn as tnn


def load_numpy_state_dict(model: tnn.Module,
                          sd: Dict[str, np.ndarray]) -> tnn.Module:
    """Copy ``{dotted name: array}`` into ``model``'s parameters and buffers
    in place, on their device and in their dtype.  Every name must exist on
    both sides with the same shape, except a batch norm's
    ``num_batches_tracked``, which the JAX modules lack."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    # torch's batch norms count their training steps in a buffer the JAX
    # modules do not have; it is no weight, so it is left as it is
    for prefix, mod in model.named_modules():
        if isinstance(mod, tnn.modules.batchnorm._BatchNorm):
            own.pop(f"{prefix}.num_batches_tracked" if prefix
                    else "num_batches_tracked", None)
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, arr in sd.items():
            dst = own[name]
            src = torch.tensor(np.asarray(arr))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src.to(dtype=dst.dtype))
    return model


def _tree_from_numpy(want, got, device, dtype, path: str):
    """``got`` (numpy leaves) as tensors shaped and typed like ``want``
    (meta tensors), key for key."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise KeyError(f"{path or 'tree'}: a dict wanted, got "
                           f"{type(got).__name__}")
        missing = sorted(set(want) - set(got))
        unexpected = sorted(set(got) - set(want))
        if missing or unexpected:
            raise KeyError(f"{path or 'tree'}: missing {missing}, "
                           f"unexpected {unexpected}")
        return {k: _tree_from_numpy(want[k], got[k], device, dtype,
                                    f"{path}/{k}") for k in want}
    if isinstance(want, (tuple, list)):
        if not isinstance(got, (tuple, list)) or len(got) != len(want):
            raise KeyError(f"{path}: {len(want)} leaves wanted")
        return type(want)(_tree_from_numpy(w, g, device, dtype,
                                           f"{path}/{i}")
                          for i, (w, g) in enumerate(zip(want, got)))
    src = torch.tensor(np.asarray(got))
    if tuple(src.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(src.shape)} != "
                         f"{tuple(want.shape)}")
    return src.to(device=device, dtype=dtype or want.dtype)


def backbone_params_from_numpy(cfg, tree: Dict[str, Any], device=None,
                               dtype=None) -> Dict[str, Any]:
    """The JAX backbone's parameter tree for ``cfg`` (numpy leaves) as the
    port's, on ``device`` (the card unless asked otherwise), each leaf in
    its own dtype (``cfg.dtype``; the router, ``u`` and ``lam`` f32) or
    ``dtype``.  A missing or extra key, or another shape, raises."""
    from .frontends.offload import resolve_device
    from .models.backbone import param_shapes
    return _tree_from_numpy(param_shapes(cfg), tree, resolve_device(device),
                            dtype, "")


def backbone_cache_from_numpy(cfg, tree: Dict[str, Any], batch: int,
                              max_seq: int, device=None) -> Dict[str, Any]:
    """The JAX backbone's decode cache (``init_cache(cfg, batch,
    max_seq)``, numpy leaves) as the port's, on ``device``."""
    from .frontends.offload import resolve_device
    from .models.backbone import init_cache
    return _tree_from_numpy(init_cache(cfg, batch, max_seq, device="meta"),
                            tree, resolve_device(device), None, "")


def train_state_from_numpy(cfg, tree: Dict[str, Any], device=None, *,
                           moment_dtype: str = "float32") -> Dict[str, Any]:
    """The JAX backbone's train state for ``cfg`` (``init_train_state``'s
    tree, numpy leaves) as the port's, on ``device``: parameters in their
    own dtypes, moments in ``moment_dtype``, the step counts int32."""
    from .frontends.offload import resolve_device
    from .models.backbone import param_shapes, tree_map
    shapes = param_shapes(cfg)
    mdt = getattr(torch, moment_dtype)
    moments = tree_map(lambda x: x.to(mdt), shapes)
    step = torch.empty((), dtype=torch.int32, device="meta")
    want = {"params": shapes,
            "opt": {"m": moments, "v": moments, "step": step},
            "step": step}
    return _tree_from_numpy(want, tree, resolve_device(device), None, "")

"""Assigned architecture configs (counterpart of ``repro.configs``; the
port keeps its own copies, field for field, each with its ``source``).

``get_config(name)`` returns the exact full-size ArchConfig;
``get_smoke(name)`` the reduced same-family smoke config.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ArchConfig, reduced

ARCH_IDS: List[str] = [
    "stablelm_3b",
    "command_r_plus_104b",
    "qwen2_1_5b",
    "gemma2_9b",
    "recurrentgemma_9b",
    "whisper_tiny",
    "kimi_k2_1t_a32b",
    "olmoe_1b_7b",
    "rwkv6_1_6b",
    "internvl2_26b",
]

# assignment-sheet id -> module name
ALIASES = {
    "stablelm-3b": "stablelm_3b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma2-9b": "gemma2_9b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-tiny": "whisper_tiny",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "internvl2-26b": "internvl2_26b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def get_smoke(name: str) -> ArchConfig:
    return reduced(get_config(name))


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}

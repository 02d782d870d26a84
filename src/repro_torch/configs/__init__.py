"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    GwasWorkloadConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SHAPES,
    supported_shapes,
)

_MODULES = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-small": "whisper_small",
    "rwkv6-3b": "rwkv6_3b",
    "gemma-7b": "gemma_7b",
    "gemma2-9b": "gemma2_9b",
    "qwen1.5-32b": "qwen15_32b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "arctic-480b": "arctic_480b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "gwas_ukb": "gwas_ukb",
}

LM_ARCHS = tuple(a for a in _MODULES if a != "gwas_ukb")


def list_archs() -> tuple[str, ...]:
    return tuple(_MODULES)


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {', '.join(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


__all__ = [
    "GwasWorkloadConfig",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "SHAPES",
    "supported_shapes",
    "get_config",
    "list_archs",
    "LM_ARCHS",
]

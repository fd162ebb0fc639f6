"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Arch ids are the JAX package's (``repro.configs``), all of them ported; an
unknown id raises ``KeyError`` as the JAX package does.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, FLConfig, InputShape, ModelConfig

_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen2-7b": "qwen2_7b",
    "granite-34b": "granite_34b",
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "fmnist-logreg": "fmnist_logreg",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_reduced(arch: str):
    return _module(arch).reduced()


__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES", "FLConfig",
           "get_config", "get_reduced"]

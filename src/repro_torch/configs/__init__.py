"""Configurations: the MSP brain's (``BrainConfig``) and the LM stack's
architecture registry (``--arch <id>`` resolves here), the port's copy of
the JAX package's ``repro.configs``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, ParallelConfig,
                                      ShapeConfig, SHAPES, applicable_shapes,
                                      supports_long_context)
from repro_torch.configs.msp_brain import CONFIG, SMOKE_CONFIG, BrainConfig

# arch id -> module name
_ARCH_MODULES = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "arctic-480b":         "arctic_480b",
    "qwen2-7b":            "qwen2_7b",
    "starcoder2-15b":      "starcoder2_15b",
    "qwen3-14b":           "qwen3_14b",
    "chatglm3-6b":         "chatglm3_6b",
    "whisper-base":        "whisper_base",
    "llava-next-34b":      "llava_next_34b",
    "xlstm-125m":          "xlstm_125m",
    "recurrentgemma-2b":   "recurrentgemma_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ARCH_IDS", "BrainConfig", "CONFIG", "ModelConfig",
           "ParallelConfig", "SHAPES", "SMOKE_CONFIG", "ShapeConfig",
           "applicable_shapes", "get_config", "get_shape",
           "get_smoke_config", "supports_long_context"]

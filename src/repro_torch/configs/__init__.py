"""Architecture config registry: ``get_config("gemma2-2b")``.

Holds the architectures the port runs so far."""
from __future__ import annotations

from repro_torch.configs.base import (
    SHAPES,
    EncoderConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    RWKVConfig,
    ShapeConfig,
    SSMConfig,
    input_specs,
)
from repro_torch.configs.arctic_480b import CONFIG as _arctic_480b
from repro_torch.configs.deepseek_67b import CONFIG as _deepseek_67b
from repro_torch.configs.deepseek_7b import CONFIG as _deepseek_7b
from repro_torch.configs.deepseek_v2_lite import CONFIG as _deepseek_v2_lite
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2_2b
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen2_5_32b
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl_2b
from repro_torch.configs.rwkv6_1p6b import CONFIG as _rwkv6_1p6b
from repro_torch.configs.whisper_base import CONFIG as _whisper_base
from repro_torch.configs.zamba2_2p7b import CONFIG as _zamba2_2p7b

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in [
    _gemma2_2b, _rwkv6_1p6b, _zamba2_2p7b, _deepseek_7b, _qwen2_5_32b,
    _deepseek_67b, _deepseek_v2_lite, _qwen2_vl_2b, _arctic_480b,
    _whisper_base]}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key in REGISTRY:
        return REGISTRY[key]
    hits = [k for k in REGISTRY if k.startswith(key)]
    if len(hits) == 1:
        return REGISTRY[hits[0]]
    raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")


__all__ = [
    "ARCH_IDS", "REGISTRY", "get_config", "input_specs", "SHAPES",
    "ShapeConfig", "ModelConfig", "RunConfig", "MLAConfig", "MoEConfig",
    "SSMConfig", "RWKVConfig", "EncoderConfig",
]

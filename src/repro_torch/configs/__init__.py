"""Architecture registry: arch id -> ArchConfig (FULL and SMOKE).

All ten ids of the JAX package are listed; the dense family (starcoder2-7b,
granite-3-2b, olmo-1b, deepseek-67b) and rwkv6-7b are ported."""

from __future__ import annotations

from . import deepseek_67b, granite_3_2b, olmo_1b, rwkv6_7b, starcoder2_7b
from .base import ArchConfig, LM_SHAPES, ShapeCfg, get_shape, shape_supported  # noqa: F401

ARCH_IDS = (
    "qwen2-vl-7b",
    "granite-3-2b",
    "starcoder2-7b",
    "olmo-1b",
    "deepseek-67b",
    "qwen3-moe-30b-a3b",
    "arctic-480b",
    "seamless-m4t-medium",
    "hymba-1.5b",
    "rwkv6-7b",
)

_MODULES = {
    "granite-3-2b": granite_3_2b,
    "starcoder2-7b": starcoder2_7b,
    "olmo-1b": olmo_1b,
    "deepseek-67b": deepseek_67b,
    "rwkv6-7b": rwkv6_7b,
}


def get_arch(arch_id: str, *, smoke: bool = False) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported; ported: {tuple(_MODULES)}")
    mod = _MODULES[arch_id]
    return mod.SMOKE if smoke else mod.FULL

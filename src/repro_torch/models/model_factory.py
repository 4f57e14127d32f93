"""Family dispatch: one entry point per lifecycle stage.

Every entry point runs where the parameters lie: ``init_params`` puts them
on ``device`` (the card unless the caller asks for the CPU)."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from . import transformer


def _no_enc_dec(cfg: ArchConfig) -> None:
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder family is not yet ported")


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda"):
    """Parameters on ``device``, drawn from ``generator``, which must lie on
    that device's type."""
    _no_enc_dec(cfg)
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, parameters asked on {device}")
    return transformer.init_lm(cfg, generator)


def forward(params, cfg: ArchConfig, batch: Dict, *, wkv_engine: str = "auto",
            attn_engine: str = "auto"):
    """Prefill forward -> (logits, aux)."""
    _no_enc_dec(cfg)
    return transformer.lm_forward(params, cfg, batch, wkv_engine=wkv_engine,
                                  attn_engine=attn_engine)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, *, dtype=None, device="cuda"):
    _no_enc_dec(cfg)
    return transformer.init_cache(cfg, batch, s_max, dtype=dtype, device=device)


def decode_step(params, cfg: ArchConfig, cache: Dict, tokens):
    """One token of autoregressive decode -> (logits, cache)."""
    _no_enc_dec(cfg)
    return transformer.lm_decode_step(params, cfg, cache, tokens)

"""Decoder-only LM assembly: the attention-free (RWKV6) family.

Parameters are plain dictionaries of tensors with the layers as a list, one
dictionary a layer (the reference stacks them on a leading axis for
``jax.lax.scan``; here a Python loop runs them).  Any config that is not
``attn_free`` raises: the attention, MoE, hybrid and encoder-decoder
families are not yet ported.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from . import layers, rwkv6

F32 = torch.float32


def _require_attn_free(cfg: ArchConfig) -> None:
    if not cfg.attn_free:
        raise NotImplementedError(
            f"{cfg.name}: only the attention-free (RWKV6) family is ported; the "
            f"{cfg.family} family is not yet ported")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig):
    d, dt, dev = cfg.d_model, cfg.dtype, gen.device
    return {"norm1": layers.init_norm(d, cfg.norm, dt, dev),
            "norm2": layers.init_norm(d, cfg.norm, dt, dev),
            "rwkv": rwkv6.init_rwkv_block(gen, d, cfg.d_ff, cfg.head_dim, dt)}


def init_lm(cfg: ArchConfig, gen: torch.Generator):
    _require_attn_free(cfg)
    return {
        "tok": layers.init_embed(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype,
                                 cfg.tie_embeddings),
        "layers": [_init_block(gen, cfg) for _ in range(cfg.n_layers)],
        "norm_f": layers.init_norm(cfg.d_model, cfg.norm, cfg.dtype, gen.device),
    }


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _block_forward(bp, x, cfg: ArchConfig, wkv_engine: str):
    """One block, full sequence."""
    h = layers.apply_norm(bp["norm1"], x, cfg.norm)
    x_prev0 = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype, device=x.device)
    o, _, _ = rwkv6.time_mix(bp["rwkv"]["tmix"], h, x_prev0, None, cfg.head_dim,
                             engine=wkv_engine)
    x = x + o
    h2 = layers.apply_norm(bp["norm2"], x, cfg.norm)
    o2, _ = rwkv6.channel_mix(bp["rwkv"]["cmix"], h2, x_prev0)
    return x + o2


def lm_forward(params, cfg: ArchConfig, batch: Dict, *, wkv_engine: str = "auto"):
    """batch: tokens (B, S).  Returns (logits (B, S, padded vocab), aux)."""
    _require_attn_free(cfg)
    tokens = batch["tokens"]
    x = layers.embed_tokens(params["tok"], tokens).to(cfg.dtype)
    for bp in params["layers"]:
        x = _block_forward(bp, x, cfg, wkv_engine)
    x = layers.apply_norm(params["norm_f"], x, cfg.norm)
    logits = layers.lm_logits(params["tok"], x, cfg.tie_embeddings)
    return logits, {"lb_loss": torch.zeros((), dtype=F32, device=x.device)}


# ---------------------------------------------------------------------------
# decode (single token against a cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=None, device="cuda"):
    """Zeroed cache: the token-shift inputs and the WKV state of every layer
    on a leading (L,) axis, as in the reference; ``s_max`` is unused by the
    attention-free family."""
    _require_attn_free(cfg)
    dtype = dtype or cfg.dtype
    L, B, H = cfg.n_layers, batch, cfg.d_model // cfg.head_dim
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "att_xprev": torch.zeros((L, B, cfg.d_model), dtype=dtype, device=device),
        "ffn_xprev": torch.zeros((L, B, cfg.d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((L, B, H, cfg.head_dim, cfg.head_dim), dtype=F32, device=device),
    }


def lm_decode_step(params, cfg: ArchConfig, cache: Dict, tokens):
    """tokens: (B,) integers, one new token a sequence.
    Returns (logits (B, padded vocab), new cache)."""
    _require_attn_free(cfg)
    x = layers.embed_tokens(params["tok"], tokens)[:, None, :].to(cfg.dtype)
    axps, fxps, wkvs = [], [], []
    for i, bp in enumerate(params["layers"]):
        h = layers.apply_norm(bp["norm1"], x[:, 0], cfg.norm)
        o, axp, wkv = rwkv6.time_mix_decode(bp["rwkv"]["tmix"], h, cache["att_xprev"][i],
                                            cache["wkv"][i], cfg.head_dim)
        x = x + o[:, None]
        h2 = layers.apply_norm(bp["norm2"], x[:, 0], cfg.norm)
        o2, fxp = rwkv6.channel_mix_decode(bp["rwkv"]["cmix"], h2, cache["ffn_xprev"][i])
        x = x + o2[:, None]
        axps.append(axp.to(cache["att_xprev"].dtype))
        fxps.append(fxp.to(cache["ffn_xprev"].dtype))
        wkvs.append(wkv)
    new_cache = dict(cache, att_xprev=torch.stack(axps), ffn_xprev=torch.stack(fxps),
                     wkv=torch.stack(wkvs), pos=cache["pos"] + 1)
    x = layers.apply_norm(params["norm_f"], x[:, 0], cfg.norm)
    return layers.lm_logits(params["tok"], x, cfg.tie_embeddings), new_cache

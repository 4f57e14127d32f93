"""Decoder-only LM assembly: the dense (GQA attention + MLP) family and the
attention-free (RWKV6) family.

Parameters are plain dictionaries of tensors with the layers as a list, one
dictionary a layer (the reference stacks them on a leading axis for
``jax.lax.scan``; here a Python loop runs them).  The MoE, VLM, hybrid and
encoder-decoder (audio) families are not yet ported and raise.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from . import attention as attn
from . import layers, rwkv6

F32 = torch.float32


def _require_ported(cfg: ArchConfig) -> None:
    """Raise for the families (and the features of theirs) not yet ported."""
    missing = [what for what, used in (
        ("MoE", cfg.moe is not None), ("the hybrid SSM branch", cfg.hybrid is not None),
        ("M-RoPE", cfg.mrope_sections is not None), ("qk-norm", cfg.qk_norm),
        ("the encoder-decoder", cfg.enc_dec)) if used]
    if missing or not (cfg.attn_free or cfg.family == "dense"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family"
            + (f" ({', '.join(missing)})" if missing else "")
            + " is not yet ported; ported: the dense and the attention-free (RWKV6) families")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig):
    d, dt, dev = cfg.d_model, cfg.dtype, gen.device
    p = {"norm1": layers.init_norm(d, cfg.norm, dt, dev),
         "norm2": layers.init_norm(d, cfg.norm, dt, dev)}
    if cfg.attn_free:
        p["rwkv"] = rwkv6.init_rwkv_block(gen, d, cfg.d_ff, cfg.head_dim, dt)
        return p
    p["attn"] = attn.init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt,
                               cfg.qk_norm)
    p["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, dt, cfg.mlp_gated)
    return p


def init_lm(cfg: ArchConfig, gen: torch.Generator):
    _require_ported(cfg)
    return {
        "tok": layers.init_embed(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype,
                                 cfg.tie_embeddings),
        "layers": [_init_block(gen, cfg) for _ in range(cfg.n_layers)],
        "norm_f": layers.init_norm(cfg.d_model, cfg.norm, cfg.dtype, gen.device),
    }


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _block_forward(bp, x, cos, sin, cfg: ArchConfig, wkv_engine: str, attn_engine: str):
    """One block, full sequence.  Every ported family attends globally in
    every layer (hymba's sliding windows are not yet ported), so window is 0."""
    h = layers.apply_norm(bp["norm1"], x, cfg.norm)
    if not cfg.attn_free:
        ao, _ = attn.attention(bp["attn"], h, cos, sin, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, causal=True,
                               window=0, qk_norm=cfg.qk_norm, engine=attn_engine)
        x = x + ao
        h2 = layers.apply_norm(bp["norm2"], x, cfg.norm)
        return x + layers.apply_mlp(bp["mlp"], h2, cfg.act, cfg.mlp_gated)
    x_prev0 = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype, device=x.device)
    o, _, _ = rwkv6.time_mix(bp["rwkv"]["tmix"], h, x_prev0, None, cfg.head_dim,
                             engine=wkv_engine)
    x = x + o
    h2 = layers.apply_norm(bp["norm2"], x, cfg.norm)
    o2, _ = rwkv6.channel_mix(bp["rwkv"]["cmix"], h2, x_prev0)
    return x + o2


def lm_forward(params, cfg: ArchConfig, batch: Dict, *, wkv_engine: str = "auto",
               attn_engine: str = "auto"):
    """batch: tokens (B, S).  Returns (logits (B, S, padded vocab), aux).
    wkv_engine drives the RWKV6 family's WKV, attn_engine the dense
    family's attention (models.attention.attention)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = layers.embed_tokens(params["tok"], tokens).to(cfg.dtype)
    cos = sin = None
    if not cfg.attn_free:
        pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
        cos, sin = attn.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    for bp in params["layers"]:
        x = _block_forward(bp, x, cos, sin, cfg, wkv_engine, attn_engine)
    x = layers.apply_norm(params["norm_f"], x, cfg.norm)
    logits = layers.lm_logits(params["tok"], x, cfg.tie_embeddings)
    return logits, {"lb_loss": torch.zeros((), dtype=F32, device=x.device)}


# ---------------------------------------------------------------------------
# decode (single token against a cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=None, device="cuda"):
    """Zeroed cache of every layer on a leading (L,) axis, as in the
    reference: k and v (L, B, s_max, KV, dh) for the dense family; the
    token-shift inputs and the WKV state for the attention-free family,
    which does not use ``s_max``."""
    _require_ported(cfg)
    dtype = dtype or cfg.dtype
    L, B = cfg.n_layers, batch
    if not cfg.attn_free:
        shape = (L, B, s_max, cfg.n_kv_heads, cfg.head_dim)
        return {"pos": torch.zeros((), dtype=torch.int32, device=device),
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    H = cfg.d_model // cfg.head_dim
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "att_xprev": torch.zeros((L, B, cfg.d_model), dtype=dtype, device=device),
        "ffn_xprev": torch.zeros((L, B, cfg.d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((L, B, H, cfg.head_dim, cfg.head_dim), dtype=F32, device=device),
    }


def lm_decode_step(params, cfg: ArchConfig, cache: Dict, tokens):
    """tokens: (B,) integers, one new token a sequence.
    Returns (logits (B, padded vocab), new cache).  The dense family writes
    the token's k and v into the cache's tensors in place
    (attention.decode_attention); the returned cache holds them."""
    _require_ported(cfg)
    x = layers.embed_tokens(params["tok"], tokens)[:, None, :].to(cfg.dtype)
    if not cfg.attn_free:
        return _dense_decode_step(params, cfg, cache, x)
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


def _dense_decode_step(params, cfg: ArchConfig, cache: Dict, x):
    B = x.shape[0]
    pos = cache["pos"]
    cos1, sin1 = attn.rope_cos_sin(pos.reshape(1, 1).expand(B, 1), cfg.head_dim,
                                   cfg.rope_theta)
    for i, bp in enumerate(params["layers"]):
        h = layers.apply_norm(bp["norm1"], x, cfg.norm)
        x = x + attn.decode_attention(bp["attn"], h, cache["k"][i], cache["v"][i], pos, cos1,
                                      sin1, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                                      head_dim=cfg.head_dim, window=0,
                                      qk_norm=cfg.qk_norm)
        hh = layers.apply_norm(bp["norm2"], x, cfg.norm)
        x = x + layers.apply_mlp(bp["mlp"], hh, cfg.act, cfg.mlp_gated)
    x = layers.apply_norm(params["norm_f"], x[:, 0], cfg.norm)
    return (layers.lm_logits(params["tok"], x, cfg.tie_embeddings),
            dict(cache, pos=pos + 1))

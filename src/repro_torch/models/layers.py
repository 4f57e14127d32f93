"""Shared layer primitives of the LM path: norms, MLPs, embeddings,
initializers.

Parameters are plain dictionaries of tensors.  An initializer draws from an
explicit ``torch.Generator`` on the device where the tensors are made."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32


def dense_init(gen: torch.Generator, shape, dtype, fan_in: Optional[int] = None):
    """normal(0, 1) / sqrt(fan_in) (fan_in defaults to shape[0]), drawn in
    fp32 on the generator's device and then cast to ``dtype``."""
    fan = fan_in or shape[0]
    std = 1.0 / math.sqrt(fan)
    x = torch.randn(tuple(shape), generator=gen, dtype=F32, device=gen.device)
    return (x * std).to(dtype)


# -- norms ---------------------------------------------------------------------

def rmsnorm(x, scale):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + 1e-6)
    return (out * scale.to(F32)).to(x.dtype)


def layernorm(x, scale, bias):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)   # population variance
    out = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (out * scale.to(F32) + bias.to(F32)).to(x.dtype)


def nonparam_ln(x):
    """OLMo's non-parametric LayerNorm (no scale/bias)."""
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def init_norm(d, kind: str, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


def apply_norm(params, x, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    if kind == "nonparam_ln":
        return nonparam_ln(x)
    raise ValueError(kind)


# -- MLP -------------------------------------------------------------------------

def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; F.gelu to the erf form
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def init_mlp(gen: torch.Generator, d_model, d_ff, dtype, gated: bool):
    p = {"w_up": dense_init(gen, (d_model, d_ff), dtype),
         "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype)
    return p


def apply_mlp(p, x, act: str, gated: bool):
    up = x @ p["w_up"]
    if gated:
        h = _act(x @ p["w_gate"], act) * up
    else:
        h = _act(up, act)
    return h @ p["w_down"]


# -- embeddings -------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab, d_model, dtype, tie: bool):
    p = {"embed": dense_init(gen, (vocab, d_model), dtype, fan_in=d_model)}
    if not tie:
        p["lm_head"] = dense_init(gen, (d_model, vocab), dtype)
    return p


def embed_tokens(p, tokens):
    return p["embed"][tokens]


def lm_logits(p, x, tie: bool):
    if tie:
        return x @ p["embed"].T
    return x @ p["lm_head"]

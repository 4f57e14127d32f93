"""RWKV6 ("Finch") block: data-dependent-decay time mix + channel mix.

The WKV recurrence runs through repro_torch.kernels.rwkv6_scan: K10 for
tensors on the card, the chunked torch form on the CPU.

Time-mix (per head, dk = dv = head size):
    token-shift interpolation with learned mu per r/k/v/w/g
    decay  w_t = exp(-exp(w0 + tanh(x_t A_w) B_w))   (LoRA-style, bounded)
    o_t    = wkv(r, k, v, w, u)  ->  per-head groupnorm -> * silu(g) -> W_o
Channel-mix: r = sigmoid(xr W_r); out = r * (relu(xk W_k)^2 W_v).
Decode state per layer: (x_prev_att, x_prev_ffn, wkv state (H, dk, dv)).

The casts follow the reference step by step: mu in the activation dtype,
the decay formed in fp32 and exp(wlog) cast to the model dtype before the
op casts it back, norms in fp32.  With decay_w0 = -6, w lies near 0.9975,
where bf16's spacing is 2^-8, so a cast in another place changes log w.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tuning
from repro_torch.kernels.rwkv6_scan import rwkv6 as wkv_op
from repro_torch.kernels.rwkv6_scan import rwkv6_decode_step as wkv_decode
from . import layers

F32 = torch.float32
LORA_R = 64


def init_rwkv_block(gen: torch.Generator, d_model: int, d_ff: int, head_dim: int, dtype):
    H = d_model // head_dim
    dev = gen.device
    tmix = {
        "mu": 0.5 * torch.ones((5, d_model), dtype=F32, device=dev),  # r,k,v,w,g
        "w_r": layers.dense_init(gen, (d_model, d_model), dtype),
        "w_k": layers.dense_init(gen, (d_model, d_model), dtype),
        "w_v": layers.dense_init(gen, (d_model, d_model), dtype),
        "w_g": layers.dense_init(gen, (d_model, d_model), dtype),
        "w_o": layers.dense_init(gen, (d_model, d_model), dtype),
        "decay_w0": -6.0 * torch.ones((d_model,), dtype=F32, device=dev),
        "decay_a": layers.dense_init(gen, (d_model, LORA_R), dtype),
        "decay_b": layers.dense_init(gen, (LORA_R, d_model), dtype),
        "bonus": torch.zeros((H, head_dim), dtype=F32, device=dev),
        "ln_scale": torch.ones((d_model,), dtype=dtype, device=dev),  # output groupnorm scale
    }
    cmix = {
        "mu": 0.5 * torch.ones((2, d_model), dtype=F32, device=dev),  # r,k
        "w_r": layers.dense_init(gen, (d_model, d_model), dtype),
        "w_k": layers.dense_init(gen, (d_model, d_ff), dtype),
        "w_v": layers.dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
    }
    return {"tmix": tmix, "cmix": cmix}


def _token_shift(x, x_prev):
    """x: (B, T, d); x_prev: (B, d) last token of previous segment.
    Returns (xx = shifted x, new x_prev)."""
    xx = torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    return xx, x[:, -1, :]


def _heads(x, H, hd):
    B, T, _ = x.shape
    return x.reshape(B, T, H, hd).permute(0, 2, 1, 3)  # (B, H, T, hd), a view


def _unheads(x):
    B, H, T, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, T, H * hd)


def _group_norm(x, scale, H, hd):
    """Per-head layer norm on (B, T, d)."""
    B, T, d = x.shape
    xh = x.reshape(B, T, H, hd).to(F32)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)   # population variance
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (xh.reshape(B, T, d) * scale.to(F32)).to(x.dtype)


def _decay(p, xw, dtype):
    """w = exp(-exp(clip(w0 + tanh(xw A) B, -8, 1))), formed in fp32 and
    cast to ``dtype``."""
    lora = torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
    wlog = -torch.exp(torch.clamp(p["decay_w0"].to(F32) + lora.to(F32), -8.0, 1.0))
    return torch.exp(wlog).to(dtype)


def time_mix(p, x, x_prev, wkv_state, head_dim: int, engine: str = "auto"):
    """x: (B, T, d).  Returns (out, new_x_prev, new_wkv_state)."""
    B, T, d = x.shape
    H = d // head_dim
    xx, x_last = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xr = x + (xx - x) * mu[0]
    xk = x + (xx - x) * mu[1]
    xv = x + (xx - x) * mu[2]
    xw = x + (xx - x) * mu[3]
    xg = x + (xx - x) * mu[4]

    r = _heads(xr @ p["w_r"], H, head_dim)
    k = _heads(xk @ p["w_k"], H, head_dim)
    v = _heads(xv @ p["w_v"], H, head_dim)
    g = xg @ p["w_g"]
    w = _heads(_decay(p, xw, x.dtype), H, head_dim)      # decay in (0,1)

    u = p["bonus"].to(F32)
    o, sT = wkv_op(r, k, v, w, u, wkv_state, engine=engine, chunk=tuning.get().rwkv_chunk)
    o = _unheads(o)
    o = _group_norm(o, p["ln_scale"], H, head_dim)
    out = (o * F.silu(g)) @ p["w_o"]
    return out, x_last, sT


def channel_mix(p, x, x_prev):
    xx, x_last = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xr = x + (xx - x) * mu[0]
    xk = x + (xx - x) * mu[1]
    r = torch.sigmoid(xr @ p["w_r"])
    k = torch.square(torch.relu(xk @ p["w_k"]))
    return r * (k @ p["w_v"]), x_last


def time_mix_decode(p, x1, x_prev, wkv_state, head_dim: int):
    """Single token: x1 (B, d)."""
    B, d = x1.shape
    H = d // head_dim
    mu = p["mu"].to(x1.dtype)
    xx = x_prev.to(x1.dtype)
    xr = x1 + (xx - x1) * mu[0]
    xk = x1 + (xx - x1) * mu[1]
    xv = x1 + (xx - x1) * mu[2]
    xw = x1 + (xx - x1) * mu[3]
    xg = x1 + (xx - x1) * mu[4]
    hshape = lambda t: t.reshape(B, H, head_dim)
    r = hshape(xr @ p["w_r"])
    k = hshape(xk @ p["w_k"])
    v = hshape(xv @ p["w_v"])
    g = xg @ p["w_g"]
    w = hshape(_decay(p, xw, x1.dtype))
    u = p["bonus"].to(F32)
    o, sT = wkv_decode(r, k, v, w, u, wkv_state)
    o = o.reshape(B, d)
    o = _group_norm(o[:, None, :], p["ln_scale"], H, head_dim)[:, 0]
    out = (o * F.silu(g)) @ p["w_o"]
    return out, x1, sT


def channel_mix_decode(p, x1, x_prev):
    mu = p["mu"].to(x1.dtype)
    xx = x_prev.to(x1.dtype)
    xr = x1 + (xx - x1) * mu[0]
    xk = x1 + (xx - x1) * mu[1]
    r = torch.sigmoid(xr @ p["w_r"])
    k = torch.square(torch.relu(xk @ p["w_k"]))
    return r * (k @ p["w_v"]), x1

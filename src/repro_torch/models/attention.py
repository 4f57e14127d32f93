"""GQA attention with RoPE, sliding windows and KV-cache decode: the parts of
the JAX package's ``models/attention.py`` that the dense family runs.

Grouped-query attention never materialises repeated K/V: queries are
reshaped to (B, S, KV, rep, dh) and contracted against grouped keys.

Full-sequence attention keeps the reference's two branches, split at
``BLOCKWISE_MIN_SEQ``: the dense branch (exact-max softmax over the whole
row) and the blockwise branch (online softmax over kv blocks).  With
``engine="torch"`` they are the plain versions of the reference's jnp
branches; with ``engine="cuda"`` the dense branch runs K11 and the
blockwise branch K12 (``kernels/flash_attention``), which read the
projections in place.  The (B, KV, rep, S, S) fp32 scores that eager torch
ops would write to memory never exist there.

Not on the dense family's path, and refused where a config would reach
them: M-RoPE (``sections``), qk-norm, cross-attention and encoder memory,
the ``attn_fast`` and ``scores_bf16`` variants.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch import tuning
from repro_torch.kernels.flash_attention import flash_attention
from . import layers

F32 = torch.float32
NEG_INF = -1e30

# the sequence length from which attention runs blockwise (the reference's)
BLOCKWISE_MIN_SEQ = 8192

ENGINES = ("auto", "torch", "cuda")


# -- RoPE -------------------------------------------------------------------------

def rope_cos_sin(positions, head_dim: int, theta: float,
                 sections: Optional[Tuple[int, int, int]] = None):
    """cos/sin tables of shape (B, S, head_dim // 2) for positions (B, S)."""
    if sections is not None:
        raise NotImplementedError("M-RoPE (sections, qwen2-vl) is not yet ported")
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=positions.device) / half))
    ang = positions.to(F32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, dh); cos/sin: (B, S, half) -> rotated x (rotate-half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# -- parameter init ------------------------------------------------------------------

def init_attn(gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, dtype, qk_norm: bool = False):
    if qk_norm:
        raise NotImplementedError("qk-norm (qwen3) is not yet ported")
    return {
        "wq": layers.dense_init(gen, (d_model, n_heads * head_dim), dtype),
        "wk": layers.dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wv": layers.dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wo": layers.dense_init(gen, (n_heads * head_dim, d_model), dtype,
                                fan_in=n_heads * head_dim),
    }


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim, qk_norm):
    if qk_norm:
        raise NotImplementedError("qk-norm (qwen3) is not yet ported")
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


def _group_q(q, n_kv_heads):
    """(B, S, H, dh) -> (B, S, KV, rep, dh)."""
    B, S, H, dh = q.shape
    return q.reshape(B, S, n_kv_heads, H // n_kv_heads, dh)


# -- dense (short-seq) branch ----------------------------------------------------------

def _mask_ok(S_q, S_k, *, causal: bool, window: int, device=None):
    """(S_q, S_k) boolean visibility.  window <= 0 means unlimited."""
    qi = torch.arange(S_q, device=device)[:, None]
    kj = torch.arange(S_k, device=device)[None, :]
    ok = torch.ones((S_q, S_k), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kj <= qi)
    if window > 0:
        ok = ok & (qi - kj < window)
    return ok


def _dense_gqa(q, k, v, ok):
    """q: (B, Sq, KV, rep, dh), k/v: (B, Sk, KV, dh), ok: (Sq, Sk) bool."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q, k).to(F32) * scale
    scores = torch.where(ok[None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", w, v)


# -- blockwise (long-seq) branch ---------------------------------------------------------

def _blockwise_gqa(q, k, v, *, causal: bool, window: int):
    """Online-softmax attention over kv blocks, O(S) memory: a loop over q
    blocks and, inside it, over kv blocks (the reference's lax.map and
    lax.scan).  q: (B, S, KV, rep, dh); k/v: (B, S, KV, dh)."""
    B, S, KV, rep, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    tqb, tkb = tuning.get().q_block, tuning.get().kv_block
    qb = tqb if S % tqb == 0 else S
    kb = tkb if S % tkb == 0 else S
    dev = q.device
    outs = []
    for q0 in range(0, S, qb):
        qblk = q[:, q0:q0 + qb]
        acc = torch.zeros((B, KV, rep, qb, dh), dtype=F32, device=dev)
        m = torch.full((B, KV, rep, qb), -math.inf, dtype=F32, device=dev)
        l = torch.zeros((B, KV, rep, qb), dtype=F32, device=dev)
        qi = q0 + torch.arange(qb, device=dev)[:, None]
        for k0 in range(0, S, kb):
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk, k[:, k0:k0 + kb]).to(F32) * scale
            kj = k0 + torch.arange(kb, device=dev)[None, :]
            ok = torch.ones((qb, kb), dtype=torch.bool, device=dev)
            if causal:
                ok = ok & (kj <= qi)
            if window > 0:
                ok = ok & (qi - kj < window)
            s = torch.where(ok[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            upd = torch.einsum("bgrqk,bkgd->bgrqd", p.to(v.dtype), v[:, k0:k0 + kb])
            acc = acc * corr[..., None] + upd.to(F32)
            m = m_new
        # (B, KV, rep, qb, dh) -> (B, qb, KV, rep, dh)
        outs.append((acc / l[..., None]).to(q.dtype).permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)


# -- public entry points --------------------------------------------------------------

def attention(p, x, cos, sin, *, n_heads, n_kv_heads, head_dim, causal: bool = True,
              window: int = 0, qk_norm: bool = False, engine: str = "auto"):
    """Full-sequence attention (prefill).  x: (B, S, d).  Returns (out (B, S,
    d), (k, v)).  engine: "auto" ("cuda" for tensors on a CUDA device, else
    "torch"), "torch" (the reference's branches in torch ops), "cuda" (K11
    below BLOCKWISE_MIN_SEQ, K12 from it with tuning's kv_block; the q
    tiling does not change the function, so q_block is not read)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown attention engine {engine!r}; have {ENGINES}")
    if engine == "auto":
        engine = "cuda" if x.device.type == "cuda" else "torch"
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, qk_norm)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if engine == "torch":
        qg = _group_q(q, n_kv_heads)
        if S >= BLOCKWISE_MIN_SEQ:
            out = _blockwise_gqa(qg, k, v, causal=causal, window=window)
        else:
            out = _dense_gqa(qg, k, v, _mask_ok(S, S, causal=causal, window=window,
                                                device=x.device))
    else:
        o = flash_attention(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                            v.permute(0, 2, 1, 3), rep=n_heads // n_kv_heads, causal=causal,
                            window=window,
                            engine="cuda_kvchunk" if S >= BLOCKWISE_MIN_SEQ else "cuda",
                            kv_block=tuning.get().kv_block)
        out = o.permute(0, 2, 1, 3)    # (B, S, H, dh): o has q's strides
    out = out.reshape(B, S, n_heads * head_dim)
    return out @ p["wo"], (k, v)


def decode_attention(p, x1, cache_k, cache_v, pos, cos1, sin1, *, n_heads, n_kv_heads,
                     head_dim, window: int = 0, qk_norm: bool = False):
    """Single-token decode.  x1: (B, 1, d); cache_k/v: (B, S_max, KV, dh);
    pos: 0-d integer tensor, the current position.  Returns out (B, 1, d).

    Unlike the reference, which returns new caches, this writes the token's
    k and v into ``cache_k``/``cache_v`` in place: a copy of the whole cache
    every token would double the step's memory traffic.  One query row
    against the cache is a matrix-vector product, left to torch ops as the
    reference leaves it to jnp."""
    B = x1.shape[0]
    S_max = cache_k.shape[1]
    q, k1, v1 = _project_qkv(p, x1, n_heads, n_kv_heads, head_dim, qk_norm)
    if cos1 is not None:
        q = apply_rope(q, cos1, sin1)
        k1 = apply_rope(k1, cos1, sin1)
    at = pos.reshape(1).long()
    cache_k.index_copy_(1, at, k1.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v1.to(cache_v.dtype))
    qg = _group_q(q, n_kv_heads)  # (B, 1, KV, rep, dh)
    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, cache_k.to(qg.dtype)).to(F32) * scale
    kj = torch.arange(S_max, device=x1.device)
    ok = kj <= pos
    if window > 0:
        ok = ok & (pos - kj < window)
    scores = torch.where(ok[None, None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x1.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, cache_v.to(w.dtype))
    return out.reshape(B, 1, n_heads * head_dim) @ p["wo"]

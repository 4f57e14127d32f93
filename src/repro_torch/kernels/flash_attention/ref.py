"""Plain PyTorch oracle for the GQA flash-attention kernels (the "torch"
engine).

Masked softmax attention per (batch, kv group, rep) in the grouped layout
the kernels use:
  q: (BG, S, dh) where BG = B * KV * rep (grouped queries, row-major)
  k, v: (BKV, S, dh) where BKV = B * KV (each row serves ``rep`` q rows)
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_ref(q, k, v, *, rep: int, causal: bool = True, window: int = 0):
    """Returns (BG, S, dh) in q.dtype; softmax statistics in fp32."""
    BG, S, dh = q.shape
    kk = torch.repeat_interleave(k, rep, dim=0)
    vv = torch.repeat_interleave(v, rep, dim=0)
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), kk.to(torch.float32)) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kj <= qi)
    if window > 0:
        ok = ok & (qi - kj < window)
    s = torch.where(ok[None], s, NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", w, vv.to(torch.float32)).to(q.dtype)

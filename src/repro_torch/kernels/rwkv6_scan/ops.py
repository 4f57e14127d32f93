"""Public wrapper for the RWKV6 WKV op (engine dispatch)."""

from __future__ import annotations

import torch

from repro_torch.core.target import require_cuda
from . import kernel, ref

ENGINES = ("auto", "torch", "scan", "cuda")


def pick_chunk(chunk: int, T: int) -> int:
    """The chunk the op runs: min(chunk, T), then down until it divides T
    (a prompt of 100 tokens runs chunks of 50, a prime length chunks of 1)."""
    chunk = min(chunk, T)
    while T % chunk:
        chunk -= 1
    return chunk


def rwkv6(r, k, v, w, u, s0=None, *, engine: str = "auto", chunk: int = 64):
    """RWKV6 WKV over a sequence.

    r, k, w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk);
    s0: optional (B, H, dk, dv).
    Returns o (B, H, T, dv) in r.dtype, sT (B, H, dk, dv) fp32.

    engine: "auto" ("cuda" for tensors on a CUDA device, else "torch"),
            "torch" (chunked), "scan" (exact sequential oracle), "cuda" (K10).
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; have {ENGINES}")
    if engine == "auto":
        engine = "cuda" if r.device.type == "cuda" else "torch"
    B, H, T, dk = r.shape
    dv = v.shape[-1]
    chunk = pick_chunk(chunk, T)
    if s0 is None:
        s0 = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=r.device)

    if engine == "scan":
        o, sT = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    elif engine == "torch":
        o, sT = ref.rwkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
    else:
        kernel.check_limits(chunk, dk, dv)
        require_cuda("r", r)
        BH = B * H
        rr = lambda x, d: x.to(torch.float32, memory_format=torch.contiguous_format).reshape(BH, T, d)
        ub = u.to(torch.float32).expand(B, H, dk).reshape(BH, dk)
        o, sT = kernel.rwkv6_cuda(rr(r, dk), rr(k, dk), rr(v, dv), rr(w, dk), ub,
                                  s0.to(torch.float32).reshape(BH, dk, dv), chunk=chunk)
        o = o.reshape(B, H, T, dv)
        sT = sT.reshape(B, H, dk, dv)
    return o.to(r.dtype), sT


def rwkv6_decode_step(r1, k1, v1, w1, u, s):
    """One autoregressive token: O(dk*dv) per head, no sequence dim.
    r1,k1,w1: (B,H,dk); v1: (B,H,dv); s: (B,H,dk,dv) fp32 carried state."""
    o, s = ref.rwkv6_decode_ref(r1, k1, v1, w1, u, s)
    return o.to(r1.dtype), s

"""Public wrapper for the RWKV6 WKV op (engine dispatch)."""

from __future__ import annotations

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
    T, dk, dv = r.shape[2], r.shape[3], v.shape[-1]
    chunk = pick_chunk(chunk, T)
    if engine == "cuda":
        kernel.check_limits(chunk, dk, dv)
        require_cuda("r", r)
        return kernel.rwkv6_heads_cuda(r, k, v, w, u, s0, chunk=chunk)
    if engine == "scan":
        o, sT = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    else:
        o, sT = ref.rwkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
    return o.to(r.dtype), sT


def rwkv6_decode_step(r1, k1, v1, w1, u, s):
    """One autoregressive token: O(dk*dv) per head, no sequence dim.
    r1,k1,w1: (B,H,dk); v1: (B,H,dv); s: (B,H,dk,dv) fp32 carried state."""
    o, s = ref.rwkv6_decode_ref(r1, k1, v1, w1, u, s)
    return o.to(r1.dtype), s

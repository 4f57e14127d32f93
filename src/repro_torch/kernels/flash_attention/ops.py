"""Public wrapper: grouped-layout flash attention with engine dispatch."""

from __future__ import annotations

from repro_torch.core.target import require_cuda
from . import kernel

ENGINES = ("auto", "torch", "cuda", "cuda_kvchunk")


def flash_attention(q, k, v, *, rep: int, causal: bool = True, window: int = 0,
                    engine: str = "auto", kv_block: int = 1024):
    """q: (BG, S, dh); k/v: (BKV, S, dh); BG = BKV * rep.  Also q (B, H, S,
    dh) with k/v (B, KV, S, dh), H = KV * rep, at any strides whose last is
    1 (kernel.py).  Returns o in q's shape and dtype.

    engine: "auto" ("cuda" for tensors on a CUDA device, else "torch"),
            "torch" (ref.flash_ref), "cuda" (K11), "cuda_kvchunk" (K12, the
            long-sequence variant, with kv tiles of kernel.kv_tile(kv_block,
            S) keys, at most 64).  The reference's q_block is not taken:
            rows are independent, so the q tiling leaves the function and
            its bits unchanged.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; have {ENGINES}")
    if engine == "auto":
        engine = "cuda" if q.device.type == "cuda" else "torch"
    if engine == "torch":
        return kernel.flash_plain(q, k, v, rep=rep, causal=causal, window=window)
    require_cuda("q", q)
    if engine == "cuda":
        return kernel.flash_cuda(q, k, v, rep=rep, causal=causal, window=window)
    return kernel.flash_kvchunk_cuda(q, k, v, rep=rep, causal=causal, window=window,
                                     kv_block=kv_block)

"""CUDA wrappers for GQA flash attention: K11 (the exact-max kernel) and
K12 (the online-softmax kernel over kv tiles), both in ``csrc/flash.cu``,
each beside its plain PyTorch version.

K11 replaces ``kernels/flash_attention/kernel.py::flash_pallas`` of the JAX
package and K12 ``::flash_pallas_kvchunk``.  One block a (batch, q head, q
tile of 64 rows) runs the kv loop inside the block; K11 takes each row's
exact max in a first sweep over the keys and forms p, l and p v in a
second, as the TPU kernel does over its whole k/v rows; K12 carries acc, m
and l across its kv tiles.  Both read q, k and v in their own dtype and
write o in q's dtype.  bf16 runs on the tensor cores: QK^T in fp32
accumulators, the softmax in fp32 registers, and p v as two bf16 products
of p's high and low halves into fp32, so p keeps 16 bits where one bf16
product would keep 8 and miss the tests' one-ulp limit; the rows of q, k
and v must start on 16 bytes.  fp32 runs on the CUDA cores at any strides
whose last is 1.  Both are bound by arithmetic (the note in the source has
the counts).

Layouts.  q is (BG, S, dh) with k and v (BKV, S, dh), BG = BKV * rep, as
the reference takes them, or (B, H, S, dh) with k and v (B, KV, S, dh),
H = KV * rep: the model's (B, S, H, dh) projections seen through
``permute(0, 2, 1, 3)``, read in place.  Query row (or head) i reads kv row
(or head) i // rep.  o has q's shape and strides.

On a CPU tensor a wrapper returns its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch._cuda import Kernel
from . import ref

__all__ = ["flash_cuda", "flash_kvchunk_cuda", "flash_plain", "flash_kvchunk_plain",
           "kv_tile", "FLASH", "FLASH_KVCHUNK", "MAX_DH", "MAX_KV_TILE"]

FLASH = Kernel("flash_attention", "rt_flash")                          # K11
FLASH_KVCHUNK = Kernel("flash_attention_kvchunk", "rt_flash_kvchunk")  # K12
MAX_DH = 128        # head sizes 1 to 128 (RT_FA_MAX_DH in flash.cu)
MAX_KV_TILE = 64    # K12's kv tile is at most 64 keys (RT_FA_BK)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROW_ALIGN = 16     # bytes: a bf16 row is copied in 16-byte chunks (cp.async)


def kv_tile(kv_block: int, S: int) -> int:
    """K12's kv tile: the largest divisor of S up to min(kv_block, 64), as
    the reference picks its kvb from min(kv_block, S).  Where kv_block <= 64
    it is the reference's kvb, so the rescaling points are the TPU
    kernel's."""
    kvb = max(1, min(kv_block, MAX_KV_TILE, S))
    while S % kvb:
        kvb -= 1
    return kvb


def _as4(q, k, v, rep: int):
    """q, k, v as (B, H, S, dh) and (B, KV, S, dh) views, checked."""
    if q.dim() != k.dim() or k.shape != v.shape or q.dim() not in (3, 4):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         f"(BG, S, dh) with (BKV, S, dh), or (B, H, S, dh) with (B, KV, S, dh)")
    if q.dim() == 3:
        q, k, v = q[None], k[None], v[None]
    B, H, S, dh = q.shape
    if k.shape[0] != B or k.shape[2:] != (S, dh) or H != k.shape[1] * rep:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)} with rep {rep}")
    return q, k, v


def _plain_in(q, k, v, rep):
    """The grouped (BG, S, dh) tensors of a call, and a function that puts
    an output of that shape back into q's shape."""
    if q.dim() == 3:
        return q, k, v, lambda o: o
    B, H, S, dh = q.shape
    return (q.reshape(B * H, S, dh), k.reshape(-1, S, dh), v.reshape(-1, S, dh),
            lambda o: o.reshape(B, H, S, dh))


def flash_plain(q, k, v, *, rep: int, causal: bool = True, window: int = 0):
    """K11's plain version: ``ref.flash_ref``, on either layout."""
    _as4(q, k, v, rep)
    q3, k3, v3, back = _plain_in(q, k, v, rep)
    return back(ref.flash_ref(q3, k3, v3, rep=rep, causal=causal, window=window))


def flash_kvchunk_plain(q, k, v, *, rep: int, causal: bool = True, window: int = 0,
                        kv_block: int = MAX_KV_TILE):
    """K12's plain version: the reference's online softmax over kv tiles of
    ``kv_tile(kv_block, S)`` keys, every tile in order (no tile skipped),
    statistics in fp32 with the reference's NEG_INF."""
    _as4(q, k, v, rep)
    q3, k3, v3, back = _plain_in(q, k, v, rep)
    BG, S, dh = q3.shape
    kvb = kv_tile(kv_block, S)
    scale = 1.0 / math.sqrt(dh)
    qf = q3.to(torch.float32)
    kk = torch.repeat_interleave(k3, rep, dim=0).to(torch.float32)
    vv = torch.repeat_interleave(v3, rep, dim=0).to(torch.float32)
    dev = q.device
    acc = torch.zeros((BG, S, dh), dtype=torch.float32, device=dev)
    m = torch.full((BG, S, 1), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((BG, S, 1), dtype=torch.float32, device=dev)
    qi = torch.arange(S, device=dev)[:, None]
    for k0 in range(0, S, kvb):
        s = torch.einsum("bqd,bkd->bqk", qf, kk[:, k0:k0 + kvb]) * scale
        kj = torch.arange(k0, k0 + kvb, device=dev)[None, :]
        ok = torch.ones((S, kvb), dtype=torch.bool, device=dev)
        if causal:
            ok = ok & (kj <= qi)
        if window > 0:
            ok = ok & (qi - kj < window)
        s = torch.where(ok[None], s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bqk,bkd->bqd", p, vv[:, k0:k0 + kvb])
        m = m_new
    return back((acc / l).to(q.dtype))


def _check_rows_aligned(kern_name: str, name: str, t) -> None:
    """Raise ValueError unless every row of the bf16 operand ``t`` ((B, H,
    S, dh) or (BG, S, dh)) starts on 16 bytes: its base aligned and the
    strides of its leading extents above 1 multiples of 8 elements."""
    bad = [st for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1 and
           st * t.element_size() % _ROW_ALIGN]
    if t.data_ptr() % _ROW_ALIGN or bad:
        raise ValueError(f"{kern_name}: {name}'s rows must start on {_ROW_ALIGN} bytes for the "
                         f"bf16 kernel (base {t.data_ptr() % _ROW_ALIGN} bytes past alignment, "
                         f"strides {tuple(t.stride())})")


def _launch(kern: Kernel, q, k, v, rep, causal, window, *extra):
    q4, k4, v4 = _as4(q, k, v, rep)
    B, H, S, dh = q4.shape
    KV = k4.shape[1]
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"{kern.name} takes head sizes 1 to {MAX_DH}, got {dh}")
    dev = q.device
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.device != dev:
            raise ValueError(f"{kern.name}: {name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{kern.name}: {name} is {t.dtype}; q, k and v must share one "
                             f"of {tuple(_DTYPES)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{kern.name}: {name}'s last dimension has stride {t.stride(-1)}, "
                             f"expected 1")
        if t.dtype == torch.bfloat16:
            _check_rows_aligned(kern.name, name, t)
    o = torch.empty_like(q)   # q's strides, so a permuted view's output is one too
    o4 = o[None] if o.dim() == 3 else o
    strides = [s for t in (q4, k4, v4, o4) for s in t.stride()[:3]]
    kern.launch(dev, q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
                _DTYPES[q.dtype], B, H, KV, S, dh, *strides, int(causal), int(window),
                1.0 / math.sqrt(dh), *extra)
    return o


def flash_cuda(q, k, v, *, rep: int, causal: bool = True, window: int = 0):
    """K11: o in q's dtype, shape and strides (see the module's layouts)."""
    if q.device.type == "cpu":
        return flash_plain(q, k, v, rep=rep, causal=causal, window=window)
    return _launch(FLASH, q, k, v, rep, causal, window)


def flash_kvchunk_cuda(q, k, v, *, rep: int, causal: bool = True, window: int = 0,
                       kv_block: int = MAX_KV_TILE):
    """K12 with kv tiles of ``kv_tile(kv_block, S)`` keys."""
    if q.device.type == "cpu":
        return flash_kvchunk_plain(q, k, v, rep=rep, causal=causal, window=window,
                                   kv_block=kv_block)
    return _launch(FLASH_KVCHUNK, q, k, v, rep, causal, window, kv_tile(kv_block, q.shape[-2]))

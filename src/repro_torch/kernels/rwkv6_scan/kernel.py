"""CUDA wrappers for the RWKV6 chunked WKV recurrence: K10
(``csrc/rwkv6.cu``, two kernels) beside its plain PyTorch version.

K10 replaces ``kernels/rwkv6_scan/kernel.py::rwkv6_pallas`` of the JAX
package in FLA's chunk-parallel form: a state pass (``WKV_STATE``) carries
each head's (dk, dv) state over the chunks in order and writes the state
entering every chunk; an output pass (``WKV``) then runs every (head,
chunk) as a block of its own, with the intra-chunk decays factored about
sub-chunks of 16 steps and the products on the tensor cores (3xTF32).  The
kernels read fp32 or bf16 (B, H, T, d) views at the model's strides and
write o in the inputs' dtype and in the (B, T, H, dv) order the model
merges its heads from.  On a CPU tensor a wrapper returns the plain
version; on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._cuda import Kernel, check_tensor
from . import ref

__all__ = ["rwkv6_cuda", "rwkv6_heads_cuda", "rwkv6_plain", "rwkv6_heads_plain",
           "check_limits", "MAX_DIM", "WKV", "WKV_STATE"]

WKV_STATE = Kernel("rwkv6_wkv_state", "rt_rwkv6_state")   # the state pass
WKV = Kernel("rwkv6_wkv", "rt_rwkv6_output")               # the output pass
MAX_DIM = 64   # K10 takes a chunk, dk and dv of 1 to 64 (RT_K10_MAX in rwkv6.cu)
_DTYPES = (torch.float32, torch.bfloat16)   # what the kernels read and write


def check_limits(chunk: int, dk: int, dv: int) -> None:
    """Raise ValueError unless K10 takes this chunk and these head sizes."""
    for name, n in (("chunk", chunk), ("dk", dk), ("dv", dv)):
        if not 1 <= n <= MAX_DIM:
            raise ValueError(f"K10 (rwkv6_wkv) takes {name} from 1 to {MAX_DIM}, got {n}")


def rwkv6_plain(r, k, v, w, u, s0, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w: (BH, T, dk); v: (BH, T, dv); u: (BH, dk); s0: (BH, dk, dv).
    Returns o (BH, T, dv), sT (BH, dk, dv), fp32: ref.rwkv6_chunked with
    the heads as a batch of one."""
    o, sT = ref.rwkv6_chunked(r[None], k[None], v[None], w[None], u, s0[None], chunk=chunk)
    return o[0], sT[0]


def _heads_out(B, H, T, dv, dtype, device) -> torch.Tensor:
    """o as a (B, H, T, dv) view of a contiguous (B, T, H, dv) tensor: the
    order the model merges its heads from, with no copy."""
    return torch.empty((B, T, H, dv), dtype=dtype, device=device).permute(0, 2, 1, 3)


def rwkv6_heads_plain(r, k, v, w, u, s0=None, *, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rwkv6_heads_cuda`'s plain version: ref.rwkv6_chunked, o cast
    to r's dtype in the same (B, T, H, dv) order."""
    o32, sT = ref.rwkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
    o = _heads_out(*o32.shape[:3], o32.shape[3], r.dtype, r.device)
    o.copy_(o32)
    return o, sT


def _operands(r, k, v, w):
    """r, k, v, w as the kernels read them: one dtype of _DTYPES (else all
    cast to fp32), d contiguous, r, k and w at one set of strides (else
    contiguous copies)."""
    xs = [r, k, v, w]
    if len({x.dtype for x in xs}) > 1 or r.dtype not in _DTYPES:
        xs = [x.float() for x in xs]
    if any(x.stride(-1) != 1 and x.shape[-1] > 1 for x in xs) or \
            len({xs[i].stride() for i in (0, 1, 3)}) > 1:
        xs = [x.contiguous() for x in xs]
    return xs


def _launch(r, k, v, w, u, usb, ush, s0, o, chunk) -> torch.Tensor:
    """The state pass, then the output pass, on (B, H, T, d) operands as
    :func:`_operands` leaves them; o (B, H, T, dv) fp32 or bf16 with d
    contiguous is written; returns sT (B, H, dk, dv) fp32."""
    B, H, T, dk = r.shape
    dv = v.shape[-1]
    dev = r.device
    states = torch.empty((B * H, T // chunk, dk, dv), dtype=torch.float32, device=dev)
    sT = torch.empty((B, H, dk, dv), dtype=torch.float32, device=dev)
    bf16 = int(r.dtype == torch.bfloat16)
    strides, vstrides = r.stride()[:3], v.stride()[:3]
    WKV_STATE.launch(dev, k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     None if s0 is None else s0.data_ptr(), states.data_ptr(), sT.data_ptr(),
                     B, H, T, chunk, dk, dv, *strides, *vstrides, bf16)
    WKV.launch(dev, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
               states.data_ptr(), o.data_ptr(), B, H, T, chunk, dk, dv, *strides, *vstrides,
               usb, ush, *o.stride()[:3], bf16, int(o.dtype == torch.bfloat16))
    return sT


def _check(B, H, T, dk, dv, chunk, r, k, v, w):
    check_limits(chunk, dk, dv)
    if T % chunk:
        raise ValueError(f"chunk={chunk} must divide T={T}")
    for name, t, d in (("r", r, dk), ("k", k, dk), ("v", v, dv), ("w", w, dk)):
        if tuple(t.shape) != (B, H, T, d) or t.device != r.device:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, expected "
                             f"{(B, H, T, d)} on {r.device}")


def rwkv6_cuda(r, k, v, w, u, s0, *, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 on (BH, T, d) tensors, as rwkv6_pallas takes them: r, k, w
    (BH, T, dk), v (BH, T, dv), u (BH, dk), s0 (BH, dk, dv); returns o
    (BH, T, dv) and sT (BH, dk, dv), fp32."""
    BH, T, dk = r.shape
    dv = v.shape[-1]
    _check(BH, 1, T, dk, dv, chunk, *(x[:, None] for x in (r, k, v, w)))
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0, chunk=chunk)
    dev = r.device
    r, k, v, w = _operands(*(x.float()[:, None] for x in (r, k, v, w)))
    u, s0 = u.float().contiguous(), s0.float().contiguous()
    check_tensor("u", u, (BH, dk), dev)
    check_tensor("s0", s0, (BH, dk, dv), dev)
    o = torch.empty((BH, 1, T, dv), dtype=torch.float32, device=dev)
    sT = _launch(r, k, v, w, u, u.stride(0), 0, s0, o, chunk)
    return o[:, 0], sT[:, 0]


def rwkv6_heads_cuda(r, k, v, w, u, s0: Optional[torch.Tensor] = None, *, chunk: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 on the model's heads: r, k, w (B, H, T, dk) and v (B, H, T, dv),
    fp32 or bf16 at any strides (the model's are permuted views of
    (B, T, H, d)); u (H, dk); s0 (B, H, dk, dv) or None for zeros.  Returns
    o (B, H, T, dv) in r's dtype, a view of a contiguous (B, T, H, dv)
    tensor, and sT (B, H, dk, dv) fp32 (the "cuda" engine of ops.rwkv6)."""
    B, H, T, dk = r.shape
    dv = v.shape[-1]
    _check(B, H, T, dk, dv, chunk, r, k, v, w)
    if r.device.type == "cpu":
        return rwkv6_heads_plain(r, k, v, w, u, s0, chunk=chunk)
    dev = r.device
    xs = _operands(r, k, v, w)
    u = u.float().contiguous()
    check_tensor("u", u, (H, dk), dev)
    if s0 is not None:
        s0 = s0.float().contiguous()
        check_tensor("s0", s0, (B, H, dk, dv), dev)
    out = r.dtype if r.dtype in _DTYPES else torch.float32
    o = _heads_out(B, H, T, dv, out, dev)
    sT = _launch(*xs, u, 0, u.stride(0), s0, o, chunk)
    return (o if out == r.dtype else o.to(r.dtype)), sT

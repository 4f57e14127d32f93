"""CUDA wrapper for the RWKV6 chunked WKV recurrence: K10
(``csrc/rwkv6.cu``) beside its plain PyTorch version.

K10 replaces ``kernels/rwkv6_scan/kernel.py::rwkv6_pallas`` of the JAX
package: one block a (batch, head) loops over the chunks with the (dk, dv)
state in shared memory, and forms each chunk's pairwise decays in registers
instead of the reference's (C, C, dk) tensor.  It is bound by arithmetic
(exponentials and fp32 products), not bytes.  On a CPU tensor the wrapper
returns the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch._cuda import Kernel, check_tensor
from . import ref

__all__ = ["rwkv6_cuda", "rwkv6_plain", "check_limits", "MAX_DIM", "WKV"]

WKV = Kernel("rwkv6_wkv", "rt_rwkv6_wkv")
MAX_DIM = 64   # K10 takes a chunk, dk and dv of 1 to 64 (RT_K10_MAX in rwkv6.cu)


def check_limits(chunk: int, dk: int, dv: int) -> None:
    """Raise ValueError unless K10 takes this chunk and these head sizes."""
    for name, n in (("chunk", chunk), ("dk", dk), ("dv", dv)):
        if not 1 <= n <= MAX_DIM:
            raise ValueError(f"K10 (rwkv6_wkv) takes {name} from 1 to {MAX_DIM}, got {n}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x as a contiguous fp32 tensor, with one copy at most (``to`` returns an
    fp32 view such as an expanded u unchanged)."""
    y = x.to(torch.float32, memory_format=torch.contiguous_format)
    return y if y.is_contiguous() else y.contiguous()


def rwkv6_plain(r, k, v, w, u, s0, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w: (BH, T, dk); v: (BH, T, dv); u: (BH, dk); s0: (BH, dk, dv).
    Returns o (BH, T, dv), sT (BH, dk, dv), fp32: ref.rwkv6_chunked with
    the heads as a batch of one."""
    o, sT = ref.rwkv6_chunked(r[None], k[None], v[None], w[None], u, s0[None], chunk=chunk)
    return o[0], sT[0]


def rwkv6_cuda(r, k, v, w, u, s0, *, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 on (BH, T, d) tensors, as rwkv6_pallas takes them: inputs are
    cast to fp32 (contiguous copies where they are not already); returns o
    (BH, T, dv) and sT (BH, dk, dv), fp32."""
    BH, T, dk = r.shape
    dv = v.shape[-1]
    check_limits(chunk, dk, dv)
    if T % chunk:
        raise ValueError(f"chunk={chunk} must divide T={T}")
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0, chunk=chunk)
    dev = r.device
    r, k, v, w, u, s0 = (_f32(x) for x in (r, k, v, w, u, s0))
    for name, t, shape in (("r", r, (BH, T, dk)), ("k", k, (BH, T, dk)), ("v", v, (BH, T, dv)),
                           ("w", w, (BH, T, dk)), ("u", u, (BH, dk)), ("s0", s0, (BH, dk, dv))):
        check_tensor(name, t, shape, dev)
    o = torch.empty((BH, T, dv), dtype=torch.float32, device=dev)
    sT = torch.empty((BH, dk, dv), dtype=torch.float32, device=dev)
    WKV.launch(dev, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
               s0.data_ptr(), o.data_ptr(), sT.data_ptr(), BH, T, chunk, dk, dv)
    return o, sT

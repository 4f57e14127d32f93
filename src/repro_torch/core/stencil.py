"""Stencil helpers on canonical (ncomp, *lattice) views.

Single-shard (periodic) stencils use rolls and periodic halo padding; these
are the ``"torch"``-engine implementations and the plain versions the CUDA
stencil kernels are held against.  Convention: ``out(r) = in(r - disp)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["shift_periodic", "halo_pad", "interior"]


def shift_periodic(x_nd: torch.Tensor, disp: Sequence[int]) -> torch.Tensor:
    """Value at site r of the result = value at site (r - disp) of x (periodic).

    x_nd: (ncomp, *lattice); disp indexes the lattice dims."""
    out = x_nd
    for d, s in enumerate(disp):
        if s:
            out = torch.roll(out, shifts=int(s), dims=d + 1)
    return out


def halo_pad(x_nd: torch.Tensor, width: int, site_dims: Sequence[int]) -> torch.Tensor:
    """Pad with periodic wrap — the single-shard halo fill (numpy's
    ``mode="wrap"``: padded index i reads site (i - width) mod extent, for
    any width)."""
    out = x_nd
    for d in site_dims:
        n = out.shape[d]
        idx = torch.arange(-width, n + width, device=out.device) % n
        out = out.index_select(d, idx)
    return out


def interior(x_halo: torch.Tensor, width: int, site_dims: Sequence[int]) -> torch.Tensor:
    """Strip halos back off."""
    idx = [slice(None)] * x_halo.ndim
    for d in site_dims:
        idx[d] = slice(width, x_halo.shape[d] - width)
    return x_halo[tuple(idx)]

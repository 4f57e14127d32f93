"""Pure-torch oracle for D3Q19 propagation (Ludwig "Propagation").

Streaming step: f'_i(r + c_i) = f_i(r), i.e. out_i(r) = f_i(r - c_i), on a
periodic lattice through rolls, or (``propagate_halo_ref``, the sharded
path) on the interior of a halo'd array through displaced windows.  Pure
data movement: the port matches the JAX package bitwise.
"""

from __future__ import annotations

import torch

from repro_torch.core import stencil
from repro_torch.maths import d3q19


def propagate_ref(f_nd: torch.Tensor) -> torch.Tensor:
    """Periodic propagation. f_nd: (19, X, Y, Z) canonical."""
    outs = []
    for i in range(d3q19.NVEL):
        disp = tuple(int(c) for c in d3q19.CV[i])
        outs.append(stencil.shift_periodic(f_nd[i : i + 1], disp)[0])
    return torch.stack(outs)


def propagate_halo_ref(f_halo: torch.Tensor, width: int = 1) -> torch.Tensor:
    """Halo'd propagation. f_halo: (19, X+2w, Y+2w, Z+2w) with halos already
    exchanged; returns the interior (19, X, Y, Z)."""
    outs = []
    for i in range(d3q19.NVEL):
        disp = tuple(int(c) for c in d3q19.CV[i])
        outs.append(stencil.shifted_window(f_halo[i], disp, width, (0, 1, 2)))
    return torch.stack(outs)

"""CUDA wrapper for the D3Q19 collision: K7 (``csrc/lb.cu``) beside its
plain PyTorch version.

K7 replaces ``kernels/lb_collision/kernel.py::collide_pallas`` of the JAX
package over fp32 fields, dist, force and out each in its own layout (SoA,
AoS or AoSoA, addressed through INDEX inside the kernel; the TPU kernel
takes force's layout apart from dist's), bound by device-memory bytes (164
compulsory bytes a site).  A block takes a chunk of vvl consecutive sites,
a thread a site.  Where the three tensors share one layout (AoSoA: its SAL
dividing vvl), the chunk's values lie in contiguous runs, which move
through shared memory as 16-byte vectors both ways
(``kernels/lb_propagation/kernel.py``: ``lb_stage_copy``,
``lb_stage_read``); every other launch, and a last partial chunk, loads
and stores site by site.  The collision's roundings are pinned
(``csrc/d3q19.cuh``), so K7 equals the plain version bitwise on the card.
The wrapper takes physical tensors and ``layouts`` ("dist", "force",
"out"; an input not named is SoA, out takes dist's layout).  On a CPU
tensor it returns the plain version; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch._cuda import Kernel, check_field
from repro_torch.core.layout import resolve_layouts
from repro_torch.maths import d3q19
from . import ref

__all__ = ["collide_cuda", "collide_plain", "lb_params", "COLLIDE"]

COLLIDE = Kernel("lb_collide", "rt_lb_collide")


def lb_params(tau: float) -> Tuple[float, float, float, float]:
    """(omega, pref*w_rest, pref*w_face, pref*w_edge) in double, as the
    reference forms its Python-float coefficients; ctypes rounds each to
    the fp32 the reference's weak-typed scalars become."""
    omega = 1.0 / tau
    pref = 1.0 - 0.5 / tau
    w = [float(x) for x in d3q19.WV]
    return omega, pref * w[0], pref * w[1], pref * w[7]


_IN, _OUT = ("dist", "force"), ("out",)


def collide_plain(dist: torch.Tensor, force: torch.Tensor, tau: float,
                  layouts=None) -> torch.Tensor:
    """dist (19 components), force (3) -> post-collision dist (19)."""
    lay = resolve_layouts(layouts, _IN, _OUT)
    return lay["out"].pack(ref.collide_chunk(lay["dist"].unpack(dist),
                                             lay["force"].unpack(force), tau))


def collide_cuda(dist: torch.Tensor, force: torch.Tensor, tau: float,
                 vvl: int = 128, *, layouts=None) -> torch.Tensor:
    """K7: BGK collision + Guo forcing of dist (19 components) and force (3)."""
    if dist.device.type == "cpu":
        return collide_plain(dist, force, tau, layouts)
    lay = resolve_layouts(layouts, _IN, _OUT)
    _, V = lay["dist"].logical_shape(dist.shape)
    ld = check_field("dist", dist, lay["dist"], 19, V, dist.device)
    lf = check_field("force", force, lay["force"], 3, V, dist.device)
    out = torch.empty(lay["out"].physical_shape(19, V), dtype=dist.dtype, device=dist.device)
    COLLIDE.launch(dist.device, dist.data_ptr(), force.data_ptr(), out.data_ptr(), V,
                   *lb_params(float(tau)), ld, lf, lay["out"].descriptor(), vvl)
    return out

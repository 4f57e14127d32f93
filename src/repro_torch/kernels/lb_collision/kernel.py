"""CUDA wrapper for the D3Q19 collision: K7 (``csrc/lb.cu``) beside its
plain PyTorch version.

K7 replaces ``kernels/lb_collision/kernel.py::collide_pallas`` of the JAX
package: one thread per site over SoA fp32 fields, bound by device-memory
bytes (164 compulsory bytes a site).  On a CPU tensor the wrapper returns
the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch._cuda import Kernel, check_tensor
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


def collide_plain(dist: torch.Tensor, force: torch.Tensor, tau: float) -> torch.Tensor:
    """(19, V) dist, (3, V) force -> (19, V) post-collision."""
    return ref.collide_chunk(dist, force, tau)


def collide_cuda(dist: torch.Tensor, force: torch.Tensor, tau: float,
                 vvl: int = 128) -> torch.Tensor:
    """K7: BGK collision + Guo forcing of SoA (19, V) dist and (3, V) force."""
    if dist.device.type == "cpu":
        return collide_plain(dist, force, tau)
    V = dist.shape[-1]
    check_tensor("dist", dist, (19, V), dist.device)
    check_tensor("force", force, (3, V), dist.device)
    out = torch.empty_like(dist)
    COLLIDE.launch(dist.device, dist.data_ptr(), force.data_ptr(), out.data_ptr(), V,
                   *lb_params(float(tau)), vvl)
    return out

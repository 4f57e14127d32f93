"""CUDA wrappers for D3Q19 streaming: K8 (propagation) and K5L (the fused
LB step), both in ``csrc/lb.cu``, each beside its plain PyTorch version.

K8 replaces ``kernels/lb_propagation/kernel.py::propagate_pallas`` of the
JAX package: a pull gather ``out_i(r) = f_i(r - c_i)`` with the periodic
wrap inside the kernel, so the halo'd copy the TPU path stages is never
built.  It moves data only and equals its plain version bitwise.

K5L replaces ``core/fuse.py::LaunchGraph._build_nd`` for the
``ludwig_lb_step`` graph (moments, collision, streaming -> dist2 and u) and,
without u, for ``lb_collide_propagate``.  It streams by push: each site's
thread collides in registers and writes its post-collision values to the
neighbours, so the post-collision distributions never reach device memory.

On a CPU tensor each wrapper returns its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch._cuda import Kernel, check_tensor
from repro_torch.kernels.lb_collision.kernel import collide_plain, lb_params
from repro_torch.kernels.lb_collision.ref import moments
from . import ref

__all__ = ["propagate_cuda", "propagate_plain", "lb_step_cuda", "lb_step_plain",
           "PROPAGATE", "LB_STEP"]

PROPAGATE = Kernel("lb_propagate", "rt_lb_propagate")
LB_STEP = Kernel("lb_step", "rt_lb_step")


def _check_3d(lattice: Sequence[int]) -> Tuple[int, int, int]:
    lat = tuple(int(s) for s in lattice)
    if len(lat) != 3 or min(lat) < 1:
        raise ValueError(f"the LB kernels need a 3-D lattice, got {lat}")
    return lat


def propagate_plain(dist: torch.Tensor, lattice) -> torch.Tensor:
    """(19, V) SoA -> (19, V) streamed, periodic."""
    lat = _check_3d(lattice)
    return ref.propagate_ref(dist.reshape((19,) + lat)).reshape(19, -1)


def propagate_cuda(dist: torch.Tensor, lattice, vvl: int = 128) -> torch.Tensor:
    """K8: periodic D3Q19 streaming of SoA (19, V) distributions."""
    if dist.device.type == "cpu":
        return propagate_plain(dist, lattice)
    lat = _check_3d(lattice)
    check_tensor("dist", dist, (19, math.prod(lat)), dist.device)
    out = torch.empty_like(dist)
    PROPAGATE.launch(dist.device, dist.data_ptr(), out.data_ptr(), *lat, vvl)
    return out


def moments_velocity(dist: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
    """The ludwig_lb_step graph's u: mom/rho + 0.5 force/rho (the driver's
    _moments_body, not collision's (mom + 0.5 force)/rho)."""
    rho, u = moments(dist)
    return u + 0.5 * force / rho[None, :]


def lb_step_plain(dist: torch.Tensor, force: torch.Tensor, tau: float, lattice,
                  with_u: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dist2 = propagate(collide(dist, force)), u or None)."""
    dist2 = propagate_plain(collide_plain(dist, force, tau), lattice)
    return dist2, (moments_velocity(dist, force) if with_u else None)


def lb_step_cuda(dist: torch.Tensor, force: torch.Tensor, tau: float, lattice,
                 vvl: int = 128, with_u: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5L: one launch computing the streamed post-collision distributions
    and (with_u) the half-force velocity of SoA (19, V) dist and (3, V)
    force."""
    if dist.device.type == "cpu":
        return lb_step_plain(dist, force, tau, lattice, with_u)
    lat = _check_3d(lattice)
    V = math.prod(lat)
    check_tensor("dist", dist, (19, V), dist.device)
    check_tensor("force", force, (3, V), dist.device)
    dist2 = torch.empty_like(dist)
    u = torch.empty_like(force) if with_u else None
    LB_STEP.launch(dist.device, dist.data_ptr(), force.data_ptr(), dist2.data_ptr(),
                   u.data_ptr() if with_u else None, *lat, *lb_params(float(tau)), vvl)
    return dist2, u

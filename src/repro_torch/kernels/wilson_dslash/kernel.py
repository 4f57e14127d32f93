"""CUDA wrappers for the Wilson operator: K4 (``csrc/dslash.cu``) and K5
(``csrc/wilson_normal.cu``), each beside its plain PyTorch version.

K4 replaces ``kernels/wilson_dslash/kernel.py::dslash_site_pallas`` of the
JAX package together with its gather prologue; K5 replaces
``core/fuse.py::LaunchGraph._build_nd`` for the ``wilson_normal`` graph.
Both kernels run one thread per site over SoA fp32 fields on a periodic
4-D lattice and share one device function for the hopping term
(``csrc/wilson.cuh``).  Both are bound by device-memory bytes (480
compulsory bytes a site); see the sources for what each design leaves on
the table.

On a CPU tensor each wrapper returns its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch._cuda import Kernel, check_tensor
from repro_torch.core.reduce import fold_partials
from . import ref

__all__ = ["dslash_cuda", "dslash_plain", "wilson_normal_cuda",
           "wilson_normal_plain", "DSLASH", "WILSON_NORMAL_T",
           "WILSON_NORMAL_AP"]

DSLASH = Kernel("dslash", "rt_dslash")
WILSON_NORMAL_T = Kernel("wilson_normal_t", "rt_wilson_normal_t")
WILSON_NORMAL_AP = Kernel("wilson_normal_ap", "rt_wilson_normal_ap")


def _check_4d(lattice: Sequence[int]) -> Tuple[int, int, int, int]:
    lat = tuple(int(s) for s in lattice)
    if len(lat) != 4 or min(lat) < 1:
        raise ValueError(f"the Wilson kernels need a 4-D lattice, got {lat}")
    return lat


def dslash_plain(psi: torch.Tensor, u: torch.Tensor, lattice) -> torch.Tensor:
    """(24, V) psi, (72, V) u -> (24, V) D psi, periodic."""
    lat = _check_4d(lattice)
    out = ref.dslash_ref(psi.reshape((24,) + lat), u.reshape((72,) + lat))
    return out.reshape(24, -1)


def dslash_cuda(psi: torch.Tensor, u: torch.Tensor, lattice, vvl: int = 128) -> torch.Tensor:
    """K4: D psi for SoA (24, V) psi and (72, V) u on a periodic lattice."""
    if psi.device.type == "cpu":
        return dslash_plain(psi, u, lattice)
    lat = _check_4d(lattice)
    V = math.prod(lat)
    check_tensor("psi", psi, (24, V), psi.device)
    check_tensor("u", u, (72, V), psi.device)
    out = torch.empty_like(psi)
    DSLASH.launch(psi.device, psi.data_ptr(), u.data_ptr(), out.data_ptr(),
                  *lat, vvl)
    return out


def _m_g5(psi: torch.Tensor, d: torch.Tensor, kappa: float) -> torch.Tensor:
    t = psi - kappa * d
    return torch.cat([t[:12], -t[12:]], dim=0)


def wilson_normal_plain(p: torch.Tensor, u: torch.Tensor, kappa: float,
                        lattice) -> Tuple[torch.Tensor, torch.Tensor]:
    """t = g5(p - kappa D p), ap = g5(t - kappa D t), pap = sum_sites p*ap."""
    t = _m_g5(p, dslash_plain(p, u, lattice), kappa)
    ap = _m_g5(t, dslash_plain(t, u, lattice), kappa)
    return ap, (p * ap).sum(dim=1)


def wilson_normal_cuda(p: torch.Tensor, u: torch.Tensor, kappa: float, lattice,
                       vvl: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (ap (24, V), pap (24,)) = (M^dag M p, per-component p . ap), in
    two launches and the fold of the pap partials."""
    if p.device.type == "cpu":
        return wilson_normal_plain(p, u, kappa, lattice)
    lat = _check_4d(lattice)
    V = math.prod(lat)
    check_tensor("p", p, (24, V), p.device)
    check_tensor("u", u, (72, V), p.device)
    t = torch.empty_like(p)
    ap = torch.empty_like(p)
    partials = torch.empty((-(-V // vvl), 24), dtype=p.dtype, device=p.device)
    WILSON_NORMAL_T.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(),
                         float(kappa), *lat, vvl)
    WILSON_NORMAL_AP.launch(p.device, p.data_ptr(), t.data_ptr(), u.data_ptr(),
                            ap.data_ptr(), partials.data_ptr(), float(kappa),
                            *lat, vvl)
    return ap, fold_partials(partials, "sum")

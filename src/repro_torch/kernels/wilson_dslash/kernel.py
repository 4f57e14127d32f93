"""CUDA wrappers for the Wilson operator: K4 (``csrc/dslash.cu``) and K5
(``csrc/wilson_normal.cu``), each beside its plain PyTorch version.

K4 replaces ``kernels/wilson_dslash/kernel.py::dslash_site_pallas`` of the
JAX package together with its gather prologue; K5 replaces
``core/fuse.py::LaunchGraph._build_nd`` for the ``wilson_normal`` graph.
Both kernels run one thread per site over fp32 fields on a periodic 4-D
lattice, each field in its own layout (SoA, AoS or AoSoA, addressed
through INDEX inside the kernel), and share one device function for the
hopping term (``csrc/wilson.cuh``).  Each wrapper takes physical tensors
and ``layouts`` (names as in its signature; an input not named is SoA, an
output takes the first input's layout) and returns physical tensors.  Both are bound by device-memory bytes (480
compulsory bytes a site); see the sources for what each design leaves on
the table.

K5B, the batch instance (``batched=True``), runs K5's two kernels with the
slot as one more grid axis: p and ap are ``batch`` stacked spinors, u is
one gauge field shared by every slot, pap is (batch, 24), and each slot's
ap and pap are bitwise the single launch's on that slot.

On a CPU tensor each wrapper returns its plain version (unpack, torch ops,
pack); on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch._cuda import Kernel, check_batched_field, check_field
from repro_torch.core.layout import resolve_layouts
from repro_torch.core.reduce import fold_partials, fold_partials_batched
from . import ref

__all__ = ["dslash_cuda", "dslash_plain", "wilson_normal_cuda",
           "wilson_normal_plain", "DSLASH", "WILSON_NORMAL_T",
           "WILSON_NORMAL_AP", "WILSON_NORMAL_T_B", "WILSON_NORMAL_AP_B"]

DSLASH = Kernel("dslash", "rt_dslash")
WILSON_NORMAL_T = Kernel("wilson_normal_t", "rt_wilson_normal_t")
WILSON_NORMAL_AP = Kernel("wilson_normal_ap", "rt_wilson_normal_ap")
WILSON_NORMAL_T_B = Kernel("wilson_normal_t_batched", "rt_wilson_normal_t_batched")
WILSON_NORMAL_AP_B = Kernel("wilson_normal_ap_batched", "rt_wilson_normal_ap_batched")


def _check_4d(lattice: Sequence[int]) -> Tuple[int, int, int, int]:
    lat = tuple(int(s) for s in lattice)
    if len(lat) != 4 or min(lat) < 1:
        raise ValueError(f"the Wilson kernels need a 4-D lattice, got {lat}")
    return lat


_DSLASH_IN, _DSLASH_OUT = ("psi", "u"), ("out",)
_NORMAL_IN, _NORMAL_OUT = ("p", "u"), ("ap",)


def _dslash_canonical(psi: torch.Tensor, u: torch.Tensor, lat) -> torch.Tensor:
    return ref.dslash_ref(psi.reshape((24,) + lat), u.reshape((72,) + lat)).reshape(24, -1)


def dslash_plain(psi: torch.Tensor, u: torch.Tensor, lattice, layouts=None) -> torch.Tensor:
    """psi (24 components), u (72) -> D psi (24), periodic."""
    lat = _check_4d(lattice)
    lay = resolve_layouts(layouts, _DSLASH_IN, _DSLASH_OUT)
    return lay["out"].pack(_dslash_canonical(lay["psi"].unpack(psi), lay["u"].unpack(u), lat))


def dslash_cuda(psi: torch.Tensor, u: torch.Tensor, lattice, vvl: int = 128, *,
                layouts=None) -> torch.Tensor:
    """K4: D psi of a 24-component psi and a 72-component u on a periodic
    lattice; ``layouts`` names "psi", "u", "out"."""
    if psi.device.type == "cpu":
        return dslash_plain(psi, u, lattice, layouts)
    lat = _check_4d(lattice)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _DSLASH_IN, _DSLASH_OUT)
    lpsi = check_field("psi", psi, lay["psi"], 24, V, psi.device)
    lu = check_field("u", u, lay["u"], 72, V, psi.device)
    out = torch.empty(lay["out"].physical_shape(24, V), dtype=psi.dtype, device=psi.device)
    DSLASH.launch(psi.device, psi.data_ptr(), u.data_ptr(), out.data_ptr(),
                  *lat, lpsi, lu, lay["out"].descriptor(), vvl)
    return out


def _m_g5(psi: torch.Tensor, d: torch.Tensor, kappa: float) -> torch.Tensor:
    t = psi - kappa * d
    return torch.cat([t[:12], -t[12:]], dim=0)


def wilson_normal_plain(p: torch.Tensor, u: torch.Tensor, kappa: float,
                        lattice, layouts=None, *,
                        batched: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """t = g5(p - kappa D p), ap = g5(t - kappa D t), pap = sum_sites p*ap;
    ``layouts`` names "p", "u", "ap"; ``batched``: p is stacked spinors, each
    slot computed as alone."""
    if batched:
        outs = [wilson_normal_plain(pb, u, kappa, lattice, layouts) for pb in p]
        return torch.stack([a for a, _ in outs]), torch.stack([s for _, s in outs])
    lat = _check_4d(lattice)
    lay = resolve_layouts(layouts, _NORMAL_IN, _NORMAL_OUT)
    p, u = lay["p"].unpack(p), lay["u"].unpack(u)
    t = _m_g5(p, _dslash_canonical(p, u, lat), kappa)
    ap = _m_g5(t, _dslash_canonical(t, u, lat), kappa)
    return lay["ap"].pack(ap), (p * ap).sum(dim=1)


def wilson_normal_cuda(p: torch.Tensor, u: torch.Tensor, kappa: float, lattice,
                       vvl: int = 128, *, layouts=None,
                       batched: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (ap, pap (24,)) = (M^dag M p, per-component p . ap), in two
    launches and the fold of the pap partials; ``layouts`` names "p", "u",
    "ap" (the intermediate t is SoA).  ``batched`` (K5B): p is ``batch``
    stacked spinors and u shared -> (ap stacked, pap (batch, 24))."""
    if p.device.type == "cpu":
        return wilson_normal_plain(p, u, kappa, lattice, layouts, batched=batched)
    if batched:
        return _wilson_normal_batched(p, u, kappa, lattice, vvl, layouts)
    lat = _check_4d(lattice)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _NORMAL_IN, _NORMAL_OUT)
    lp = check_field("p", p, lay["p"], 24, V, p.device)
    lu = check_field("u", u, lay["u"], 72, V, p.device)
    t = torch.empty((24, V), dtype=p.dtype, device=p.device)
    ap = torch.empty(lay["ap"].physical_shape(24, V), dtype=p.dtype, device=p.device)
    partials = torch.empty((-(-V // vvl), 24), dtype=p.dtype, device=p.device)
    WILSON_NORMAL_T.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(),
                           float(kappa), *lat, lp, lu, vvl)
    WILSON_NORMAL_AP.launch(p.device, p.data_ptr(), t.data_ptr(), u.data_ptr(),
                            ap.data_ptr(), partials.data_ptr(), float(kappa),
                            *lat, lp, lu, lay["ap"].descriptor(), vvl)
    return ap, fold_partials(partials, "sum")


def _wilson_normal_batched(p, u, kappa, lattice, vvl, layouts):
    """K5B: K5 over ``p.shape[0]`` stacked spinors p against one shared u."""
    lat = _check_4d(lattice)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _NORMAL_IN, _NORMAL_OUT)
    batch = p.shape[0]
    lp = check_batched_field("p", p, lay["p"], 24, V, batch, p.device)
    lu = check_field("u", u, lay["u"], 72, V, p.device)
    t = torch.empty((batch, 24, V), dtype=p.dtype, device=p.device)
    ap = torch.empty((batch,) + lay["ap"].physical_shape(24, V), dtype=p.dtype, device=p.device)
    partials = torch.empty((batch, -(-V // vvl), 24), dtype=p.dtype, device=p.device)
    WILSON_NORMAL_T_B.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(), float(kappa),
                             *lat, batch, lp, lu, vvl)
    WILSON_NORMAL_AP_B.launch(p.device, p.data_ptr(), t.data_ptr(), u.data_ptr(), ap.data_ptr(),
                              partials.data_ptr(), float(kappa), *lat, batch, lp, lu,
                              lay["ap"].descriptor(), vvl)
    return ap, fold_partials_batched(partials, "sum")

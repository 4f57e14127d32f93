"""CUDA wrappers for the Ludwig liquid-crystal kernels (``csrc/ludwig_flat.cu``),
each beside its plain PyTorch version (the ``lc.py`` chunk bodies):

  K3L  chem_stress  q, lapq, dq -> h, sigma  (the ludwig_chem_stress graph)
       lc_update    q, h, w, adv -> q_new    (the ludwig_lc_update graph)
  K1L  fed          q, dq -> free-energy density (diagnostics)

K3L replaces ``core/fuse.py::LaunchGraph._build_flat`` of the JAX package
for the two flat Ludwig graphs, K1L ``core/target.py::TargetKernel.
_run_pallas`` for the free-energy body.  Each is one launch, one thread per
site, over SoA fp32 fields.  The reference's Python-float coefficients are
formed here in double with the reference's expressions, and ctypes rounds
each to fp32 as the reference's weak-typed scalars are rounded.

On a CPU tensor each wrapper returns its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch._cuda import Kernel, check_tensor
from . import lc

__all__ = ["chem_stress_cuda", "chem_stress_plain", "lc_update_cuda",
           "lc_update_plain", "fed_cuda", "fed_plain", "CHEM_STRESS",
           "LC_UPDATE", "FED"]

CHEM_STRESS = Kernel("ludwig_chem_stress", "rt_ludwig_chem_stress")
LC_UPDATE = Kernel("ludwig_lc_update", "rt_ludwig_lc_update")
FED = Kernel("ludwig_fed", "rt_ludwig_fed")


def _check(ins, V, device):
    for name, t, ncomp in ins:
        check_tensor(name, t, (ncomp, V), device)


def chem_stress_plain(q, lapq, dq, *, a0, gamma, kappa_m, kappa_s, xi
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h = molecular_field(q, lapq), sigma = stress(q, h, dq)."""
    h = lc.molecular_field_chunk(q, lapq, a0=a0, gamma=gamma, kappa=kappa_m)
    return h, lc.stress_chunk(q, h, dq, kappa=kappa_s, xi=xi)


def chem_stress_cuda(q, lapq, dq, *, a0, gamma, kappa_m, kappa_s, xi, vvl: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3L: (h (5, V), sigma (9, V)) of SoA q (5, V), lapq (5, V), dq (15, V)."""
    if q.device.type == "cpu":
        return chem_stress_plain(q, lapq, dq, a0=a0, gamma=gamma, kappa_m=kappa_m,
                                 kappa_s=kappa_s, xi=xi)
    V = q.shape[-1]
    _check((("q", q, 5), ("lapq", lapq, 5), ("dq", dq, 15)), V, q.device)
    h = torch.empty_like(q)
    sigma = torch.empty((9, V), dtype=q.dtype, device=q.device)
    CHEM_STRESS.launch(q.device, q.data_ptr(), lapq.data_ptr(), dq.data_ptr(),
                       h.data_ptr(), sigma.data_ptr(), V,
                       -a0 * (1.0 - gamma / 3.0), a0 * gamma, -a0 * gamma, kappa_m,
                       -xi, 2.0 * xi, kappa_s, vvl)
    return h, sigma


def lc_update_plain(q, h, w, adv, *, gamma_rot, xi, dt) -> torch.Tensor:
    """q_new = q_update(q, beris_edwards_rhs(q, h, w), adv)."""
    rhs = lc.beris_edwards_rhs_chunk(q, h, w, gamma_rot=gamma_rot, xi=xi)
    return lc.q_update_chunk(q, rhs, adv, dt=dt)


def lc_update_cuda(q, h, w, adv, *, gamma_rot, xi, dt, vvl: int = 128) -> torch.Tensor:
    """K3L: q_new (5, V) of SoA q, h, adv (5, V) and w (9, V)."""
    if q.device.type == "cpu":
        return lc_update_plain(q, h, w, adv, gamma_rot=gamma_rot, xi=xi, dt=dt)
    V = q.shape[-1]
    _check((("q", q, 5), ("h", h, 5), ("w", w, 9), ("adv", adv, 5)), V, q.device)
    q_new = torch.empty_like(q)
    LC_UPDATE.launch(q.device, q.data_ptr(), h.data_ptr(), w.data_ptr(), adv.data_ptr(),
                     q_new.data_ptr(), V, gamma_rot, xi, -2.0 * xi, dt, vvl)
    return q_new


def fed_plain(q, dq, *, a0, gamma, kappa) -> torch.Tensor:
    return lc.free_energy_density_chunk(q, dq, a0=a0, gamma=gamma, kappa=kappa)


def fed_cuda(q, dq, *, a0, gamma, kappa, vvl: int = 128) -> torch.Tensor:
    """K1L: free-energy density (1, V) of SoA q (5, V) and dq (15, V)."""
    if q.device.type == "cpu":
        return fed_plain(q, dq, a0=a0, gamma=gamma, kappa=kappa)
    V = q.shape[-1]
    _check((("q", q, 5), ("dq", dq, 15)), V, q.device)
    fed = torch.empty((1, V), dtype=q.dtype, device=q.device)
    FED.launch(q.device, q.data_ptr(), dq.data_ptr(), fed.data_ptr(), V,
               0.5 * a0 * (1.0 - gamma / 3.0), a0 * gamma / 3.0, 0.25 * a0 * gamma,
               0.5 * kappa, vvl)
    return fed

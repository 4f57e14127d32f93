"""CUDA wrappers for the Ludwig liquid-crystal kernels (``csrc/ludwig_flat.cu``),
each beside its plain PyTorch version (the ``lc.py`` chunk bodies):

  K3L  chem_stress  q, lapq, dq -> h, sigma  (the ludwig_chem_stress graph)
       lc_update    q, h, w, adv -> q_new    (the ludwig_lc_update graph)
  K3C  lc_chain     q, lapq, w, adv -> q_new (the ludwig_lc_chain graph: the
                    molecular field, the BE rhs and the Q update, h and rhs
                    in registers)
  K1L  fed          q, dq -> free-energy density (diagnostics)

K3L's policy instances (``policy=``, a ``core.plan.CudaPolicy``; the same
kernels with their typed loads and stores): each input fp32 or bf16, a bf16
one widened as loaded (exactly), an fp32 one rounded to bf16 first under
bf16 storage, the fields written in bf16 there.  The wrappers run them for
a policy asking for bf16 storage and for any bf16 input; a policy asking
for a compensated sum alone changes nothing (these graphs have no sums).
The plain versions take the same ``policy``.

K3L and K3C replace ``core/fuse.py::LaunchGraph._build_flat`` of the JAX
package for the three flat Ludwig graphs, K1L ``core/target.py::
TargetKernel._run_pallas`` for the free-energy body.  Each is one launch, one thread per
site, over fp32 fields, each in its own layout (SoA, AoS or AoSoA,
addressed through INDEX inside the kernel; one launch may mix layouts).
Each wrapper takes physical tensors and ``layouts`` (names as in its
signature, outputs "h", "sigma", "q_new", "fed"; an input not named is SoA,
an output takes q's layout) and returns physical tensors.  The reference's
Python-float coefficients are formed here in double with the reference's
expressions, and ctypes rounds each to fp32 as the reference's weak-typed
scalars are rounded.

On a CPU tensor each wrapper returns its plain version (unpack, torch ops,
pack); on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._cuda import Kernel, check_field, check_typed_field
from repro_torch.core.fuse import policy_stage_in
from repro_torch.core.layout import resolve_layouts
from repro_torch.core.plan import CudaPolicy
from . import lc

__all__ = ["chem_stress_cuda", "chem_stress_plain", "lc_update_cuda",
           "lc_update_plain", "lc_chain_cuda", "lc_chain_plain", "fed_cuda", "fed_plain",
           "CHEM_STRESS", "LC_UPDATE", "LC_CHAIN", "FED", "CHEM_STRESS_POLICY",
           "LC_UPDATE_POLICY"]

CHEM_STRESS = Kernel("ludwig_chem_stress", "rt_ludwig_chem_stress")
LC_UPDATE = Kernel("ludwig_lc_update", "rt_ludwig_lc_update")
# K3L's policy instances
CHEM_STRESS_POLICY = Kernel("ludwig_chem_stress_policy", "rt_ludwig_chem_stress_policy")
LC_UPDATE_POLICY = Kernel("ludwig_lc_update_policy", "rt_ludwig_lc_update_policy")
LC_CHAIN = Kernel("ludwig_lc_chain", "rt_ludwig_lc_chain")
FED = Kernel("ludwig_fed", "rt_ludwig_fed")


def _fields(named, layouts, outs):
    """(layouts of every tensor, V) of a wrapper call: ``named`` maps input
    names to physical tensors, ``outs`` names the outputs."""
    lay = resolve_layouts(layouts, tuple(named), outs)
    first = next(iter(named))
    _, V = lay[first].logical_shape(named[first].shape)
    return lay, V


def _launch_args(named, ncomps, lay, V):
    """Check each input against its layout; (data pointer, descriptor)
    pairs flattened as pointers then descriptors."""
    device = next(iter(named.values())).device
    descs = [check_field(n, t, lay[n], ncomps[n], V, device) for n, t in named.items()]
    return [t.data_ptr() for t in named.values()], descs


def _empty(lay, name, ncomp, V, like, dtype=None):
    return torch.empty(lay[name].physical_shape(ncomp, V), dtype=dtype or like.dtype,
                       device=like.device)


def _typed(named, policy) -> Tuple[bool, bool]:
    """(run the policy instance, bf16 storage) of a K3L call: the instance
    runs under bf16 storage and for any bf16 input."""
    bf16 = bool(policy and policy.bf16)
    return bf16 or any(t.dtype == torch.bfloat16 for t in named.values()), bf16


def _typed_args(named, ncomps, lay, V):
    """:func:`_launch_args` for the policy instances: each input fp32 or
    bf16; also the bitmask of the bf16 ones, in argument order."""
    device = next(iter(named.values())).device
    ops = [check_typed_field(n, t, lay[n], ncomps[n], V, device) for n, t in named.items()]
    return ([t.data_ptr() for t in named.values()], [d for d, _ in ops],
            sum(1 << k for k, (_, is16) in enumerate(ops) if is16))


def _plain_in(lay, named, bf16):
    """The canonical inputs of a plain version as its kernel reads them."""
    return [policy_stage_in(lay[n].unpack(t), bf16) for n, t in named.items()]


def _plain_out(t, bf16):
    return t.to(torch.bfloat16) if bf16 else t


_CS = {"q": 5, "lapq": 5, "dq": 15}
_LU = {"q": 5, "h": 5, "w": 9, "adv": 5}
_LC = {"q": 5, "lapq": 5, "w": 9, "adv": 5}
_FED = {"q": 5, "dq": 15}


def chem_stress_plain(q, lapq, dq, *, a0, gamma, kappa_m, kappa_s, xi, layouts=None,
                      policy: Optional[CudaPolicy] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h = molecular_field(q, lapq), sigma = stress(q, h, dq).  ``policy``:
    the policy instance's (inputs rounded to bf16 under bf16 storage, a
    bf16 input widened, the fields returned in bf16 there)."""
    named = dict(q=q, lapq=lapq, dq=dq)
    lay, _ = _fields(named, layouts, ("h", "sigma"))
    _, bf16 = _typed(named, policy)
    q, lapq, dq = _plain_in(lay, named, bf16)
    h = lc.molecular_field_chunk(q, lapq, a0=a0, gamma=gamma, kappa=kappa_m)
    sigma = lc.stress_chunk(q, h, dq, kappa=kappa_s, xi=xi)
    return lay["h"].pack(_plain_out(h, bf16)), lay["sigma"].pack(_plain_out(sigma, bf16))


def chem_stress_cuda(q, lapq, dq, *, a0, gamma, kappa_m, kappa_s, xi, vvl: int = 128,
                     layouts=None, policy: Optional[CudaPolicy] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3L: (h (5 components), sigma (9)) of q (5), lapq (5), dq (15);
    ``policy`` as in the module docstring."""
    if q.device.type == "cpu":
        return chem_stress_plain(q, lapq, dq, a0=a0, gamma=gamma, kappa_m=kappa_m,
                                 kappa_s=kappa_s, xi=xi, layouts=layouts, policy=policy)
    named = dict(q=q, lapq=lapq, dq=dq)
    lay, V = _fields(named, layouts, ("h", "sigma"))
    coef = (-a0 * (1.0 - gamma / 3.0), a0 * gamma, -a0 * gamma, kappa_m, -xi, 2.0 * xi, kappa_s)
    typed, bf16 = _typed(named, policy)
    if typed:
        ptrs, descs, in16 = _typed_args(named, _CS, lay, V)
        out_dt = torch.bfloat16 if bf16 else torch.float32
        h, sigma = _empty(lay, "h", 5, V, q, out_dt), _empty(lay, "sigma", 9, V, q, out_dt)
        CHEM_STRESS_POLICY.launch(q.device, *ptrs, h.data_ptr(), sigma.data_ptr(), V, *coef,
                                  in16, int(bf16), int(bf16), *descs, lay["h"].descriptor(),
                                  lay["sigma"].descriptor(), vvl)
        return h, sigma
    ptrs, descs = _launch_args(named, _CS, lay, V)
    h, sigma = _empty(lay, "h", 5, V, q), _empty(lay, "sigma", 9, V, q)
    CHEM_STRESS.launch(q.device, *ptrs, h.data_ptr(), sigma.data_ptr(), V, *coef, *descs,
                       lay["h"].descriptor(), lay["sigma"].descriptor(), vvl)
    return h, sigma


def lc_update_plain(q, h, w, adv, *, gamma_rot, xi, dt, layouts=None,
                    policy: Optional[CudaPolicy] = None) -> torch.Tensor:
    """q_new = q_update(q, beris_edwards_rhs(q, h, w), adv); ``policy`` as
    in :func:`chem_stress_plain`."""
    named = dict(q=q, h=h, w=w, adv=adv)
    lay, _ = _fields(named, layouts, ("q_new",))
    _, bf16 = _typed(named, policy)
    q, h, w, adv = _plain_in(lay, named, bf16)
    rhs = lc.beris_edwards_rhs_chunk(q, h, w, gamma_rot=gamma_rot, xi=xi)
    return lay["q_new"].pack(_plain_out(lc.q_update_chunk(q, rhs, adv, dt=dt), bf16))


def lc_update_cuda(q, h, w, adv, *, gamma_rot, xi, dt, vvl: int = 128,
                   layouts=None, policy: Optional[CudaPolicy] = None) -> torch.Tensor:
    """K3L: q_new (5 components) of q, h, adv (5) and w (9); ``policy`` as
    in the module docstring."""
    if q.device.type == "cpu":
        return lc_update_plain(q, h, w, adv, gamma_rot=gamma_rot, xi=xi, dt=dt,
                               layouts=layouts, policy=policy)
    named = dict(q=q, h=h, w=w, adv=adv)
    lay, V = _fields(named, layouts, ("q_new",))
    typed, bf16 = _typed(named, policy)
    if typed:
        ptrs, descs, in16 = _typed_args(named, _LU, lay, V)
        q_new = _empty(lay, "q_new", 5, V, q, torch.bfloat16 if bf16 else torch.float32)
        LC_UPDATE_POLICY.launch(q.device, *ptrs, q_new.data_ptr(), V, gamma_rot, xi, -2.0 * xi,
                                dt, in16, int(bf16), int(bf16), *descs,
                                lay["q_new"].descriptor(), vvl)
        return q_new
    ptrs, descs = _launch_args(named, _LU, lay, V)
    q_new = _empty(lay, "q_new", 5, V, q)
    LC_UPDATE.launch(q.device, *ptrs, q_new.data_ptr(), V, gamma_rot, xi, -2.0 * xi, dt,
                     *descs, lay["q_new"].descriptor(), vvl)
    return q_new


def lc_chain_plain(q, lapq, w, adv, *, a0, gamma, kappa, gamma_rot, xi, dt, layouts=None
                   ) -> torch.Tensor:
    """q_new = q_update(q, beris_edwards_rhs(q, molecular_field(q, lapq), w),
    adv)."""
    lay, _ = _fields(dict(q=q, lapq=lapq, w=w, adv=adv), layouts, ("q_new",))
    q, lapq, w, adv = (lay[n].unpack(t) for n, t in
                       (("q", q), ("lapq", lapq), ("w", w), ("adv", adv)))
    h = lc.molecular_field_chunk(q, lapq, a0=a0, gamma=gamma, kappa=kappa)
    rhs = lc.beris_edwards_rhs_chunk(q, h, w, gamma_rot=gamma_rot, xi=xi)
    return lay["q_new"].pack(lc.q_update_chunk(q, rhs, adv, dt=dt))


def lc_chain_cuda(q, lapq, w, adv, *, a0, gamma, kappa, gamma_rot, xi, dt, vvl: int = 128,
                  layouts=None) -> torch.Tensor:
    """K3C: q_new (5 components) of q, lapq, adv (5) and w (9), in one
    launch."""
    if q.device.type == "cpu":
        return lc_chain_plain(q, lapq, w, adv, a0=a0, gamma=gamma, kappa=kappa,
                              gamma_rot=gamma_rot, xi=xi, dt=dt, layouts=layouts)
    named = dict(q=q, lapq=lapq, w=w, adv=adv)
    lay, V = _fields(named, layouts, ("q_new",))
    ptrs, descs = _launch_args(named, _LC, lay, V)
    q_new = _empty(lay, "q_new", 5, V, q)
    LC_CHAIN.launch(q.device, *ptrs, q_new.data_ptr(), V, -a0 * (1.0 - gamma / 3.0), a0 * gamma,
                    -a0 * gamma, kappa, gamma_rot, xi, -2.0 * xi, dt, *descs,
                    lay["q_new"].descriptor(), vvl)
    return q_new


def fed_plain(q, dq, *, a0, gamma, kappa, layouts=None) -> torch.Tensor:
    lay, _ = _fields(dict(q=q, dq=dq), layouts, ("fed",))
    return lay["fed"].pack(lc.free_energy_density_chunk(
        lay["q"].unpack(q), lay["dq"].unpack(dq), a0=a0, gamma=gamma, kappa=kappa))


def fed_cuda(q, dq, *, a0, gamma, kappa, vvl: int = 128, layouts=None) -> torch.Tensor:
    """K1L: free-energy density (1 component) of q (5) and dq (15)."""
    if q.device.type == "cpu":
        return fed_plain(q, dq, a0=a0, gamma=gamma, kappa=kappa, layouts=layouts)
    named = dict(q=q, dq=dq)
    lay, V = _fields(named, layouts, ("fed",))
    ptrs, descs = _launch_args(named, _FED, lay, V)
    fed = _empty(lay, "fed", 1, V, q)
    FED.launch(q.device, *ptrs, fed.data_ptr(), V,
               0.5 * a0 * (1.0 - gamma / 3.0), a0 * gamma / 3.0, 0.25 * a0 * gamma,
               0.5 * kappa, *descs, lay["fed"].descriptor(), vvl)
    return fed

"""Public wrapper for the Wilson-Dirac operator (engine dispatch), plus the
stencil-stage body that lets dslash join fused launch graphs (core.fuse)."""

from __future__ import annotations

import math

import torch

from repro_torch.core import SOA, Field, TargetConfig
from repro_torch.core.plan import plan_for_launch
from repro_torch.core.target import require_cuda
from . import kernel, ref


def dslash_stencil_body(v, gather):
    """Fused-graph stencil stage: v = {"psi": (24, *win), "u": (72, *win)}.

    Gathers the 8 neighbour spinors and the backward gauge links from the
    halo'd window (width 1), then runs the site-local hopping term —
    returns {"d": D psi (24, *win_out)}."""
    packs = []
    for mu in range(4):
        e = [0, 0, 0, 0]
        e[mu] = 1
        # psi(x + mu): out(r) = in(r - d) with d = -e
        packs.append(gather("psi", tuple(-x for x in e)))
        packs.append(gather("psi", tuple(e)))
    nbrs = torch.cat(packs, dim=0)                              # (192, *win)
    u_fwd = v["u"]
    u_bwd = torch.cat(
        [gather("u", (0,) * mu + (1,) + (0,) * (3 - mu))[mu * 18:(mu + 1) * 18]
         for mu in range(4)],
        dim=0,
    )                                                           # (72, *win)
    win = tuple(u_fwd.shape[1:])

    def flat(a):
        return a.reshape(a.shape[0], -1)

    out = ref.dslash_site_chunk(flat(u_fwd), flat(u_bwd), flat(nbrs))
    return {"d": out.reshape((ref.SPINOR_NCOMP,) + win)}


def dslash(psi: Field, u: Field, *, config: TargetConfig) -> Field:
    """D psi on a single device (periodic). psi: 24-comp, u: 72-comp fields
    over a 4-D lattice."""
    plan = plan_for_launch(config, psi.nsites, [psi.layout, u.layout])
    if plan.engine == "torch":
        out = ref.dslash_ref(psi.canonical_nd(), u.canonical_nd())
        return psi.with_canonical(out.reshape(psi.ncomp, psi.nsites))
    require_cuda("psi", psi.data)
    require_cuda("u", u.data)
    return psi.with_data(kernel.dslash_cuda(
        psi.data, u.data, psi.lattice, vvl=plan.vvl,
        layouts={"psi": psi.layout, "u": u.layout, "out": psi.layout}))


def dslash_halo(psi_h: torch.Tensor, u_h: torch.Tensor, *, config: TargetConfig,
                width: int = 1) -> torch.Tensor:
    """The halo'd-array form of the sharded path: psi_h (24, X+2w, ...) and
    u_h (72, ...) canonical with their halos exchanged -> the interior
    D psi (24, X, Y, Z, T).  On "cuda" K4H, from the halo'd arrays in place
    of the reference's gather + ``dslash_site_pallas``."""
    nsites = math.prod(s - 2 * width for s in psi_h.shape[1:])
    # the halo kernels check their last block's bounds: vvl need not divide
    plan = plan_for_launch(config, nsites, [SOA], bounded=True)
    if plan.engine == "torch":
        return kernel.dslash_halo_plain(psi_h, u_h, width)
    require_cuda("psi_h", psi_h)
    require_cuda("u_h", u_h)
    return kernel.dslash_halo_cuda(psi_h, u_h, width, vvl=plan.vvl)


def wilson_matvec(psi: Field, u: Field, *, kappa: float, config: TargetConfig) -> Field:
    """M psi = psi - kappa D psi."""
    d = dslash(psi, u, config=config)
    return psi.with_canonical(psi.canonical() - kappa * d.canonical())

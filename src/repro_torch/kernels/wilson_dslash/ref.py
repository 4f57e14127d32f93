"""Pure-torch oracle for the Wilson-Dirac hopping term (MILC).

D psi(x) = sum_mu [ (1 - gamma_mu) U_mu(x)        psi(x + mu)
                  + (1 + gamma_mu) U_mu^dag(x-mu) psi(x - mu) ]

``dslash_site_chunk`` fuses the site-local parts (spin projection, SU(3)
multiply, reconstruction) on canonical tensors; ``dslash_ref`` adds the
periodic neighbour gather and is the end-to-end oracle.

Storage (fp32 pairs):
  spinor field  ncomp = 24: index = (spin*3 + color)*2 + reim
  gauge field   ncomp = 72: index = ((mu*3 + a)*3 + b)*2 + reim
  neighbour pack ncomp = 192: mu-major, forward then backward spinor.
"""

from __future__ import annotations

import torch

from repro_torch.core import stencil
from repro_torch.maths import su3

NSPIN, NCOL = 4, 3
SPINOR_NCOMP = NSPIN * NCOL * 2      # 24
GAUGE_NCOMP = 4 * NCOL * NCOL * 2    # 72
NBR_NCOMP = 8 * SPINOR_NCOMP         # 192


def spinor_pair(chunk: torch.Tensor) -> su3.Pair:
    """(24, ...) -> ((4,3,...), (4,3,...))."""
    s = chunk.reshape((NSPIN, NCOL, 2) + tuple(chunk.shape[1:]))
    return s[:, :, 0], s[:, :, 1]


def pair_spinor(p: su3.Pair) -> torch.Tensor:
    """((4,3,...), (4,3,...)) -> (24, ...)."""
    re, im = p
    out = torch.stack([re, im], dim=2)  # (4,3,2,...)
    return out.reshape((SPINOR_NCOMP,) + tuple(re.shape[2:]))


def gauge_pair(chunk: torch.Tensor, mu: int) -> su3.Pair:
    """(72, ...) -> ((3,3,...), (3,3,...)) link for direction mu."""
    g = chunk.reshape((4, NCOL, NCOL, 2) + tuple(chunk.shape[1:]))
    return g[mu, :, :, 0], g[mu, :, :, 1]


def dslash_site_chunk(u_fwd: torch.Tensor, u_bwd: torch.Tensor,
                      nbrs: torch.Tensor) -> torch.Tensor:
    """Fused project/mult/reconstruct over all 8 directions.

    u_fwd (72, L) U_mu(x);  u_bwd (72, L) U_mu(x - mu);
    nbrs  (192, L) [psi(x+mu), psi(x-mu)] per mu.
    Returns D psi (24, L)."""
    acc = None
    for mu in range(4):
        fwd = spinor_pair(nbrs[mu * 48: mu * 48 + 24])
        bwd = spinor_pair(nbrs[mu * 48 + 24: mu * 48 + 48])
        u = gauge_pair(u_fwd, mu)
        ub = gauge_pair(u_bwd, mu)
        # forward: (1 - gamma_mu) U psi(x+mu); project first (halves work)
        full = su3.reconstruct_minus(
            su3.su3_mult_halfspinor(u, su3.project_minus(fwd, mu)), mu)
        # backward: (1 + gamma_mu) U^dag psi(x-mu)
        fullb = su3.reconstruct_plus(
            su3.su3_adj_mult_halfspinor(ub, su3.project_plus(bwd, mu)), mu)
        term = su3.cadd(full, fullb)
        acc = term if acc is None else su3.cadd(acc, term)
    return pair_spinor(acc)


def gather_neighbours_periodic(psi_nd: torch.Tensor) -> torch.Tensor:
    """psi_nd (24, X, Y, Z, T) -> nbr pack (192, X, Y, Z, T), periodic."""
    packs = []
    for mu in range(4):
        e = [0, 0, 0, 0]
        e[mu] = 1
        # psi(x + mu): out(r) = in(r - disp) with disp = -e
        packs.append(stencil.shift_periodic(psi_nd, [-x for x in e]))
        packs.append(stencil.shift_periodic(psi_nd, e))
    return torch.cat(packs, dim=0)


def gather_gauge_bwd_periodic(u_nd: torch.Tensor) -> torch.Tensor:
    """U_mu(x - mu) per mu: shift each direction's links forward."""
    outs = []
    for mu in range(4):
        e = [0, 0, 0, 0]
        e[mu] = 1
        outs.append(stencil.shift_periodic(u_nd[mu * 18:(mu + 1) * 18], e))
    return torch.cat(outs, dim=0)


def dslash_ref(psi_nd: torch.Tensor, u_nd: torch.Tensor) -> torch.Tensor:
    """Full periodic D psi. psi_nd (24, X,Y,Z,T), u_nd (72, X,Y,Z,T)."""
    lat = tuple(psi_nd.shape[1:])
    nbrs = gather_neighbours_periodic(psi_nd)
    u_bwd = gather_gauge_bwd_periodic(u_nd)

    def flat(a):
        return a.reshape(a.shape[0], -1)

    out = dslash_site_chunk(flat(u_nd), flat(u_bwd), flat(nbrs))
    return out.reshape((SPINOR_NCOMP,) + lat)


def wilson_matvec_ref(psi_nd: torch.Tensor, u_nd: torch.Tensor,
                      kappa: float) -> torch.Tensor:
    """M psi = psi - kappa * D psi (MILC's Wilson matrix convention)."""
    return psi_nd - kappa * dslash_ref(psi_nd, u_nd)

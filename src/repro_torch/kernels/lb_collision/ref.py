"""Pure-torch oracle for the D3Q19 BGK collision with Guo forcing.

This is Ludwig's "Collision" kernel (paper §2.1.1): site-local, the most
FLOP-dense part of the LB update.  ``collide_chunk`` works on canonical
(ncomp, sites) tensors and is both the "torch" engine and the plain
version K7 (``csrc/lb.cu``) is held against.

The velocity set is unrolled with Python-int coefficients (c_ia in
{-1, 0, 1}) exactly as the JAX package's oracle is, term by term and in the
same order, so both do the same fp32 arithmetic: dot products with c_i are
adds and subtracts, and every Python-float coefficient enters as one fp32
scalar.
"""

from __future__ import annotations

import torch

from repro_torch.maths import d3q19

_CV = [tuple(int(c) for c in row) for row in d3q19.CV]
_WV = [float(w) for w in d3q19.WV]


def _cdot(c, vec3):
    """c . vec with c in {-1,0,1}^3 and vec3 a list of 3 tensors."""
    out = None
    for ca, va in zip(c, vec3):
        if ca == 0:
            continue
        term = va if ca == 1 else -va
        out = term if out is None else out + term
    if out is None:
        return torch.zeros_like(vec3[0])
    return out


def _density(f: torch.Tensor) -> torch.Tensor:
    """rho = sum_i f_i, added in velocity order.  ``torch.sum`` over the
    velocity axis rounds differently with the number of sites in the chunk
    (its vectorized reduction handles a ragged tail apart), so the same
    site would get other bits under another tiling; the JAX package's
    ``jnp.sum`` adds in this order."""
    rho = f[0]
    for i in range(1, f.shape[0]):
        rho = rho + f[i]
    return rho


def _momentum(f: torch.Tensor):
    """sum_i c_i f_i per axis, unrolled in velocity order."""
    mom = [None, None, None]
    for i, c in enumerate(_CV):
        for a in range(3):
            if c[a]:
                term = f[i] if c[a] == 1 else -f[i]
                mom[a] = term if mom[a] is None else mom[a] + term
    return mom


def collide_chunk(f: torch.Tensor, force: torch.Tensor, tau: float) -> torch.Tensor:
    """BGK collision + Guo forcing on a chunk of sites.

    f      (19, L) distributions
    force  (3, L)  body force (e.g. divergence of the chemical stress)
    tau    relaxation time (static)
    returns (19, L) post-collision distributions
    """
    rho = _density(f)
    mom = _momentum(f)
    frc = [force[a] for a in range(3)]
    u = [(mom[a] + 0.5 * frc[a]) / rho for a in range(3)]

    usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    uf = u[0] * frc[0] + u[1] * frc[1] + u[2] * frc[2]
    pref = 1.0 - 0.5 / tau
    omega = 1.0 / tau

    outs = []
    for i, c in enumerate(_CV):
        w = _WV[i]
        cu = _cdot(c, u)
        cf = _cdot(c, frc)
        feq = w * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
        fi = pref * w * (3.0 * (cf - uf) + 9.0 * cu * cf)
        outs.append(f[i] - omega * (f[i] - feq) + fi)
    return torch.stack(outs)


def collide_ref(f: torch.Tensor, force: torch.Tensor, tau: float) -> torch.Tensor:
    """Oracle on the full canonical lattice (19, N) x (3, N)."""
    return collide_chunk(f, force, tau)


def moments(f: torch.Tensor):
    """(rho, u (3, N)) hydrodynamic moments of (19, N) distributions."""
    rho = _density(f)
    mom = _momentum(f)
    u = torch.stack([mom[a] / rho for a in range(3)])
    return rho, u


def equilibrium(rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """f_eq for given (rho (N,), u (3, N)) — initialization helper."""
    ul = [u[a] for a in range(3)]
    usq = ul[0] * ul[0] + ul[1] * ul[1] + ul[2] * ul[2]
    outs = []
    for i, c in enumerate(_CV):
        cu = _cdot(c, ul)
        outs.append(_WV[i] * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq))
    return torch.stack(outs)

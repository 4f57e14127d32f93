r"""SU(3) x Dirac algebra on split re/im tensors.

Conventions (MILC/DeGrand-Rossi basis):
  - A Wilson spinor at a site is psi[s, c] with s in 0..3 (spin), c in 0..2
    (color), complex.  Stored as two real tensors (re, im) of shape
    (4, 3, ...) where ... are site dims.
  - A gauge link is U[a, b], 3x3 complex, stored as (3, 3, ...) pairs.
  - gamma matrices in the DeGrand-Rossi basis; the Wilson hopping term uses
    the spin projectors P^\mp_mu = (1 -+ gamma_mu)/2 to halve the work.

Colour contractions are written as broadcast products and sums, so no
matrix-multiply backend (and no TF32) is involved on any device.  This is
the plain version the CUDA site function (``csrc/wilson.cuh``) is held
against.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Pair = Tuple[torch.Tensor, torch.Tensor]  # (re, im)


def cmul(a: Pair, b: Pair) -> Pair:
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def cmul_conj(a: Pair, b: Pair) -> Pair:
    """conj(a) * b."""
    ar, ai = a
    br, bi = b
    return ar * br + ai * bi, ar * bi - ai * br


def cadd(a: Pair, b: Pair) -> Pair:
    return a[0] + b[0], a[1] + b[1]


def csub(a: Pair, b: Pair) -> Pair:
    return a[0] - b[0], a[1] - b[1]


def cscale(a: Pair, s) -> Pair:
    return a[0] * s, a[1] * s


def ci_mul(a: Pair) -> Pair:
    """i * a."""
    return -a[1], a[0]


def cneg_i_mul(a: Pair) -> Pair:
    """-i * a."""
    return a[1], -a[0]


# -- SU(3) action on color vectors ------------------------------------------------

def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_b m[a, b] v[b]: m (3,3,...), v (3,...) -> (3,...)."""
    return (m * v.unsqueeze(0)).sum(dim=1)


def _mtv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_b m[b, a] v[b]."""
    return (m * v.unsqueeze(1)).sum(dim=0)


def _mh(m: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """sum_b m[a, b] h[s, b]: m (3,3,...), h (s,3,...) -> (s,3,...)."""
    return (m.unsqueeze(0) * h.unsqueeze(1)).sum(dim=2)


def _mth(m: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """sum_b m[b, a] h[s, b]."""
    return (m.unsqueeze(0) * h.unsqueeze(2)).sum(dim=1)


def su3_mult_vec(u: Pair, v: Pair) -> Pair:
    """(U v): u = (3,3,...), v = (3,...) -> (3,...)."""
    ur, ui = u
    vr, vi = v
    return _mv(ur, vr) - _mv(ui, vi), _mv(ur, vi) + _mv(ui, vr)


def su3_adj_mult_vec(u: Pair, v: Pair) -> Pair:
    """(U^dagger v)."""
    ur, ui = u
    vr, vi = v
    return _mtv(ur, vr) + _mtv(ui, vi), _mtv(ur, vi) - _mtv(ui, vr)


def su3_mult_halfspinor(u: Pair, h: Pair) -> Pair:
    """(U h) with an explicit leading spin axis: u (3,3,...), h (s,3,...)."""
    ur, ui = u
    hr, hi = h
    return _mh(ur, hr) - _mh(ui, hi), _mh(ur, hi) + _mh(ui, hr)


def su3_adj_mult_halfspinor(u: Pair, h: Pair) -> Pair:
    """(U^dagger h) with an explicit leading spin axis."""
    ur, ui = u
    hr, hi = h
    return _mth(ur, hr) + _mth(ui, hi), _mth(ur, hi) - _mth(ui, hr)


# -- Wilson spin projection (DeGrand-Rossi gamma basis) -----------------------------
#
# gamma_x = [[0,0,0,i],[0,0,i,0],[0,-i,0,0],[-i,0,0,0]]
# gamma_y = [[0,0,0,-1],[0,0,1,0],[0,1,0,0],[-1,0,0,0]]
# gamma_z = [[0,0,i,0],[0,0,0,-i],[-i,0,0,0],[0,i,0,0]]
# gamma_t = [[0,0,1,0],[0,0,0,1],[1,0,0,0],[0,1,0,0]]
#
# "project" returns the upper two spin rows of (1 -+ gamma_mu) psi,
# "reconstruct" rebuilds all four.

def _sp(psi: Pair, s: int) -> Pair:
    return psi[0][s], psi[1][s]


def _stack2(h0: Pair, h1: Pair) -> Pair:
    return torch.stack([h0[0], h1[0]]), torch.stack([h0[1], h1[1]])


def _stack4(h0, h1, p2, p3) -> Pair:
    return (torch.stack([h0[0], h1[0], p2[0], p3[0]]),
            torch.stack([h0[1], h1[1], p2[1], p3[1]]))


def project_minus(psi: Pair, mu: int) -> Pair:
    """h = upper two spin rows of (1 - gamma_mu) psi. psi: (4,3,...)."""
    p0, p1, p2, p3 = (_sp(psi, s) for s in range(4))
    if mu == 0:  # x: h0 = p0 - i p3, h1 = p1 - i p2
        h0, h1 = csub(p0, ci_mul(p3)), csub(p1, ci_mul(p2))
    elif mu == 1:  # y: h0 = p0 + p3, h1 = p1 - p2
        h0, h1 = cadd(p0, p3), csub(p1, p2)
    elif mu == 2:  # z: h0 = p0 - i p2, h1 = p1 + i p3
        h0, h1 = csub(p0, ci_mul(p2)), cadd(p1, ci_mul(p3))
    else:  # t: h0 = p0 - p2, h1 = p1 - p3
        h0, h1 = csub(p0, p2), csub(p1, p3)
    return _stack2(h0, h1)


def project_plus(psi: Pair, mu: int) -> Pair:
    """h = upper two spin rows of (1 + gamma_mu) psi."""
    p0, p1, p2, p3 = (_sp(psi, s) for s in range(4))
    if mu == 0:
        h0, h1 = cadd(p0, ci_mul(p3)), cadd(p1, ci_mul(p2))
    elif mu == 1:
        h0, h1 = csub(p0, p3), cadd(p1, p2)
    elif mu == 2:
        h0, h1 = cadd(p0, ci_mul(p2)), csub(p1, ci_mul(p3))
    else:
        h0, h1 = cadd(p0, p2), cadd(p1, p3)
    return _stack2(h0, h1)


def reconstruct_minus(h: Pair, mu: int) -> Pair:
    """Rebuild the 4-spinor (1 - gamma_mu) psi from its half-spinor h."""
    h0 = (h[0][0], h[1][0])
    h1 = (h[0][1], h[1][1])
    if mu == 0:  # p2 = i h1, p3 = i h0
        p2, p3 = ci_mul(h1), ci_mul(h0)
    elif mu == 1:  # p2 = -h1, p3 = h0
        p2, p3 = cscale(h1, -1.0), h0
    elif mu == 2:  # p2 = i h0, p3 = -i h1
        p2, p3 = ci_mul(h0), cneg_i_mul(h1)
    else:  # t: p2 = -h0, p3 = -h1
        p2, p3 = cscale(h0, -1.0), cscale(h1, -1.0)
    return _stack4(h0, h1, p2, p3)


def reconstruct_plus(h: Pair, mu: int) -> Pair:
    """Rebuild the 4-spinor (1 + gamma_mu) psi from its half-spinor h."""
    h0 = (h[0][0], h[1][0])
    h1 = (h[0][1], h[1][1])
    if mu == 0:
        p2, p3 = cneg_i_mul(h1), cneg_i_mul(h0)
    elif mu == 1:
        p2, p3 = h1, cscale(h0, -1.0)
    elif mu == 2:
        p2, p3 = cneg_i_mul(h0), ci_mul(h1)
    else:
        p2, p3 = h0, h1
    return _stack4(h0, h1, p2, p3)


def gamma_dense(mu: int) -> np.ndarray:
    """Dense gamma_mu (numpy complex128), for oracle checks in tests."""
    i = 1j
    g = {
        0: [[0, 0, 0, i], [0, 0, i, 0], [0, -i, 0, 0], [-i, 0, 0, 0]],
        1: [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]],
        2: [[0, 0, i, 0], [0, 0, 0, -i], [-i, 0, 0, 0], [0, i, 0, 0]],
        3: [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]],
    }[mu]
    return np.array(g, dtype=np.complex128)

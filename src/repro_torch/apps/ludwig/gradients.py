"""Stencil stages of the Ludwig timestep ("Order Parameter Gradients",
stress divergence, velocity gradients, "Advection" fluxes).

Central second-order differences, matching Ludwig's default finite
differences, as periodic torch ops over ``core.stencil.shift_periodic``.
The JAX package computes these with jnp ops outside any Pallas kernel, so
they have no hand-written kernel on either engine.  The halo'd-window
variants (``*_halo``) read displaced interior windows of an exchanged
halo'd array (``core.stencil.shifted_window``).
"""

from __future__ import annotations

import torch

from repro_torch.core import stencil


_SITE_DIMS3 = (1, 2, 3)


def _sh(x, disp):
    """shift_periodic shorthand: result(r) = x(r - disp)."""
    return stencil.shift_periodic(x, disp)


def _e(a: int, s: int):
    d = [0, 0, 0]
    d[a] = s
    return d


def grad_central(x_nd: torch.Tensor) -> torch.Tensor:
    """(n, X, Y, Z) -> (3*n, X, Y, Z): [d/dx (n), d/dy (n), d/dz (n)].

    d_a f(r) = (f(r + e_a) - f(r - e_a)) / 2 ; f(r + e_a) = _sh(x, -e_a).
    """
    outs = []
    for a in range(3):
        outs.append(0.5 * (_sh(x_nd, _e(a, -1)) - _sh(x_nd, _e(a, 1))))
    return torch.cat(outs, dim=0)


def laplacian(x_nd: torch.Tensor) -> torch.Tensor:
    """Standard 7-point Laplacian, (n, X, Y, Z) -> (n, X, Y, Z)."""
    acc = -6.0 * x_nd
    for a in range(3):
        acc = acc + _sh(x_nd, _e(a, 1)) + _sh(x_nd, _e(a, -1))
    return acc


def divergence(t9_nd: torch.Tensor) -> torch.Tensor:
    """Force from stress: (9, X, Y, Z) row-major sigma_ab -> F_a = d_b sigma_ab."""
    outs = []
    for a in range(3):
        acc = 0.0
        for b in range(3):
            s = t9_nd[a * 3 + b : a * 3 + b + 1]
            acc = acc + 0.5 * (_sh(s, _e(b, -1)) - _sh(s, _e(b, 1)))
        outs.append(acc[0])
    return torch.stack(outs)


def advective_divergence(q_nd: torch.Tensor, u_nd: torch.Tensor) -> torch.Tensor:
    """Ludwig "Advection": finite-volume upwind flux divergence of Q.

    Face flux at (r-1/2 -> r) in dim a uses the upwind Q per the face
    velocity (average of adjacent u).  Returns div(u Q), (5, X, Y, Z).
    """
    out = 0.0
    for a in range(3):
        u_a = u_nd[a : a + 1]
        u_face_lo = 0.5 * (u_a + _sh(u_a, _e(a, 1)))      # face (r-1/2)
        q_up_lo = torch.where(u_face_lo > 0, _sh(q_nd, _e(a, 1)), q_nd)
        flux_lo = u_face_lo * q_up_lo
        flux_hi = _sh(flux_lo, _e(a, -1))                  # face (r+1/2)
        out = out + (flux_hi - flux_lo)
    return out


# -- halo'd-window variants (the sharded path; width-2 halos for fluxes) -----

def grad_central_halo(x_halo: torch.Tensor, width: int) -> torch.Tensor:
    """:func:`grad_central` on the interior of a halo'd (n, X+2w, Y+2w,
    Z+2w) array whose halos are exchanged -> (3*n, X, Y, Z)."""
    w = width
    outs = []
    for a in range(3):
        outs.append(0.5 * (stencil.shifted_window(x_halo, _e(a, -1), w, _SITE_DIMS3)
                           - stencil.shifted_window(x_halo, _e(a, 1), w, _SITE_DIMS3)))
    return torch.cat(outs, dim=0)


def laplacian_halo(x_halo: torch.Tensor, width: int) -> torch.Tensor:
    """:func:`laplacian` on the interior of a halo'd array."""
    w = width
    acc = -6.0 * stencil.shifted_window(x_halo, (0, 0, 0), w, _SITE_DIMS3)
    for a in range(3):
        acc = (acc + stencil.shifted_window(x_halo, _e(a, 1), w, _SITE_DIMS3)
               + stencil.shifted_window(x_halo, _e(a, -1), w, _SITE_DIMS3))
    return acc

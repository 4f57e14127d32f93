"""Liquid-crystal (Landau-de Gennes / Beris-Edwards) site-local physics.

The Q order parameter is a symmetric traceless 3x3 tensor stored as a
5-component Field (XX, XY, XZ, YY, YZ; ZZ = -XX-YY).  All functions here
are site-local chunk bodies on canonical (ncomp, L) tensors: the "torch"
engine runs them, and they are the plain versions K3L and K1L
(``csrc/ludwig_flat.cu``) are held against.  The 3x3 algebra is unrolled
over Python-int indices, term by term as in the JAX package, so both do the
same fp32 arithmetic.

Physics (one-constant approximation, Ludwig defaults):
  free energy  F = A0/2 (1 - g/3) trQ^2 - A0 g/3 trQ^3 + A0 g/4 (trQ^2)^2
               + kappa/2 (grad Q)^2
  molecular field  H = -A0(1-g/3) Q + A0 g [Q^2 - I trQ^2/3] - A0 g Q trQ^2
                   + kappa lap Q
  Beris-Edwards    dQ/dt + u.grad Q - S(W, Q) = Gamma H
  S(W,Q) = (xi D + Om)(Q + I/3) + (Q + I/3)(xi D - Om) - 2 xi (Q+I/3) tr(QW)
  stress  sigma = -P0 I - xi H(Q+I/3) - xi (Q+I/3)H + 2 xi (Q+I/3) tr(QH)
                + Q H - H Q - kappa (grad_a Q)(grad_b Q)
  force on fluid  F_a = d_b sigma_ab   (the "Chemical Stress" divergence)
"""

from __future__ import annotations

from typing import List

import torch

NQCOMP = 5
_IDX5 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2)]


# -- 3x3 algebra on nested Python lists of (L,) tensors ------------------------

def q5_to_mat(q) -> List[List[torch.Tensor]]:
    q0, q1, q2, q3, q4 = (q[i] for i in range(5))
    qzz = -q0 - q3
    return [[q0, q1, q2], [q1, q3, q4], [q2, q4, qzz]]


def mat_to_q5(m) -> torch.Tensor:
    return torch.stack([m[a][b] for (a, b) in _IDX5])


def mat_mul(a, b):
    return [
        [sum(a[i][k] * b[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]


def mat_add(a, b):
    return [[a[i][j] + b[i][j] for j in range(3)] for i in range(3)]


def mat_sub(a, b):
    return [[a[i][j] - b[i][j] for j in range(3)] for i in range(3)]


def mat_scale(a, s):
    return [[a[i][j] * s for j in range(3)] for i in range(3)]


def mat_trace(a):
    return a[0][0] + a[1][1] + a[2][2]


def mat_transpose(a):
    return [[a[j][i] for j in range(3)] for i in range(3)]


def mat_add_diag(a, s):
    """a + s * I (s scalar or (L,) tensor)."""
    out = [[a[i][j] for j in range(3)] for i in range(3)]
    for i in range(3):
        out[i][i] = out[i][i] + s
    return out


def traceless_sym(m):
    """Project to symmetric traceless (numerical hygiene after updates)."""
    sym = [[0.5 * (m[i][j] + m[j][i]) for j in range(3)] for i in range(3)]
    tr3 = mat_trace(sym) / 3.0
    return mat_add_diag(sym, -tr3)


# -- site-local physics chunks ---------------------------------------------------

def molecular_field_chunk(q5, lapq5, *, a0: float, gamma: float, kappa: float):
    """H = bulk(Q) + kappa lap Q.  q5/lapq5: (5, L) -> (5, L)."""
    Q = q5_to_mat(q5)
    QQ = mat_mul(Q, Q)
    trQ2 = mat_trace(QQ)
    # A0 g [Q^2 - I trQ^2/3]
    bulk2 = mat_add_diag(QQ, -trQ2 / 3.0)
    H = mat_add(
        mat_scale(Q, -a0 * (1.0 - gamma / 3.0)),
        mat_scale(bulk2, a0 * gamma),
    )
    H = mat_add(H, mat_scale(Q, -a0 * gamma * trQ2))
    Hel = q5_to_mat(lapq5)
    H = mat_add(H, mat_scale(Hel, kappa))
    return mat_to_q5(traceless_sym(H))


def free_energy_density_chunk(q5, dq15, *, a0: float, gamma: float, kappa: float):
    """Landau-de Gennes free-energy density (1, L) — the scalar diagnostic
    reduced with target_sum."""
    Q = q5_to_mat(q5)
    QQ = mat_mul(Q, Q)
    trQ2 = mat_trace(QQ)
    trQ3 = mat_trace(mat_mul(QQ, Q))
    bulk = (
        0.5 * a0 * (1.0 - gamma / 3.0) * trQ2
        - (a0 * gamma / 3.0) * trQ3
        + 0.25 * a0 * gamma * trQ2 * trQ2
    )
    # elastic: kappa/2 sum_a sum_ij (d_a Q_ij)^2; dq15 is (3*5, L), expanded
    # to the full 3x3 so off-diagonals count twice and ZZ is included
    el = 0.0
    for a in range(3):
        dQ = q5_to_mat(dq15[a * 5 : (a + 1) * 5])
        for i in range(3):
            for j in range(3):
                el = el + dQ[i][j] * dQ[i][j]
    return (bulk + 0.5 * kappa * el)[None, :]


def stress_chunk(q5, h5, dq15, *, kappa: float, xi: float, p0: float = 0.0):
    """Chemical stress sigma_ab (9, L), row-major ab.  dq15 = d_a Q (3*5)."""
    Q = q5_to_mat(q5)
    H = q5_to_mat(h5)
    Qi = mat_add_diag(Q, 1.0 / 3.0)  # Q + I/3
    trQH = mat_trace(mat_mul(Q, H))

    s = mat_scale(mat_add(mat_mul(H, Qi), mat_mul(Qi, H)), -xi)
    s = mat_add(s, mat_scale(Qi, 2.0 * xi * trQH))
    s = mat_add(s, mat_sub(mat_mul(Q, H), mat_mul(H, Q)))  # antisymmetric part

    # elastic distortion stress: - kappa d_a Q_gd d_b Q_gd
    dQ = [q5_to_mat(dq15[a * 5 : (a + 1) * 5]) for a in range(3)]
    for a in range(3):
        for b in range(3):
            grad2 = 0.0
            for g in range(3):
                for d in range(3):
                    grad2 = grad2 + dQ[a][g][d] * dQ[b][g][d]
            s[a][b] = s[a][b] - kappa * grad2
    s = mat_add_diag(s, -p0)
    return torch.stack([s[a][b] for a in range(3) for b in range(3)])


def beris_edwards_rhs_chunk(q5, h5, w9, *, gamma_rot: float, xi: float):
    """dQ/dt (minus advection) = Gamma H + S(W, Q).  w9 = d_b u_a row-major
    (a, b) -> W[a][b] = du_a/dx_b."""
    Q = q5_to_mat(q5)
    H = q5_to_mat(h5)
    W = [[w9[a * 3 + b] for b in range(3)] for a in range(3)]
    Wt = mat_transpose(W)
    D = mat_scale(mat_add(W, Wt), 0.5)
    Om = mat_scale(mat_sub(W, Wt), 0.5)
    Qi = mat_add_diag(Q, 1.0 / 3.0)

    t1 = mat_mul(mat_add(mat_scale(D, xi), Om), Qi)
    t2 = mat_mul(Qi, mat_sub(mat_scale(D, xi), Om))
    trQW = mat_trace(mat_mul(Q, W))
    t3 = mat_scale(Qi, -2.0 * xi * trQW)
    S = mat_add(mat_add(t1, t2), t3)

    rhs = mat_add(mat_scale(H, gamma_rot), S)
    return mat_to_q5(traceless_sym(rhs))


def q_update_chunk(q5, rhs5, advflux5, *, dt: float):
    """LC Update: Q <- Q + dt (rhs - div adv_flux); advflux5 precomputed
    divergence (5, L)."""
    q0 = q5 + dt * (rhs5 - advflux5)
    return mat_to_q5(traceless_sym(q5_to_mat(q0)))

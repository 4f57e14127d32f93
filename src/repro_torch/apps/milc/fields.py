"""MILC field utilities: random SU(3) gauge configurations and spinors.

A numpy copy of the JAX package's generator: the same seed and lattice give
the same bits.

Storage conventions follow repro_torch.kernels.wilson_dslash.ref: spinors are
24-component Fields ((spin*3+color)*2 + reim), gauge links 72-component
(((mu*3+a)*3+b)*2 + reim), over a 4-D lattice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_su3_gauge(lattice: Tuple[int, int, int, int], seed: int = 0,
                     hot: float = 1.0) -> np.ndarray:
    """(72, X, Y, Z, T) float32: independent SU(3) per site/direction.

    hot=1: fully random ("hot start"); hot=0: unit gauge ("cold start");
    intermediate values interpolate by scaling the anti-hermitian generator.
    """
    rng = np.random.default_rng(seed)
    vol = int(np.prod(lattice))
    # random anti-hermitian traceless generators -> expm -> SU(3)
    a = rng.normal(size=(4 * vol, 3, 3)) + 1j * rng.normal(size=(4 * vol, 3, 3))
    ah = 0.5 * (a - np.conj(np.transpose(a, (0, 2, 1))))
    tr = np.trace(ah, axis1=1, axis2=2) / 3.0
    ah -= tr[:, None, None] * np.eye(3)[None]
    # scale controls disorder
    ah *= hot
    # 3x3 expm via scaling-and-squaring on small matrices
    u = _expm3(ah)
    u = u.reshape((4,) + tuple(lattice) + (3, 3))
    out = np.empty((4, 3, 3, 2) + tuple(lattice), np.float32)
    um = np.moveaxis(u, (-2, -1), (1, 2))  # (4, 3, 3, X,Y,Z,T)
    out[:, :, :, 0] = um.real
    out[:, :, :, 1] = um.imag
    return out.reshape((72,) + tuple(lattice))


def _expm3(a: np.ndarray) -> np.ndarray:
    """expm for a batch of 3x3 matrices (scaling and squaring, Taylor 12)."""
    norm = np.abs(a).sum(axis=(1, 2)).max() + 1e-30
    s = max(0, int(np.ceil(np.log2(norm))) + 1)
    x = a / (2.0 ** s)
    out = np.broadcast_to(np.eye(3, dtype=a.dtype), a.shape).copy()
    term = out.copy()
    for k in range(1, 13):
        term = term @ x / k
        out = out + term
    for _ in range(s):
        out = out @ out
    return out


def random_spinor(lattice, seed: int = 1) -> np.ndarray:
    """(24, X, Y, Z, T) float32 gaussian source."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(24,) + tuple(lattice)).astype(np.float32)


def unitarity_violation(u72: np.ndarray) -> float:
    """max |U U^dag - I| over sites/directions (gauge sanity check)."""
    lat = u72.shape[1:]
    g = u72.reshape(4, 3, 3, 2, *lat)
    uc = g[:, :, :, 0] + 1j * g[:, :, :, 1]
    uc = np.moveaxis(uc, (1, 2), (-2, -1))  # (4, ..., 3, 3)
    prod = uc @ np.conj(np.swapaxes(uc, -1, -2))
    return float(np.abs(prod - np.eye(3)).max())

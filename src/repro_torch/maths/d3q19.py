"""D3Q19 lattice-Boltzmann model constants (Ludwig's velocity set).

19 discrete velocities on a 3-D lattice: rest particle, 6 face neighbours,
12 edge neighbours.  cs^2 = 1/3 lattice units.  The same tables, in the
same order, are compile-time constants of ``csrc/d3q19.cuh``.
"""

from __future__ import annotations

import numpy as np

NVEL = 19
CS2 = 1.0 / 3.0

# velocity vectors c_i (Ludwig ordering: rest first, then faces, then edges)
CV = np.array(
    [
        (0, 0, 0),
        (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
        (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0),
        (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
        (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
    ],
    dtype=np.int32,
)

# quadrature weights
WV = np.array(
    [1.0 / 3.0]
    + [1.0 / 18.0] * 6
    + [1.0 / 36.0] * 12,
    dtype=np.float64,
)


def _check_tables() -> None:
    """The lattice-tensor identities the velocity set must satisfy."""
    if CV.shape != (NVEL, 3) or WV.shape != (NVEL,):
        raise RuntimeError(f"D3Q19 tables have shapes {CV.shape}, {WV.shape}")
    if abs(WV.sum() - 1.0) >= 1e-12:
        raise RuntimeError(f"D3Q19 weights sum to {WV.sum()}, not 1")
    # sum_i w_i c_ia c_ib = cs2 * delta_ab
    t = np.einsum("i,ia,ib->ab", WV, CV, CV)
    if not np.allclose(t, CS2 * np.eye(3), atol=1e-12):
        raise RuntimeError(f"D3Q19 second moment {t} is not cs2 * I")


_check_tables()

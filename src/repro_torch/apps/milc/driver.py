"""MILC Wilson-CG driver (single device).

Reproduces the UEABS test: invert the Wilson-Dirac operator on a random
SU(3) gauge background with CG on the normal equations, one source
(:func:`solve`) or a stack of sources against one gauge field
(:func:`solve_batched`).  The sharded solvers and the mixed-precision
refined solve of the JAX package are not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import BatchedField, Field, Layout, SOA, TargetConfig
from .cg import BatchedCGResult, CGResult, cg, cg_batched, make_fused_normal, make_wilson_op
from . import fields


@dataclasses.dataclass(frozen=True)
class MilcConfig:
    lattice: Tuple[int, int, int, int] = (8, 8, 8, 8)
    kappa: float = 0.12
    tol: float = 1e-10
    max_iter: int = 1000
    hot: float = 0.6           # gauge disorder (1 = hot start)
    layout: Layout = SOA
    target: TargetConfig = TargetConfig()
    # mixed precision (the refined solve): not yet ported, must stay unset
    storage: str = ""
    refine_k: int = 0


def init_problem(cfg: MilcConfig, seed: int = 0):
    """Random SU(3) gauge Field (72,) + gaussian source Field (24,), on
    ``cfg.target.device``."""
    u_np = fields.random_su3_gauge(cfg.lattice, seed=seed, hot=cfg.hot)
    viol = fields.unitarity_violation(u_np)
    if not viol < 1e-5:
        raise RuntimeError(f"gauge field is not unitary: violation {viol}")
    b_np = fields.random_spinor(cfg.lattice, seed=seed + 1)
    dev = cfg.target.device
    u = Field.from_numpy("u", u_np, cfg.lattice, cfg.layout, device=dev)
    b = Field.from_numpy("b", b_np, cfg.lattice, cfg.layout, device=dev)
    return u, b


def _require_full_precision(cfg: MilcConfig) -> None:
    if cfg.storage or cfg.refine_k:
        raise ValueError(
            "MilcConfig.storage/refine_k select the mixed-precision refined "
            "solve (cg_refined), which is not yet ported")


def solve(cfg: MilcConfig, u: Field, b: Field) -> CGResult:
    """Single-device CG solve of M x = b via the normal equations: per
    iteration the fused normal operator (M^dag M p and <p, M^dag M p>), the
    fused update chain (with |r|^2) and the p update."""
    _require_full_precision(cfg)
    _, apply_mdag, apply_normal = make_wilson_op(u, cfg.kappa, cfg.target)
    rhs = apply_mdag(b)
    return cg(apply_normal, rhs, config=cfg.target, tol=cfg.tol,
              max_iter=cfg.max_iter,
              apply_a_dot=make_fused_normal(u, cfg.kappa, cfg.target))


def solve_batched(cfg: MilcConfig, u: Field, bs) -> BatchedCGResult:
    """CG-solve a stack of sources against ONE shared gauge field through
    batched launches: per iteration, one fused operator launch and one fused
    masked-update launch cover the whole batch.

    ``bs`` is a sequence of same-lattice source Fields or a BatchedField.
    Each slot's trajectory (rhs, every alpha and beta, the iteration count,
    the final x) is bitwise ``solve(cfg, u, b)`` on that source alone: the
    rhs is computed per source through the single-lattice M^dag before
    stacking, and converged slots are frozen by select-masking."""
    _require_full_precision(cfg)
    _, apply_mdag, _ = make_wilson_op(u, cfg.kappa, cfg.target)
    srcs = bs.unstack() if isinstance(bs, BatchedField) else list(bs)
    rhs = BatchedField.stack([apply_mdag(b) for b in srcs], name="rhs")
    return cg_batched(make_fused_normal(u, cfg.kappa, cfg.target), rhs, config=cfg.target,
                      tol=cfg.tol, max_iter=cfg.max_iter)


def residual_check(cfg: MilcConfig, u: Field, b: Field, x: Field) -> float:
    """|M x - b| / |b| — independent verification of the solve."""
    apply_m, _, _ = make_wilson_op(u, cfg.kappa, cfg.target)
    mx = apply_m(x)
    num = torch.linalg.norm(mx.canonical() - b.canonical())
    den = torch.linalg.norm(b.canonical())
    return float(num / den)

"""MILC Wilson-CG driver (single device).

Reproduces the UEABS test: invert the Wilson-Dirac operator on a random
SU(3) gauge background with CG on the normal equations, one source
(:func:`solve`) or a stack of sources against one gauge field
(:func:`solve_batched`).  ``MilcConfig.storage`` (or ``refine_k``) selects
mixed precision: the operator launches run under a storage DtypePolicy and
restarts against the policy-free operator recover the working tolerance
(``cg_refined``; batched, ``cg_batched(refine_every=)``).

A shared-memory budget (``TargetConfig.smem_bytes`` or
``$TARGETDP_TORCH_SMEM_BYTES``) reaches the fused per-iteration operator
with no driver change beyond the config: when its whole-staged M^dag M
footprint exceeds the budget, the planning layer tiles the operator's y/z
axes as the JAX package's does (``core.plan.choose_tiles``), and on "cuda"
the tiled plan runs K5T (the operator's blocks walking the tiles) in
:func:`solve`, :func:`solve_batched` and the refined solve alike.

:func:`tune_solve_graphs` autotunes the two graphs a CG iteration launches
(``core.tune``) and persists the winners, which a later
``plan_policy="tuned"`` solve loads; :func:`solver_cost_model` ranks the
operator's candidates by measured time to solution.

The sharded solve (:func:`make_sharded_solver`, :func:`solve_sharded`)
runs on a decomposed lattice (``lattice.Domain`` over a ``launch.mesh.Mesh``,
one process a rank): each rank solves on its block, its inner products
all-reduced over the mesh.  Its per-iteration schedules, as the JAX
package's: ``halo=None`` exchanges the spinor once for each dslash
(``dslash_halo``, K4H on "cuda", unfused); ``halo="pre"`` exchanges p once
at width 2 and runs the fused normal operator on the pre-exchanged halos
(K5H), <p, Ap> from ``dot`` on the assembled Fields; ``halo="overlap"``
runs the same operator under the interior/boundary split of
``core.overlap`` (K5HO a box on "cuda"), p's exchange beside the interior
box, so its trajectory is bitwise "pre"'s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import (BatchedField, DtypePolicy, Field, Layout, SOA, TargetConfig,
                              tileable_layout)
from repro_torch.core import halo as halo_mod
from repro_torch.core.overlap import overlap_launch
from repro_torch.kernels.wilson_dslash import dslash_halo
from repro_torch.lattice import Domain
from .cg import (BatchedCGResult, CGResult, cg, cg_batched, cg_refined, dot, make_fused_normal,
                 make_wilson_op, wilson_normal_graph)
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
    # mixed precision: the storage dtype of the operator launches ("" = full
    # precision), and the iterative-refinement / reliable-update knobs that
    # keep the solve at the working tolerance under it; refine_k = 0 picks
    # 50 whenever storage is set, reliable = 0 picks 1e-4
    storage: str = ""
    refine_k: int = 0
    reliable: float = 0.0


def _storage_target(cfg: MilcConfig) -> TargetConfig:
    """The operator launches' config: ``cfg.target`` with the storage-dtype
    policy when ``cfg.storage`` sets one (compute fp32, sums accumulated as
    "float64", which resolves to compensated fp32)."""
    if not cfg.storage:
        return cfg.target
    return dataclasses.replace(
        cfg.target, dtypes=DtypePolicy(storage=cfg.storage, compute="float32",
                                       accumulate="float64"))


def _hi_target(cfg: MilcConfig) -> TargetConfig:
    """The true-residual operator's config: no dtype policy and the default
    plans, so the residual the restarts trust does not depend on the
    policy."""
    return dataclasses.replace(cfg.target, plan_policy="default", dtypes=None)


def _refine_k(cfg: MilcConfig) -> int:
    return cfg.refine_k or (50 if cfg.storage else 0)


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


def solve(cfg: MilcConfig, u: Field, b: Field) -> CGResult:
    """Single-device CG solve of M x = b via the normal equations: per
    iteration the fused normal operator (M^dag M p and <p, M^dag M p>), the
    fused update chain (with |r|^2) and the p update.

    With ``cfg.storage`` set (or ``cfg.refine_k``) the solve is
    :func:`~repro_torch.apps.milc.cg.cg_refined`: the operator launches run
    under the storage policy and restarts against the policy-free operator
    recover the working tolerance."""
    _, apply_mdag, apply_normal = make_wilson_op(u, cfg.kappa, cfg.target)
    rhs = apply_mdag(b)
    rk = _refine_k(cfg)
    if rk > 0:
        return cg_refined(make_fused_normal(u, cfg.kappa, _storage_target(cfg)), rhs,
                          config=cfg.target, tol=cfg.tol, max_iter=cfg.max_iter,
                          refine_k=rk, reliable=cfg.reliable or 1e-4,
                          apply_a_dot_hi=make_fused_normal(u, cfg.kappa, _hi_target(cfg)))
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
    stacking, and converged slots are frozen by select-masking.

    With ``cfg.storage`` set (or ``cfg.refine_k``) the operator runs under
    the storage policy and every ``refine_k`` active iterations a slot
    restarts from its true residual (``cg_batched(refine_every=)``); each
    slot is then bitwise the one-slot run of its source."""
    _, apply_mdag, _ = make_wilson_op(u, cfg.kappa, cfg.target)
    srcs = bs.unstack() if isinstance(bs, BatchedField) else list(bs)
    rhs = BatchedField.stack([apply_mdag(b) for b in srcs], name="rhs")
    rk = _refine_k(cfg)
    return cg_batched(make_fused_normal(u, cfg.kappa, _storage_target(cfg)), rhs,
                      config=cfg.target, tol=cfg.tol, max_iter=cfg.max_iter, refine_every=rk,
                      apply_a_dot_hi=(make_fused_normal(u, cfg.kappa, _hi_target(cfg))
                                      if rk > 0 else None))


def solver_cost_model(cfg: MilcConfig, u: Field, b: Field, *, tol: float = 1e-6,
                      cap: Optional[int] = None):
    """The convergence-aware tuner cost of the fused normal-operator graph:
    a callable mapping a candidate plan to its measured iterations to
    ``tol`` (memoised per plan), so that ``core.tune.autotune_graph`` ranks
    the candidates by time an iteration x iterations, time to solution,
    rather than by one launch's time.  Dtype-policy candidates are measured
    through the refined solve (how they would deploy), against
    ``apply_a_dot_hi`` on the policy-free default operator
    (:func:`_hi_target`); full-precision ones through plain CG."""
    _, apply_mdag, _ = make_wilson_op(u, cfg.kappa, cfg.target)
    rhs = apply_mdag(b)
    cap = cap or cfg.max_iter
    hi_op = make_fused_normal(u, cfg.kappa, _hi_target(cfg))
    cache = {}

    def iterations(plan):
        op = make_fused_normal(u, cfg.kappa, dataclasses.replace(cfg.target, plan_policy=plan))
        if plan.dtypes:
            res = cg_refined(op, rhs, config=cfg.target, tol=tol, max_iter=cap,
                             refine_k=cfg.refine_k or 50, reliable=cfg.reliable or 1e-4,
                             apply_a_dot_hi=hi_op)
        else:
            res = cg(None, rhs, config=cfg.target, tol=tol, max_iter=cap, apply_a_dot=op)
        return float(max(int(res.iterations), 1))

    def cost(plan):
        if plan not in cache:
            cache[plan] = iterations(plan)
        return cache[plan]

    return cost


def tune_solve_graphs(cfg: MilcConfig, u: Field, b: Field, convergence_cost: bool = False,
                      **tune_kw):
    """Autotune the two launch graphs a CG iteration runs, the fused normal
    operator (M^dag M p and <p, M^dag M p>) and the fused update chain (with
    |r|^2), and persist the winners, so that a later solve under
    ``cfg.target.plan_policy="tuned"`` loads them instead of sweeping.
    Returns {graph name: (plan, info)}.

    ``convergence_cost=True`` ranks the operator's candidates by measured
    time to solution (:func:`solver_cost_model`); the update chain ranks on
    its launch time alone, as in the JAX package."""
    from repro_torch.core import tune

    from .cg import cg_update_graph, wilson_normal_graph

    results = {}
    g = wilson_normal_graph(float(cfg.kappa))
    op_kw = dict(tune_kw)
    if convergence_cost and "cost_model" not in op_kw:
        op_kw["cost_model"] = solver_cost_model(cfg, u, b)
    results[g.name] = tune.autotune_graph(g, {"p": b, "u": u}, config=cfg.target,
                                          outputs=("ap", "pap"), **op_kw)
    g = cg_update_graph(b.ncomp)
    results[g.name] = tune.autotune_graph(
        g, {"x": b, "r": b, "p": b, "ap": b}, scalars={"alpha": 0.3, "neg_alpha": -0.3},
        config=cfg.target, outputs=("x_new", "r_new", "rr"), **tune_kw)
    return results


def residual_check(cfg: MilcConfig, u: Field, b: Field, x: Field) -> float:
    """|M x - b| / |b| — independent verification of the solve."""
    apply_m, _, _ = make_wilson_op(u, cfg.kappa, cfg.target)
    mx = apply_m(x)
    num = torch.linalg.norm(mx.canonical() - b.canonical())
    den = torch.linalg.norm(b.canonical())
    return float(num / den)


# -- sharded solve -----------------------------------------------------------------

def make_domain(cfg: MilcConfig, mesh, dim_axes) -> Domain:
    return Domain(global_shape=cfg.lattice, mesh=mesh, dim_axes=dim_axes, halo=1)


def make_sharded_solver(cfg: MilcConfig, domain: Domain, halo: Optional[str] = None):
    """Build the sharded CG solver of this rank: ``solver(u_local,
    b_local) -> (x_local, iterations, residual)``, each array this rank's
    canonical (ncomp, *local_shape) block (``domain.scatter``), iterations
    an int and residual |r|^2 / |b|^2, the same on every rank.

    ``halo`` selects the per-iteration schedule: None (an exchange for each
    dslash, unfused), "pre" (the fused normal operator on one width-2
    exchange) or "overlap" (that operator under the interior/boundary
    split, p's exchange beside the interior: ``core.overlap``).  Under a
    shared-memory budget (``TargetConfig.smem_bytes``) the operator's "pre"
    launch tiles (K5TH on "cuda"), bitwise the untiled solve."""
    if halo not in (None, "pre", "overlap"):
        raise ValueError(f"halo must be None, 'pre' or 'overlap', got {halo!r}")
    mesh = domain.mesh
    dec = domain.decomposed
    axes = tuple(ax for _, ax, _ in dec) if mesh is not None else ()
    tgt = cfg.target
    WN = 2  # fused normal-operator ring: two width-1 dslash stages

    def halo_of(x, w=1):
        # the halo'd block, exchange(pad(x)): the decomposed dims' halos from
        # the neighbours, the others' by the local periodic wrap
        return halo_mod.exchange_padded(x, dec, width=w, mesh=mesh)

    def mkF(name, arr):
        lat = tuple(arr.shape[1:])
        return Field.from_canonical(name, arr, lat, tileable_layout(cfg.layout, lat))

    normal = wilson_normal_graph(float(cfg.kappa))

    def solver(u_loc: torch.Tensor, b_loc: torch.Tensor):
        u_h = halo_of(u_loc)  # the gauge halo, once a solve

        def dslash_fn(psi: Field) -> Field:
            psi_h = halo_of(psi.canonical_nd())
            out = dslash_halo(psi_h, u_h, config=tgt, width=1)
            return psi.with_canonical(out.reshape(psi.ncomp, -1))

        _, apply_mdag, apply_normal = make_wilson_op(mkF("u", u_loc), cfg.kappa, tgt,
                                                     dslash_fn=dslash_fn)
        rhs = apply_mdag(mkF("b", b_loc))
        apply_a_dot = None
        if halo is not None:
            # M^dag M as one halo'd graph an iteration; the gauge field's
            # ring-2 halo is exchanged once here
            uF_h = mkF("u", halo_of(u_loc, WN))

            def apply_a_dot(p: Field):
                # p filled (the block and its undecomposed wrap); its
                # exchange runs inside (under "overlap", beside the interior
                # box)
                pF = mkF("p", halo_mod.fill_padded(p.canonical_nd(), dec, width=WN))
                out = overlap_launch(normal, {"p": pF, "u": uF_h}, decomposed=dec, config=tgt,
                                     outputs=("ap",), halo=halo, exchanged=("u",),
                                     out_layouts={"ap": p.layout}, mesh=mesh)
                ap = p.with_data(out["ap"].data)
                # <p, Ap> from the assembled Fields, not a fused reduction:
                # its value does not depend on how ap was produced (one
                # launch or the split's boxes), so "pre" and "overlap" take
                # the same trajectory
                return ap, dot(p, ap, tgt)

        res = cg(apply_normal, rhs, config=tgt, tol=cfg.tol, max_iter=cfg.max_iter,
                 psum_axes=axes, apply_a_dot=apply_a_dot, mesh=mesh)
        return res.x.canonical_nd(), res.iterations, res.residual

    return solver


def solve_sharded(cfg: MilcConfig, domain: Domain, u_local: torch.Tensor,
                  b_local: torch.Tensor, halo: Optional[str] = None):
    """One-shot form of :func:`make_sharded_solver` (loops should build the
    solver once): (x_local, iterations, residual)."""
    return make_sharded_solver(cfg, domain, halo)(u_local, b_local)

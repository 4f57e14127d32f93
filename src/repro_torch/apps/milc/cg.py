"""Conjugate-gradient inversion of the Wilson-Dirac operator (MILC UEABS).

Solves M^dag M x = M^dag b for x (so M x = b), with M = 1 - kappa D and
M^dag = g5 M g5 (gamma5-hermiticity; g5 = diag(1,1,-1,-1) in the DeGrand-
Rossi basis).

The site-local linear algebra runs through the launch machinery
(core.target) and two fused launch graphs cover the CG iteration
(core.fuse): ``wilson_normal_graph`` (M^dag M p and <p, M^dag M p>) and
``cg_update_graph`` (x + alpha p, r - alpha ap and |r_new|^2).  On the
``"cuda"`` engine each body and graph below is registered against its
hand-written kernel.

The iteration is a host loop.  alpha, beta, rr and pap stay 0-d device
tensors that the kernels read through pointers; the only host
synchronisation per iteration is the convergence test.

The batched CG (multi-simulation serving, :func:`cg_batched`) runs one
convergence-masked iteration over a stack of independent right-hand sides
under one shared operator: the normal operator and the masked update chain
each run once for the whole stack (``masked_cg_update_graph``,
``cg_xpay_masked``, ``dot_prod``; on "cuda" K5B, K3B and K1's product
with K2B's folds), and each slot takes exactly the single solve's steps.  What keeps a slot's
bits the single solve's, where the code handles it:

1. the component fold: every inner product folds its per-component sums
   through ``core.reduce.fold_components``, single and batched alike
   (:func:`dot`, :func:`batched_dot`, :func:`make_fused_normal`, the rr of
   both loops);
2. the scalar guards: alpha and beta are ``where(act, rr / where(act, pap,
   1), 0)`` as the JAX package computes them; a live slot divides exactly
   as the single solve does (:func:`batched_cg_iteration`);
3. empty slots: an all-zero rhs has ``b2 == 0``, its ``rr / b2`` is NaN and
   compares false, so it never goes live (:func:`batched_cg_active`);
4. admission: a request's rhs and ``|rhs|^2`` come from the single-lattice
   ``apply_mdag`` and :func:`dot` (``launch.serve``, ``driver.solve_batched``).

Mixed precision: :func:`cg_refined` is the refined solve (iterative
refinement: inner CGs through an operator whose launches may carry a
bf16-storage DtypePolicy, restarted from the true residual of the
policy-free operator), and ``cg_batched(refine_every > 0)`` with
:func:`batched_cg_refresh` its serving form (reliable-update restarts a
slot at a time).  On "cuda" the operator's policy instance is K5's
(``csrc/wilson_normal_mixed.cu``) and the update chains take its bf16 ap
(K3's and K3B's ap16 instances).

On a decomposed lattice (``driver.make_sharded_solver``) the solve runs on
a rank's block: ``cg``'s inner products are all-reduced over the mesh
(``psum_axes``), the operator reaches its neighbours through pre-exchanged
halos (``make_wilson_op(dslash_fn=)``, or the fused operator's
``halo="pre"`` launch, K5H on "cuda").

A shared-memory budget (``TargetConfig.smem_bytes``) tiles the fused
operator as the JAX package's VMEM budget does; on "cuda" the tiled plan
runs K5T (``kernels/wilson_dslash/kernel.py::wilson_normal_tiled_cuda``),
single, batched and under the refined solve's policy.
"""

from __future__ import annotations

import math
import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import BatchedField, Field, LaunchGraph, TargetConfig, launch, target_sum
from repro_torch.core import fuse
from repro_torch.core.fuse import register_cuda_graph
from repro_torch.core.plan import cuda_policy, launch_policy, plan_tile
from repro_torch.core.reduce import fold_components
from repro_torch.core.target import register_cuda_body, site_axpy, site_g5, site_mul
from repro_torch.kernels.wilson_dslash import dslash
from repro_torch.kernels.wilson_dslash.kernel import (bf16_pack_cuda,
                                                      wilson_normal_boundary_cuda,
                                                      wilson_normal_interior_cuda,
                                                      wilson_normal_cuda, wilson_normal_pre_cuda,
                                                      wilson_normal_tiled_cuda)
from repro_torch.kernels.wilson_dslash.ops import dslash_stencil_body


# -- site-local linear-algebra kernels (the "Scalar Mult Add" family) ---------

def _axpy_body(v, *, a: float = None):
    return {"out": v["x"] * a + v["y"]}


def axpy(a, x: Field, y: Field, config: TargetConfig) -> Field:
    """a*x + y through the kernel layer (static a)."""
    return launch(_axpy_body, {"x": x, "y": y}, {"out": x.ncomp},
                  config=config, params=dict(a=a))["out"]


def _fma_body(v):
    """y + a*x with a supplied as a runtime scalar."""
    return {"out": v["y"] + v["a"] * v["x"]}


def _square_body(v):
    return {"out": v["x"] * v["x"]}


def _mul_body(v):
    return {"out": v["x"] * v["y"]}


def _masked_fma_body(v):
    """y + a*x where the per-request mask is set, y (bitwise) elsewhere.

    The frozen branch must be a *select*, not arithmetic masking: y + 0*x
    flips -0.0 to +0.0 and poisons on non-finite x, so a converged
    request's state would drift from its single-solve bits."""
    return {"out": torch.where(v["m"] > 0, v["y"] + v["a"] * v["x"], v["y"])}


def _g5_body(v):
    x = v["psi"]
    return {"out": torch.cat([x[:12], -x[12:]], dim=0)}


def _m_g5_body(v, *, kappa):
    """g5 (psi - kappa d): one Wilson matvec + gamma5, site-local."""
    t = v["psi"] - kappa * v["d"]
    return {"out": torch.cat([t[:12], -t[12:]], dim=0)}


def cg_xpay_graph(ncomp: int) -> LaunchGraph:
    """y + a*x with a runtime scalar a, as a one-stage graph."""
    return LaunchGraph("cg_xpay").add(
        _fma_body, {"x": "x", "y": "y", "a": "a"}, {"out": ncomp})


def fused_xpay(y: Field, a, x: Field, config: TargetConfig) -> Field:
    """y + a*x with a runtime a; keeps x's name and layout."""
    out = cg_xpay_graph(x.ncomp).launch(
        {"x": x, "y": y}, scalars={"a": a}, config=config,
        out_layouts={"out": x.layout})["out"]
    return x.with_data(out.data)


def cg_update_graph(ncomp: int) -> LaunchGraph:
    """The CG inner-update chain as a LaunchGraph, ending in the residual
    norm as a terminal reduction."""
    return (
        LaunchGraph("cg_update")
        .add(_fma_body, {"x": "p", "y": "x", "a": "alpha"}, {"out": ncomp},
             rename={"out": "x_new"})
        .add(_fma_body, {"x": "ap", "y": "r", "a": "neg_alpha"}, {"out": ncomp},
             rename={"out": "r_new"})
        .add(_square_body, {"x": "r_new"}, {"out": ncomp},
             rename={"out": "rr_prod"})
        .add_reduce("rr_prod", op="sum", name="rr")
    )


def fused_cg_update(x: Field, r: Field, p: Field, ap: Field, alpha,
                    config: TargetConfig):
    """x_new = x + alpha p,  r_new = r - alpha ap,  rr = sum (r_new)^2 as
    ONE fused launch.  Returns (x_new, r_new, rr) with rr a per-component
    (ncomp,) sum (``rr.sum()`` is |r_new|^2).

    A plan with a storage policy (a tuned bf16 winner) writes x_new and
    r_new in bf16; they are widened (exactly) back to x's and r's dtype
    here, so the solve's carried x and r keep their dtype and every
    iteration launches with the same table key.  The JAX package lets them
    go on in bf16."""
    out = cg_update_graph(x.ncomp).launch(
        {"x": x, "r": r, "p": p, "ap": ap},
        scalars={"alpha": alpha, "neg_alpha": -alpha},
        config=config,
        outputs=("x_new", "r_new", "rr"),
        out_layouts={"x_new": x.layout, "r_new": r.layout},
    )
    return (x.with_data(out["x_new"].data.to(x.dtype)), r.with_data(out["r_new"].data.to(r.dtype)),
            out["rr"])


def masked_cg_update_graph(ncomp: int) -> LaunchGraph:
    """The batched-serving variant of :func:`cg_update_graph`: the x/r
    updates select per request on the runtime mask scalar ``m`` (1 while
    the request iterates, 0 once converged), so a frozen slot's x, r and
    residual terms are its inputs' bits while live slots update exactly as
    the unmasked chain would."""
    return (
        LaunchGraph("cg_update_masked")
        .add(_masked_fma_body, {"x": "p", "y": "x", "a": "alpha", "m": "m"},
             {"out": ncomp}, rename={"out": "x_new"})
        .add(_masked_fma_body, {"x": "ap", "y": "r", "a": "neg_alpha", "m": "m"},
             {"out": ncomp}, rename={"out": "r_new"})
        .add(_square_body, {"x": "r_new"}, {"out": ncomp},
             rename={"out": "rr_prod"})
        .add_reduce("rr_prod", op="sum", name="rr")
    )


def fused_masked_cg_update(x, r, p, ap, alpha, mask, config: TargetConfig):
    """The per-request-masked CG update chain, one fused launch over the
    whole batch; ``alpha`` and ``mask`` are (batch,) vectors.  Returns
    (x_new, r_new, rr (batch, ncomp))."""
    out = masked_cg_update_graph(x.ncomp).launch(
        {"x": x, "r": r, "p": p, "ap": ap},
        scalars={"alpha": alpha, "neg_alpha": -alpha, "m": mask},
        config=config,
        outputs=("x_new", "r_new", "rr"),
        out_layouts={"x_new": x.layout, "r_new": r.layout},
    )
    return x.with_data(out["x_new"].data), r.with_data(out["r_new"].data), out["rr"]


def masked_xpay_graph(ncomp: int) -> LaunchGraph:
    """where(m > 0, y + a*x, y) with runtime a and m, as a one-stage graph."""
    return LaunchGraph("cg_xpay_masked").add(
        _masked_fma_body, {"x": "x", "y": "y", "a": "a", "m": "m"}, {"out": ncomp})


def fused_masked_xpay(y, a, x, mask, config: TargetConfig):
    """The masked p-update, the batched form of :func:`fused_xpay`: y + a*x
    where the request is live.  As in the JAX package's graph, a frozen slot
    takes y's bits (there r, which the masked update chain froze); no live
    value ever reads a frozen slot's p.  Keeps x's name and layout."""
    out = masked_xpay_graph(x.ncomp).launch(
        {"x": x, "y": y}, scalars={"a": a, "m": mask}, config=config,
        out_layouts={"out": x.layout})["out"]
    return x.with_data(out.data)


def dot(x: Field, y: Field, config: TargetConfig) -> torch.Tensor:
    """<x, y> as the real inner product over all components/sites, a 0-d
    tensor on the fields' device (components folded by
    ``fold_components``)."""
    prod = launch(_mul_body, {"x": x, "y": y}, {"out": x.ncomp},
                  config=config)["out"]
    return fold_components(target_sum(prod, config))


def dot_prod_graph(ncomp: int) -> LaunchGraph:
    """The per-site product of the batched dot, as a one-stage graph."""
    return LaunchGraph("dot_prod").add(_mul_body, {"x": "x", "y": "y"}, {"out": ncomp},
                                       rename={"out": "p"})


def batched_dot(x: BatchedField, y: BatchedField, config: TargetConfig) -> torch.Tensor:
    """Per-request <x, y> over a batch, shape (batch,): each element bitwise
    :func:`dot` of the corresponding slots (the product is exact, the
    batched ``target_sum`` folds each row as the single one, and both fold
    their components through ``fold_components``)."""
    prod = dot_prod_graph(x.ncomp).launch({"x": x, "y": y}, config=config,
                                          out_layouts={"p": x.layout})["p"]
    return fold_components(target_sum(prod, config))


def g5(psi: Field, config: TargetConfig) -> Field:
    """gamma5 psi: flips the sign of spin components 2 and 3."""
    return launch(_g5_body, {"psi": psi}, {"out": psi.ncomp}, config=config)["out"]


# -- operator application -------------------------------------------------------

def wilson_normal_graph(kappa: float) -> LaunchGraph:
    """M^dag M p with <p, M^dag M p> as a terminal reduction, fused."""
    return (
        LaunchGraph("wilson_normal")
        .add_stencil(dslash_stencil_body, {"psi": "p", "u": "u"}, {"d": 24},
                     width=1, rename={"d": "d1"})
        .add(_m_g5_body, {"psi": "p", "d": "d1"}, {"out": 24},
             rename={"out": "t"}, params=dict(kappa=kappa))
        .add_stencil(dslash_stencil_body, {"psi": "t", "u": "u"}, {"d": 24},
                     width=1, rename={"d": "d2"})
        .add(_m_g5_body, {"psi": "t", "d": "d2"}, {"out": 24},
             rename={"out": "ap"}, params=dict(kappa=kappa))
        .add(_mul_body, {"x": "p", "y": "ap"}, {"out": 24},
             rename={"out": "pap_prod"})
        .add_reduce("pap_prod", op="sum", name="pap")
    )


def make_fused_normal(u: Field, kappa: float, config: TargetConfig):
    """Returns apply(p) -> (A p, <p, A p>) through the fused graph
    (A = M^dag M); ap keeps p's name and layout, <p, A p> is 0-d.  ``p`` may
    be a BatchedField (u is shared by every slot): ap comes back batched and
    the inner product per request, shape (batch,), each slot bitwise the
    single launch's (``fold_components`` over the last axis).

    Where the launch's policy (``core.plan.launch_policy``, the one the
    bound graph resolves) asks the "cuda" engine for bf16 storage, the
    operator binds a bf16 copy of u, made here once (``bf16_pack_cuda``: the
    rounding of the policy's stage-in, so the same bits), which K5's policy
    instance reads in place of the fp32 field (144 fewer bytes a site a
    launch) and which its wrapper requires.  The torch engine rounds u in
    its stage-in cast.  Under ``plan_policy="tuned"`` the operator binds
    the fp32 u, the field the table's keys name, and the launch makes the
    copy where the looked-up plan asks for it (once: ``_policy_u``)."""
    bound = wilson_normal_graph(float(kappa)).bind(
        config=config, outputs=("ap", "pap"))
    engine, dtypes = launch_policy(config)
    if (engine == "cuda" and cuda_policy(dtypes).bf16
            and getattr(config, "plan_policy", "default") != "tuned"):
        u = u.with_data(bf16_pack_cuda(u.data))

    def apply(p):
        out = bound({"p": p, "u": u}, out_layouts={"ap": p.layout})
        return p.with_data(out["ap"].data), fold_components(out["pap"])

    return apply


def make_wilson_op(u: Field, kappa: float, config: TargetConfig,
                   dslash_fn: Optional[Callable[[Field], Field]] = None):
    """Returns apply_m, apply_mdag, apply_normal (M^dag M).  ``dslash_fn``
    replaces the periodic D psi (the sharded solver's exchange and
    ``dslash_halo``)."""
    _dslash = dslash_fn or (lambda psi: dslash(psi, u, config=config))

    def apply_m(psi: Field) -> Field:
        d = _dslash(psi)
        return psi.with_canonical(psi.canonical() - kappa * d.canonical())

    def apply_mdag(psi: Field) -> Field:
        return g5(apply_m(g5(psi, config)), config)

    def apply_normal(psi: Field) -> Field:
        return apply_mdag(apply_m(psi))

    return apply_m, apply_mdag, apply_normal


class CGResult(NamedTuple):
    x: Field
    iterations: int
    residual: torch.Tensor  # final |r|^2 / |b|^2, 0-d


def cg(
    apply_a: Callable[[Field], Field],
    b: Field,
    *,
    config: TargetConfig,
    tol: float = 1e-8,
    max_iter: int = 500,
    psum_axes: Tuple[str, ...] = (),
    apply_a_dot: Optional[Callable[[Field], Tuple[Field, torch.Tensor]]] = None,
    mesh=None,
) -> CGResult:
    """Standard CG on a positive-definite operator, as a host loop.

    apply_a_dot, when given, computes (A p, <p, A p>) in one fused launch
    (see make_fused_normal) — the iteration then runs two fused launches:
    operator+dot, and update-chain+residual-norm, plus the p update.

    psum_axes: on a decomposed lattice (``b`` a rank's block), every inner
    product is summed over these axes of ``mesh`` (``launch.mesh.Mesh``), an
    all-reduce of the 0-d device scalar.  Every rank then holds the same rr
    and b2, so the convergence test stops every rank on one iteration."""
    psum = _psum(psum_axes, mesh)
    b2 = psum(dot(b, b, config))
    x = b.with_data(torch.zeros_like(b.data))
    r = b
    p = b
    rr = psum(dot(r, r, config))
    it = 0
    # the convergence test is the one host synchronisation per iteration
    while it < max_iter and bool(rr / b2 > tol):
        if apply_a_dot is not None:
            ap, pap = apply_a_dot(p)
            alpha = rr / psum(pap)
        else:
            ap = apply_a(p)
            alpha = rr / psum(dot(p, ap, config))
        x, r, rr_vec = fused_cg_update(x, r, p, ap, alpha, config)
        rr_new = psum(fold_components(rr_vec))
        beta = rr_new / rr
        p = fused_xpay(r, beta, p, config)
        rr = rr_new
        it += 1
    return CGResult(x=x, iterations=it, residual=rr / b2)


def _psum(psum_axes: Tuple[str, ...], mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The sum over ``psum_axes`` of ``mesh`` (the identity for none)."""
    if not psum_axes:
        return lambda d: d
    if mesh is None:
        raise ValueError(f"psum_axes {tuple(psum_axes)} need the mesh that holds them")
    return lambda d: mesh.all_reduce(d, psum_axes)


def cg_refined(apply_a_dot, b: Field, *, config: TargetConfig, tol: float = 1e-8,
               max_iter: int = 500, refine_k: int = 50, reliable: float = 1e-4,
               apply_a_dot_hi=None, psum_axes: Tuple[str, ...] = (),
               mesh=None) -> CGResult:
    """Iterative-refinement CG: low-precision inner solves inside restarts
    that recover the working precision (the JAX package's "portable-LQCD
    production recipe").

    The outer loop keeps x and the true residual r = b - A x in fp32.  Each
    outer step runs an inner :func:`cg` on A d = r through ``apply_a_dot``,
    whose launches may carry a bf16-storage DtypePolicy, for at most
    ``refine_k`` iterations or until its relative residual drops below
    ``reliable``; then x += d in fp32 and r is recomputed through
    ``apply_a_dot_hi`` (default ``apply_a_dot``; pass the policy-free
    operator).  |r|^2 is a plain fp32 sum outside any kernel, as in the
    reference.  ``iterations`` counts the inner iterations, the
    bandwidth-bound work, as :func:`cg` counts its own.  ``psum_axes`` and
    ``mesh`` as :func:`cg`'s."""
    hi = apply_a_dot_hi or apply_a_dot
    psum = _psum(psum_axes, mesh)

    def norm2(f: Field) -> torch.Tensor:
        c = f.canonical().to(torch.float32)
        return psum(torch.sum(c * c))

    b2 = norm2(b)
    x = b.with_data(torch.zeros_like(b.data))
    r, rr, it = b, b2, 0
    # the convergence test is the outer loop's host synchronisation
    while it < max_iter and bool(rr / b2 > tol):
        inner = cg(None, r, config=config, tol=reliable, max_iter=refine_k,
                   apply_a_dot=apply_a_dot, psum_axes=psum_axes, mesh=mesh)
        x = x.with_data(x.data + inner.x.data.to(x.dtype))
        ax, _ = hi(x)
        r = b.with_data(b.data - ax.data.to(b.dtype))
        rr = norm2(r)
        it += inner.iterations
    return CGResult(x=x, iterations=it, residual=rr / b2)


# -- batched CG (multi-simulation serving) ------------------------------------

class BatchedCGState(NamedTuple):
    """Per-slot CG state for a batch of independent same-lattice solves.

    A slot is live while ``rr / b2 > tol`` and ``it < max_iter``; an empty
    slot (all-zero rhs) has ``b2 == 0`` and is inert (``0/0`` compares
    false), so a partly filled batch runs with no special case."""

    x: BatchedField
    r: BatchedField
    p: BatchedField
    rr: torch.Tensor   # (batch,) |r|^2 per slot
    b2: torch.Tensor   # (batch,) |rhs|^2 per slot
    it: torch.Tensor   # (batch,) int32, active iterations taken


class BatchedCGResult(NamedTuple):
    x: BatchedField
    iterations: torch.Tensor  # (batch,) int32
    residual: torch.Tensor    # (batch,) final |r|^2 / |b|^2 per slot


def batched_cg_state(rhs: BatchedField, config: TargetConfig) -> BatchedCGState:
    """Initial state: x = 0, r = p = rhs, per-slot norms, each slot set up as
    :func:`cg` sets up a single solve."""
    b2 = batched_dot(rhs, rhs, config)
    return BatchedCGState(x=rhs.with_data(torch.zeros_like(rhs.data)), r=rhs, p=rhs,
                          rr=b2, b2=b2,
                          it=torch.zeros((rhs.batch,), dtype=torch.int32, device=rhs.device))


def batched_cg_active(state: BatchedCGState, *, tol: float, max_iter: int) -> torch.Tensor:
    """(batch,) liveness mask: per slot, the single loop's condition
    ``rr / b2 > tol and it < max_iter`` (false for an empty slot: 0/0 is
    NaN, and NaN compares false)."""
    return (state.rr / state.b2 > tol) & (state.it < max_iter)


def batched_cg_iteration(state: BatchedCGState, apply_a_dot, *, config: TargetConfig,
                         tol: float, max_iter: int) -> BatchedCGState:
    """One convergence-masked CG iteration over the whole batch: the fused
    normal operator and the fused masked update chain each run once for the
    stack.  A live slot takes exactly the single solve's step (the masked
    kernels select the identically computed update); a converged or empty
    slot's x, r and rr are bitwise frozen."""
    act = batched_cg_active(state, tol=tol, max_iter=max_iter)
    m = act.to(state.r.dtype)
    ap, pap = apply_a_dot(state.p)
    # guard the frozen slots' divides (their alpha and beta are never used);
    # a live slot's rr / pap is the single solve's IEEE division
    alpha = torch.where(act, state.rr / torch.where(act, pap, 1.0), 0.0)
    x, r, rr_vec = fused_masked_cg_update(state.x, state.r, state.p, ap, alpha, m, config)
    rr_new = torch.where(act, fold_components(rr_vec), state.rr)
    beta = torch.where(act, rr_new / torch.where(act, state.rr, 1.0), 0.0)
    p = fused_masked_xpay(r, beta, state.p, m, config)
    return BatchedCGState(x=x, r=r, p=p, rr=rr_new, b2=state.b2,
                          it=state.it + act.to(state.it.dtype))


def _norm2_slots(data: torch.Tensor) -> torch.Tensor:
    """|f|^2 of each slot of (batch, ...) fp32 data, a plain fp32 sum of a
    slot's contiguous values (a slot's sum is that of the one-slot stack)."""
    return torch.stack([torch.sum(d * d) for d in data.to(torch.float32)])


def batched_cg_refresh(state: BatchedCGState, rhs: BatchedField, apply_a_dot_hi, *,
                       tol: float, max_iter: int, refine_every: int) -> BatchedCGState:
    """The reliable-update restart of the batched loop: on every live slot
    whose active iteration count is a multiple of ``refine_every``, replace
    the recurrence residual with the true residual ``rhs - A x``, computed
    through ``apply_a_dot_hi`` (the policy-free operator), and restart the
    search direction there; every other slot keeps its bits (a select).
    This keeps a mixed-precision batch converging to the working tolerance:
    the recurrence residual drifts from the truth in low precision, and the
    periodic exact recompute re-aims it.  The new |r|^2 is a plain fp32 sum
    outside any kernel, as in the JAX package."""
    act = batched_cg_active(state, tol=tol, max_iter=max_iter)
    sel = act & (state.it % refine_every == 0)
    ax, _ = apply_a_dot_hi(state.x)
    rt = (rhs.data.to(torch.float32) - ax.data.to(torch.float32)).to(state.r.dtype)
    rr_t = _norm2_slots(state.r.with_data(rt).canonical()).to(state.rr.dtype)
    selb = sel.reshape((-1,) + (1,) * (rt.dim() - 1))
    return BatchedCGState(x=state.x, r=state.r.with_data(torch.where(selb, rt, state.r.data)),
                          p=state.p.with_data(torch.where(selb, rt, state.p.data)),
                          rr=torch.where(sel, rr_t, state.rr), b2=state.b2, it=state.it)


def refresh_due(state: BatchedCGState, *, tol: float, max_iter: int,
                refine_every: int) -> bool:
    """Whether any live slot's active iteration count is a multiple of
    ``refine_every`` (a host synchronisation)."""
    act = batched_cg_active(state, tol=tol, max_iter=max_iter)
    return bool((act & (state.it % refine_every == 0)).any())


def cg_batched(apply_a_dot, rhs: BatchedField, *, config: TargetConfig, tol: float = 1e-8,
               max_iter: int = 500, refine_every: int = 0,
               apply_a_dot_hi=None) -> BatchedCGResult:
    """CG on a stack of independent right-hand sides under one shared
    operator, per-request convergence-masked, as a host loop: every
    iteration runs one fused operator launch and one fused update launch
    for the whole batch, and each slot's trajectory is bitwise :func:`cg`
    on that slot alone.  The loop runs until every slot has converged or
    hit max_iter; slots that finish early ride along frozen.

    ``refine_every > 0`` adds the reliable-update restarts of mixed
    precision (:func:`batched_cg_refresh`, through ``apply_a_dot_hi``,
    default ``apply_a_dot``).  Every slot starts at iteration 0 and a live
    slot's count is the loop's, so a restart can fall due only on a loop
    iteration that is a multiple of ``refine_every``: only those pay the
    extra synchronisation of the test.  With ``refine_every=0`` the loop is
    the plain one."""
    hi = apply_a_dot_hi or apply_a_dot
    kw = dict(tol=tol, max_iter=max_iter)
    state = batched_cg_state(rhs, config)
    k = 0
    # the "any slot live" test is the one host synchronisation per iteration
    while bool(batched_cg_active(state, **kw).any()):
        state = batched_cg_iteration(state, apply_a_dot, config=config, **kw)
        k += 1
        if refine_every > 0 and k % refine_every == 0 and \
                refresh_due(state, refine_every=refine_every, **kw):
            state = batched_cg_refresh(state, rhs, hi, refine_every=refine_every, **kw)
    return BatchedCGResult(x=state.x, iterations=state.it, residual=state.rr / state.b2)


# -- the hand-written kernels behind these bodies and graphs on "cuda" --------------
#
# Each impl hands its kernel the input tensors with their layouts and the
# output layouts; the kernel writes each output in its layout.  The impls of
# the graphs with a reduction (rr, pap) fold their partial rows in the plan's
# ``rsplit`` segments.

def _lays(ins, names, out_layouts):
    """The wrapper's layouts: body argument -> wrapper name for the inputs,
    plus the outputs' layouts as given."""
    lays = {w: ins[a][1] for a, w in names.items()}
    lays.update(out_layouts)
    return lays


def _g5_cuda(ins, params, vvl, out_layouts):
    lays = _lays(ins, {"psi": "x"}, out_layouts)
    return {"out": site_g5(ins["psi"][0], 12, vvl, layouts=lays)}


def _mul_cuda(ins, params, vvl, out_layouts):
    lays = _lays(ins, {"x": "x", "y": "y"}, out_layouts)
    return {"out": site_mul(ins["x"][0], ins["y"][0], vvl, layouts=lays)}


def _axpy_cuda(ins, params, vvl, out_layouts):
    lays = _lays(ins, {"x": "x", "y": "y"}, out_layouts)
    return {"out": site_axpy(params["a"], ins["x"][0], ins["y"][0], vvl, layouts=lays)}


def _cg_update_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts, rsplit=1, policy=None):
    # policy: K3's policy instance (bf16 storage, a compensated rr)
    lays = _lays(ins, {n: n for n in ("x", "r", "p", "ap")}, out_layouts)
    x_new, r_new, rr = fuse.cg_update(ins["x"][0], ins["r"][0], ins["p"][0], ins["ap"][0],
                                      scalars["alpha"], scalars["neg_alpha"], vvl,
                                      layouts=lays, rsplit=rsplit, policy=policy)
    return {"x_new": x_new, "r_new": r_new, "rr": rr}


def _cg_xpay_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts):
    lays = _lays(ins, {"x": "x", "y": "y"}, out_layouts)
    return {"out": fuse.cg_xpay(ins["x"][0], ins["y"][0], scalars["a"], vvl, layouts=lays)}


def _normal_kappa(graph) -> float:
    params = graph.stage_params()
    kappa = params[1]["kappa"]
    if params[3]["kappa"] != kappa:
        raise ValueError("wilson_normal: both g5(psi - kappa d) stages must "
                         "share one kappa")
    return kappa


# the last fp32 gauge tensor packed by _policy_u: (weak reference, its
# version when packed, its bf16 copy)
_U16 = [None]


def _policy_u(u: torch.Tensor, policy) -> torch.Tensor:
    """The u a wilson_normal kernel reads under ``policy``: the bf16 copy
    under bf16 storage.  ``make_fused_normal`` binds it once per operator
    where its config shows the policy; a launch handed the fp32 field (a
    tuned or swept plan's policy) packs it here, once for as long as the
    same tensor holds the same values (its ``_version``), so a sweep or a
    tuned solve packs u once."""
    if policy is None or not policy.bf16 or u.dtype == torch.bfloat16:
        return u
    hit = _U16[0]
    if hit is not None and hit[0]() is u and hit[1] == u._version:
        return hit[2]
    u16 = bf16_pack_cuda(u)
    _U16[0] = (weakref.ref(u, lambda _: _U16.__setitem__(0, None)), u._version, u16)
    return u16


def _wilson_normal_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts, policy=None,
                        rsplit=1):
    lays = _lays(ins, {"p": "p", "u": "u"}, out_layouts)
    ap, pap = wilson_normal_cuda(ins["p"][0], _policy_u(ins["u"][0], policy),
                                 _normal_kappa(graph), lattice, vvl,
                                 layouts=lays, policy=policy, rsplit=rsplit)
    return {"ap": ap, "pap": pap}


def _wilson_normal_pre_cuda(graph, ins, scalars, *, lattice, rings, plan, out_layouts):
    # K5H (K5TH under a tiled plan): ap on the interior from p and u padded
    # by 2 (their rings)
    fuse.check_pre_rings(graph, rings, {"p": 2, "u": 2})
    return {"ap": wilson_normal_pre_cuda(ins["p"][0], ins["u"][0], _normal_kappa(graph),
                                         lattice, plan.vvl, tile=plan_tile(plan))}


def _wilson_normal_box_cuda(graph, ins, scalars, *, lattice, rings, vvls, tiles, part, interior,
                            boxes, outs, out_layouts, scratch):
    # K5HO: the interior (t on its grown box, then ap), then the whole
    # boundary (t on the shell, then ap on every box), one launch a kernel,
    # into one ring-1 t array the split keeps in scratch; the ap tables'
    # rows in the walks of the boxes' sub-plan tiles (tiled K5HO)
    fuse.check_pre_rings(graph, rings, {"p": 2, "u": 2})
    p, u = ins["p"][0], ins["u"][0]
    if "t" not in scratch:
        scratch["t"] = torch.empty((24, math.prod(s + 2 for s in lattice)), dtype=p.dtype,
                                   device=p.device)
    args = (p, u, _normal_kappa(graph), lattice, interior)
    if part == "interior":
        wilson_normal_interior_cuda(*args, scratch["t"], outs["ap"], vvls[0], tile=tiles[0])
    else:
        wilson_normal_boundary_cuda(*args, boxes, scratch["t"], outs["ap"], vvls[0],
                                    tiles=tiles)


def _wilson_normal_tiled_cuda(graph, ins, scalars, *, lattice, plan, out_layouts, policy=None,
                              rsplit=1, batch=0, in_batched=None):
    # K5T, single or (batch set) over stacked p against one shared u
    if batch and (not in_batched["p"] or in_batched["u"]):
        raise ValueError("wilson_normal's batch instance takes a BatchedField p and one "
                         "gauge Field u shared by every slot")
    lays = _lays(ins, {"p": "p", "u": "u"}, out_layouts)
    ap, pap = wilson_normal_tiled_cuda(ins["p"][0], _policy_u(ins["u"][0], policy),
                                       _normal_kappa(graph), lattice,
                                       (plan.bx, plan.by, plan.bz), layouts=lays,
                                       batched=bool(batch), policy=policy, rsplit=rsplit)
    return {"ap": ap, "pap": pap}


# The batch instances (K5B, K3B): each takes its inputs stacked or shared as
# ``in_batched`` says, and its scalars as (batch,) device vectors.

def _wilson_normal_batched_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts, batch,
                                in_batched, policy=None, rsplit=1):
    if not in_batched["p"] or in_batched["u"]:
        raise ValueError("wilson_normal's batch instance takes a BatchedField p and one "
                         "gauge Field u shared by every slot")
    lays = _lays(ins, {"p": "p", "u": "u"}, out_layouts)
    ap, pap = wilson_normal_cuda(ins["p"][0], _policy_u(ins["u"][0], policy),
                                 _normal_kappa(graph), lattice, vvl,
                                 layouts=lays, batched=True, policy=policy, rsplit=rsplit)
    return {"ap": ap, "pap": pap}


def _cg_update_masked_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts, batch,
                           in_batched, rsplit=1):
    lays = _lays(ins, {n: n for n in ("x", "r", "p", "ap")}, out_layouts)
    x_new, r_new, rr = fuse.cg_update_masked(
        ins["x"][0], ins["r"][0], ins["p"][0], ins["ap"][0], scalars["alpha"],
        scalars["neg_alpha"], scalars["m"], vvl, layouts=lays, rsplit=rsplit)
    return {"x_new": x_new, "r_new": r_new, "rr": rr}


def _cg_xpay_masked_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts, batch, in_batched):
    lays = _lays(ins, {"x": "x", "y": "y"}, out_layouts)
    return {"out": fuse.cg_xpay_masked(ins["x"][0], ins["y"][0], scalars["a"], scalars["m"],
                                       vvl, layouts=lays)}


def _dot_prod_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts, batch, in_batched):
    lays = _lays(ins, {"x": "x", "y": "y"}, {"out": out_layouts["p"]})
    return {"p": site_mul(ins["x"][0], ins["y"][0], vvl, layouts=lays, batch=batch)}


register_cuda_body(_g5_body, _g5_cuda)
register_cuda_body(_mul_body, _mul_cuda)
register_cuda_body(_axpy_body, _axpy_cuda)
register_cuda_graph(cg_update_graph(24), _cg_update_cuda, ("x_new", "r_new", "rr"), policy=True)
register_cuda_graph(cg_xpay_graph(24), _cg_xpay_cuda, ("out",))
register_cuda_graph(wilson_normal_graph(0.0), _wilson_normal_cuda, ("ap", "pap"),
                    batched=_wilson_normal_batched_cuda, policy=True,
                    tiled=_wilson_normal_tiled_cuda, tiled_batch=True,
                    pre=_wilson_normal_pre_cuda, pre_outputs=("ap",),
                    box=_wilson_normal_box_cuda)
register_cuda_graph(masked_cg_update_graph(24), None, ("x_new", "r_new", "rr"),
                    batched=_cg_update_masked_cuda)
register_cuda_graph(masked_xpay_graph(24), None, ("out",), batched=_cg_xpay_masked_cuda)
register_cuda_graph(dot_prod_graph(24), None, ("p",), batched=_dot_prod_cuda)

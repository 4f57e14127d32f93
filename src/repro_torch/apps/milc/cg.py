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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import Field, LaunchGraph, TargetConfig, launch, target_sum
from repro_torch.core import fuse
from repro_torch.core.fuse import register_cuda_graph
from repro_torch.core.target import register_cuda_body, site_axpy, site_g5, site_mul
from repro_torch.kernels.wilson_dslash import dslash
from repro_torch.kernels.wilson_dslash.kernel import wilson_normal_cuda
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
    (ncomp,) sum (``rr.sum()`` is |r_new|^2)."""
    out = cg_update_graph(x.ncomp).launch(
        {"x": x, "r": r, "p": p, "ap": ap},
        scalars={"alpha": alpha, "neg_alpha": -alpha},
        config=config,
        outputs=("x_new", "r_new", "rr"),
        out_layouts={"x_new": x.layout, "r_new": r.layout},
    )
    return x.with_data(out["x_new"].data), r.with_data(out["r_new"].data), out["rr"]


def dot(x: Field, y: Field, config: TargetConfig) -> torch.Tensor:
    """<x, y> as the real inner product over all components/sites, a 0-d
    tensor on the fields' device."""
    prod = launch(_mul_body, {"x": x, "y": y}, {"out": x.ncomp},
                  config=config)["out"]
    return target_sum(prod, config).sum()


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
    (A = M^dag M); ap keeps p's name and layout, <p, A p> is 0-d."""
    bound = wilson_normal_graph(float(kappa)).bind(
        config=config, outputs=("ap", "pap"))

    def apply(p: Field):
        out = bound({"p": p, "u": u}, out_layouts={"ap": p.layout})
        return p.with_data(out["ap"].data), out["pap"].sum(dim=-1)

    return apply


def make_wilson_op(u: Field, kappa: float, config: TargetConfig):
    """Returns apply_m, apply_mdag, apply_normal (M^dag M)."""

    def apply_m(psi: Field) -> Field:
        d = dslash(psi, u, config=config)
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
    apply_a_dot: Optional[Callable[[Field], Tuple[Field, torch.Tensor]]] = None,
) -> CGResult:
    """Standard CG on a positive-definite operator, as a host loop.

    apply_a_dot, when given, computes (A p, <p, A p>) in one fused launch
    (see make_fused_normal) — the iteration then runs two fused launches:
    operator+dot, and update-chain+residual-norm, plus the p update."""
    b2 = dot(b, b, config)
    x = b.with_data(torch.zeros_like(b.data))
    r = b
    p = b
    rr = dot(r, r, config)
    it = 0
    # the convergence test is the one host synchronisation per iteration
    while it < max_iter and bool(rr / b2 > tol):
        if apply_a_dot is not None:
            ap, pap = apply_a_dot(p)
            alpha = rr / pap
        else:
            ap = apply_a(p)
            alpha = rr / dot(p, ap, config)
        x, r, rr_vec = fused_cg_update(x, r, p, ap, alpha, config)
        rr_new = rr_vec.sum()
        beta = rr_new / rr
        p = fused_xpay(r, beta, p, config)
        rr = rr_new
        it += 1
    return CGResult(x=x, iterations=it, residual=rr / b2)


# -- the hand-written kernels behind these bodies and graphs on "cuda" --------------
#
# Each impl hands its kernel the input tensors with their layouts and the
# output layouts; the kernel writes each output in its layout.

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


def _cg_update_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts):
    lays = _lays(ins, {n: n for n in ("x", "r", "p", "ap")}, out_layouts)
    x_new, r_new, rr = fuse.cg_update(ins["x"][0], ins["r"][0], ins["p"][0], ins["ap"][0],
                                      scalars["alpha"], scalars["neg_alpha"], vvl,
                                      layouts=lays)
    return {"x_new": x_new, "r_new": r_new, "rr": rr}


def _cg_xpay_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts):
    lays = _lays(ins, {"x": "x", "y": "y"}, out_layouts)
    return {"out": fuse.cg_xpay(ins["x"][0], ins["y"][0], scalars["a"], vvl, layouts=lays)}


def _wilson_normal_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts):
    params = graph.stage_params()
    kappa = params[1]["kappa"]
    if params[3]["kappa"] != kappa:
        raise ValueError("wilson_normal: both g5(psi - kappa d) stages must "
                         "share one kappa")
    lays = _lays(ins, {"p": "p", "u": "u"}, out_layouts)
    ap, pap = wilson_normal_cuda(ins["p"][0], ins["u"][0], kappa, lattice, vvl, layouts=lays)
    return {"ap": ap, "pap": pap}


register_cuda_body(_g5_body, _g5_cuda)
register_cuda_body(_mul_body, _mul_cuda)
register_cuda_body(_axpy_body, _axpy_cuda)
register_cuda_graph(cg_update_graph(24), _cg_update_cuda, ("x_new", "r_new", "rr"))
register_cuda_graph(cg_xpay_graph(24), _cg_xpay_cuda, ("out",))
register_cuda_graph(wilson_normal_graph(0.0), _wilson_normal_cuda, ("ap", "pap"))

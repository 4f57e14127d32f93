"""Public wrapper for LB propagation (engine dispatch) and the fused
collision -> propagation LB step.

Propagation is a stencil (site-neighbour gather).  The fused step runs it
as a stencil stage of a ``core.fuse.LaunchGraph``; on the "cuda" engine the
graph runs as K5L, one launch in which the post-collision distributions
never reach device memory, and under a tiled plan as K9.  The halo'd form of
the sharded path, :func:`propagate_halo`, runs K8H on "cuda".

On "cuda" the fused graph is registered under every halo strategy: on
pre-exchanged halos (``halo="pre"``) it runs K5LH, under a tiled plan or
off SoA K9H, and on the ``halo="overlap"`` split's boxes K5LHO (K9H under
a box's tile or off SoA), in every layout and so in the block view.  A
DtypePolicy or a batch under "pre" and "overlap" still raises (ROADMAP
queue 2).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import SOA, Field, LaunchGraph, LoweringPlan, TargetConfig
from repro_torch.core.fuse import check_pre_rings, register_cuda_graph
from repro_torch.core.plan import plan_for_launch, plan_tile
from repro_torch.core.target import require_cuda
from repro_torch.kernels.lb_collision.ops import collide_kernel
from repro_torch.maths import d3q19
from . import kernel, ref


def propagate(dist: Field, *, config: TargetConfig) -> Field:
    """Periodic streaming step on a single device."""
    plan = plan_for_launch(config, dist.nsites, [dist.layout])
    if plan.engine == "torch":
        out = ref.propagate_ref(dist.canonical_nd())
        return dist.with_canonical(out.reshape(dist.ncomp, dist.nsites))
    require_cuda("dist", dist.data)
    return dist.with_data(kernel.propagate_cuda(
        dist.data, dist.lattice, vvl=plan.vvl, layouts={"dist": dist.layout, "out": dist.layout}))


def propagate_halo(dist_halo: torch.Tensor, *, config: TargetConfig,
                   width: int = 1) -> torch.Tensor:
    """The halo'd-array form of the sharded path: dist_halo (19, X+2w,
    Y+2w, Z+2w) canonical with its halos exchanged -> the interior's
    streamed (19, X, Y, Z)."""
    nsites = math.prod(s - 2 * width for s in dist_halo.shape[1:])
    # the halo kernels check their last block's bounds: vvl need not divide
    plan = plan_for_launch(config, nsites, [SOA], bounded=True)
    if plan.engine == "torch":
        return kernel.propagate_halo_plain(dist_halo, width)
    require_cuda("dist_halo", dist_halo)
    return kernel.propagate_halo_cuda(dist_halo, width, vvl=plan.vvl)


def propagate_body(v, gather):
    """Propagation as a fused stencil-stage body: f'_i(r) = f_i(r - c_i)."""
    return {
        "dist": torch.stack([
            gather("dist", tuple(int(c) for c in d3q19.CV[i]))[i]
            for i in range(d3q19.NVEL)
        ])
    }


def collide_propagate_graph(tau: float) -> LaunchGraph:
    """BGK collision fused into propagation's gather: one launch."""
    return (
        LaunchGraph("lb_collide_propagate")
        .add(collide_kernel, {"dist": "dist", "force": "force"}, {"dist": 19},
             rename={"dist": "dist1"}, params=dict(tau=tau))
        .add_stencil(propagate_body, {"dist": "dist1"}, {"dist": 19},
                     width=1, rename={"dist": "dist2"})
    )


def collide_propagate(dist: Field, force: Field, *, tau: float,
                      config: TargetConfig, plan: Optional[LoweringPlan] = None) -> Field:
    """Fused LB step: BGK collision immediately followed by streaming, as a
    single launch (``plan``: an explicit plan for it)."""
    out = collide_propagate_graph(float(tau)).launch(
        {"dist": dist, "force": force},
        config=config,
        outputs=("dist2",),
        out_layouts={"dist2": dist.layout},
        plan=plan,
    )["dist2"]
    return dist.with_data(out.data)


def _collide_propagate_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts):
    tau = graph.stage_params()[0]["tau"]
    (d, ld), (f, lf) = ins["dist"], ins["force"]
    dist2, _ = kernel.lb_step_cuda(d, f, tau, lattice, vvl, with_u=False, layouts={
        "dist": ld, "force": lf, **out_layouts})
    return {"dist2": dist2}


def _collide_propagate_tiled_cuda(graph, ins, scalars, *, lattice, plan, out_layouts):
    tau = graph.stage_params()[0]["tau"]
    (d, ld), (f, lf) = ins["dist"], ins["force"]
    dist2, _ = kernel.lb_step_tiled_cuda(d, f, tau, lattice, (plan.bx, plan.by, plan.bz),
                                         with_u=False,
                                         layouts={"dist": ld, "force": lf, **out_layouts})
    return {"dist2": dist2}


def _collide_propagate_pre_cuda(graph, ins, scalars, *, lattice, rings, plan, out_layouts):
    # K5LH, or K9H under a tiled plan or off SoA: dist2 on the interior from
    # dist and force padded by 1
    check_pre_rings(graph, rings, {"dist": 1, "force": 1})
    tau = graph.stage_params()[0]["tau"]
    (d, ld), (f, lf) = ins["dist"], ins["force"]
    dist2, _ = kernel.lb_step_pre_cuda(d, f, tau, lattice, plan.vvl, with_u=False,
                                       tile=plan_tile(plan),
                                       layouts={"dist": ld, "force": lf, **out_layouts})
    return {"dist2": dist2}


def _collide_propagate_box_cuda(graph, ins, scalars, *, lattice, rings, vvls, tiles, part,
                                interior, boxes, outs, out_layouts, scratch):
    # K5LHO (K9H under a box's tile or off SoA), one launch a box
    check_pre_rings(graph, rings, {"dist": 1, "force": 1})
    tau = graph.stage_params()[0]["tau"]
    (d, ld), (f, lf) = ins["dist"], ins["force"]
    for (origin, extents), vvl, tile in zip(boxes, vvls, tiles):
        kernel.lb_step_box_cuda(d, f, tau, lattice, origin, extents, outs["dist2"], None, vvl,
                                tile=tile, layouts={"dist": ld, "force": lf, **out_layouts})


register_cuda_graph(collide_propagate_graph(0.0), _collide_propagate_cuda, ("dist2",),
                    tiled=_collide_propagate_tiled_cuda, pre=_collide_propagate_pre_cuda,
                    box=_collide_propagate_box_cuda, pre_layouts=True)

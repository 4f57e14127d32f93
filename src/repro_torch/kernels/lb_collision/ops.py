"""Public wrapper for the LB collision kernel (engine dispatch)."""

from __future__ import annotations

from repro_torch.core import Field, TargetConfig, TargetKernel
from repro_torch.core.plan import plan_for_launch
from repro_torch.core.target import register_cuda_body, require_cuda
from . import kernel, ref


def _collide_body(v, *, tau: float):
    """Site-local chunk body, exposed as a TargetKernel so collision can
    join fused launch graphs (core.fuse) with other site-local stages."""
    return {"dist": ref.collide_chunk(v["dist"], v["force"], tau)}


collide_kernel = TargetKernel(_collide_body, name="lb_collision")


def collide(dist: Field, force: Field, *, tau: float, config: TargetConfig) -> Field:
    """Post-collision distributions; same Field layout/lattice as ``dist``."""
    plan = plan_for_launch(config, dist.nsites, [dist.layout, force.layout])
    if plan.engine == "torch":
        out = ref.collide_ref(dist.canonical(), force.canonical(), tau)
        return dist.with_canonical(out)
    require_cuda("dist", dist.data)
    require_cuda("force", force.data)
    return dist.with_data(kernel.collide_cuda(
        dist.data, force.data, tau, vvl=plan.vvl,
        layouts={"dist": dist.layout, "force": force.layout, "out": dist.layout}))


def _collide_cuda(ins, params, vvl, out_layouts):
    (d, ld), (f, lf) = ins["dist"], ins["force"]
    return {"dist": kernel.collide_cuda(d, f, params["tau"], vvl, layouts={
        "dist": ld, "force": lf, "out": out_layouts["dist"]})}


register_cuda_body(_collide_body, _collide_cuda)

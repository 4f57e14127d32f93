"""Engine dispatch: one kernel body, two targets (paper §3.2).

A kernel body is a Python function over canonical ``(ncomp, sites)``
tensors.  Two engines run it:

  engine="torch"  the body itself over whole-lattice tensors, on whatever
                  device the Fields live on — the paper's host build, and
                  the oracle.
  engine="cuda"   the hand-written CUDA kernel registered for the body
                  (:func:`register_cuda_body`).  The JAX package's Pallas
                  engine traces any body into a kernel; CUDA cannot, so a
                  body with no registered kernel raises rather than falling
                  back to torch ops.  The kernels take fp32 Fields on a
                  CUDA device in any layout (SoA, AoS, AoSoA), address them
                  through INDEX inside the kernel and write each output in
                  its own layout; they raise for anything else.

This module also holds K1, the site-local kernels (``csrc/site_local.cu``)
that replace ``core/target.py::TargetKernel._run_pallas`` of the JAX
package for the bodies on the MILC solve's path, each beside its plain
PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from .._cuda import Kernel, check_batched_field, check_field
from .field import Field
from .layout import Layout, resolve_layouts
from .plan import DtypePolicy, LoweringPlan, plan_for_launch, resolved_smem_bytes

__all__ = ["TargetConfig", "TargetKernel", "kernel", "launch",
           "register_cuda_body", "require_cuda", "site_g5", "site_mul", "mul_plain",
           "operand_shape", "operand_slot", "batch_operand",
           "site_axpy", "G5", "MUL", "AXPY"]


@dataclasses.dataclass(frozen=True)
class TargetConfig:
    """Build options of a launch.

    engine       "cuda" (the hand-written kernels) or "torch" (torch ops).
    device       where the drivers place the Fields they create ("cuda" or
                 "cpu"); a CUDA device with no card present raises.
    vvl          sites per CUDA block (the paper's Virtual Vector Length).
    plan_policy  "default" (core.plan.default_plan), "tuned" (each
                 LaunchGraph launch runs the autotuner's persisted winner,
                 core.tune; a miss, a site-local launch or a standalone
                 reduction plans by default) or an explicit LoweringPlan for
                 every launch.
    smem_bytes   shared-memory byte budget of a stencil launch's block.  None
                 defers to $TARGETDP_TORCH_SMEM_BYTES, 0 means unbounded; a
                 budget makes the default plans tile stencil launches whose
                 whole-lattice staging would exceed it.
    dtypes       a mixed-precision DtypePolicy (core.plan) applied to every
                 LaunchGraph launch and ``target_sum`` made with this
                 config whose plan carries no policy of its own (an explicit
                 plan's policy wins).  None, the default, changes nothing.
    """

    engine: str = "cuda"
    device: str = "cuda"
    vvl: int = 128
    plan_policy: Union[str, LoweringPlan] = "default"
    smem_bytes: Optional[int] = None
    dtypes: Optional[DtypePolicy] = None

    def resolved_smem_bytes(self) -> Optional[int]:
        return resolved_smem_bytes(self)


def require_cuda(what: str, t: torch.Tensor) -> None:
    """Raise ValueError unless ``t`` lies on a CUDA device: the cuda engine
    never runs on the CPU instead."""
    if t.device.type != "cuda":
        raise ValueError(
            f"cuda engine: {what} lies on {t.device}; the cuda engine's "
            f"kernels run on a CUDA device only (use TargetConfig('torch', "
            f"device='cpu') for the CPU)")


# -- K1: site-local kernels ------------------------------------------------------

G5 = Kernel("g5", "rt_site_g5")
MUL = Kernel("mul", "rt_site_mul")
AXPY = Kernel("axpy", "rt_site_axpy")


# Each wrapper below takes physical tensors and ``layouts``, a mapping from
# its tensor names to their Layouts (an input not named is SoA, an output
# not named takes the first input's layout), and returns physical tensors
# in the outputs' layouts.  On a CPU tensor it runs its plain version:
# unpack, the torch arithmetic, pack.  ``vvl`` does not shape K1 (its
# blocks are its own, csrc/site_local.cu); the wrappers of every lattice
# kernel take the plan's.


def g5_plain(x: torch.Tensor, flip_from: int, layouts=None) -> torch.Tensor:
    lay = resolve_layouts(layouts, ("x",), ("out",))
    c = lay["x"].unpack(x)
    return lay["out"].pack(torch.cat([c[:flip_from], -c[flip_from:]], dim=0))


def site_g5(x: torch.Tensor, flip_from: int, vvl: int = 128, *, layouts=None) -> torch.Tensor:
    """A field ``x`` -> the same with components >= flip_from negated
    (gamma5 on a spinor at flip_from=12); ``layouts`` names "x", "out"."""
    if x.device.type == "cpu":
        return g5_plain(x, flip_from, layouts)
    lay = resolve_layouts(layouts, ("x",), ("out",))
    ncomp, nsites = lay["x"].logical_shape(x.shape)
    if not 0 <= flip_from <= ncomp:
        raise ValueError(f"site_g5: need 0 <= flip_from <= ncomp, got {flip_from}, {ncomp}")
    lx = check_field("x", x, lay["x"], ncomp, nsites, x.device)
    out = torch.empty(lay["out"].physical_shape(ncomp, nsites), dtype=x.dtype, device=x.device)
    G5.launch(x.device, x.data_ptr(), out.data_ptr(), ncomp, nsites, flip_from, lx,
              lay["out"].descriptor())
    return out


def _binary_plain(fn, x, y, layouts):
    lay = resolve_layouts(layouts, ("x", "y"), ("out",))
    return lay["out"].pack(fn(lay["x"].unpack(x), lay["y"].unpack(y)))


# A batch launch (the serving path) takes each field operand either as
# ``batch`` fields stacked on a leading axis or as one field shared by every
# slot, told apart by rank, and writes ``batch`` stacked fields.

def operand_shape(t: torch.Tensor, lay: Layout) -> Tuple[int, int]:
    """(ncomp, nsites) of a shared or a stacked field operand."""
    return lay.logical_shape(t.shape[-lay.physical_ndim:])


def operand_slot(t: torch.Tensor, lay: Layout, b: int) -> torch.Tensor:
    """Slot ``b``'s canonical (ncomp, nsites) values of a shared or a
    stacked field operand."""
    return lay.unpack(t[b] if t.dim() > lay.physical_ndim else t)


def batch_operand(name, t, lay, ncomp, nsites, batch, device,
                  dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(layout descriptor, per-slot element stride) of a batch launch's
    field operand of ``dtype``: one field a slot (stride ncomp * nsites) or
    one shared field (stride 0)."""
    if t.dim() == lay.physical_ndim:
        return check_field(name, t, lay, ncomp, nsites, device, dtype), 0
    return (check_batched_field(name, t, lay, ncomp, nsites, batch, device, dtype),
            ncomp * nsites)


def mul_plain(x: torch.Tensor, y: torch.Tensor, layouts=None,
              batch: Optional[int] = None) -> torch.Tensor:
    """:func:`site_mul` in torch ops (slot by slot with a batch)."""
    if batch is None:
        return _binary_plain(torch.mul, x, y, layouts)
    lay = resolve_layouts(layouts, ("x", "y"), ("out",))
    return torch.stack([lay["out"].pack(operand_slot(x, lay["x"], b)
                                        * operand_slot(y, lay["y"], b)) for b in range(batch)])


def site_mul(x: torch.Tensor, y: torch.Tensor, vvl: int = 128, *, layouts=None,
             batch: Optional[int] = None) -> torch.Tensor:
    """x * y elementwise; ``layouts`` names "x", "y", "out".  With
    ``batch`` (the product of the batched dot, dot_prod), x and y are each
    ``batch`` stacked fields or one shared field and the result is
    ``batch`` stacked fields: the same kernel, the slot one more grid
    axis."""
    if x.device.type == "cpu":
        return mul_plain(x, y, layouts, batch)
    lay = resolve_layouts(layouts, ("x", "y"), ("out",))
    ncomp, nsites = operand_shape(x, lay["x"])
    if batch is None:
        (lx, sx), (ly, sy) = ((check_field(n, t, lay[n], ncomp, nsites, x.device), 0)
                              for n, t in (("x", x), ("y", y)))
        shape = lay["out"].physical_shape(ncomp, nsites)
    else:
        (lx, sx), (ly, sy) = (batch_operand(n, t, lay[n], ncomp, nsites, batch, x.device)
                              for n, t in (("x", x), ("y", y)))
        shape = (batch,) + lay["out"].physical_shape(ncomp, nsites)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    MUL.launch(x.device, x.data_ptr(), y.data_ptr(), out.data_ptr(), ncomp, nsites,
               1 if batch is None else batch, sx, sy, lx, ly, lay["out"].descriptor())
    return out


def site_axpy(a: float, x: torch.Tensor, y: torch.Tensor, vvl: int = 128, *,
              layouts=None) -> torch.Tensor:
    """x * a + y elementwise, a a Python float; ``layouts`` names "x",
    "y", "out"."""
    if x.device.type == "cpu":
        return _binary_plain(lambda u, v: u * a + v, x, y, layouts)
    lay = resolve_layouts(layouts, ("x", "y"), ("out",))
    ncomp, nsites = lay["x"].logical_shape(x.shape)
    lx = check_field("x", x, lay["x"], ncomp, nsites, x.device)
    ly = check_field("y", y, lay["y"], ncomp, nsites, x.device)
    out = torch.empty(lay["out"].physical_shape(ncomp, nsites), dtype=x.dtype, device=x.device)
    AXPY.launch(x.device, float(a), x.data_ptr(), y.data_ptr(), out.data_ptr(), ncomp, nsites,
                lx, ly, lay["out"].descriptor())
    return out


# body function -> fn(ins: {arg: (physical tensor, Layout)}, params, vvl,
# out_layouts: {key: Layout}) -> {key: physical tensor in its out layout}
_CUDA_BODIES: Dict[Callable, Callable] = {}


def register_cuda_body(body: Callable, impl: Callable) -> None:
    """Run ``impl(ins, params, vvl, out_layouts)`` for ``body`` on the cuda
    engine: ``ins`` maps each body argument to its (physical tensor,
    Layout), ``out_layouts`` each output key to its Layout, and ``impl``
    returns each output as a physical tensor its kernel wrote in that
    layout."""
    _CUDA_BODIES[body] = impl


class TargetKernel:
    """A site-local data-parallel kernel (the paper's __targetEntry__ unit)."""

    def __init__(self, body: Callable, name: Optional[str] = None):
        self.body = body
        self.name = name or getattr(body, "__name__", "kernel")

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"TargetKernel({self.name})"

    def _run_torch(self, ins: Dict[str, Field], params: Mapping) -> Dict[str, torch.Tensor]:
        return self.body({k: f.canonical() for k, f in ins.items()}, **dict(params))

    def _run_cuda(self, ins: Dict[str, Field], params: Mapping, plan: LoweringPlan,
                  out_layouts: Mapping[str, Layout]) -> Dict[str, torch.Tensor]:
        impl = _CUDA_BODIES.get(self.body)
        if impl is None:
            raise ValueError(
                f"cuda engine: no hand-written CUDA kernel is registered for "
                f"site-local body {self.name!r} (register one with "
                f"register_cuda_body, or use engine='torch')")
        for k, f in ins.items():
            require_cuda(f"input {k!r}", f.data)
        return impl({k: (f.data, f.layout) for k, f in ins.items()}, dict(params),
                    plan.vvl, dict(out_layouts))


def kernel(fn: Optional[Callable] = None, *, name: Optional[str] = None):
    """Decorator: wrap a site-local kernel body in a TargetKernel."""

    def wrap(f):
        return TargetKernel(f, name=name)

    return wrap(fn) if fn is not None else wrap


def launch(
    kern: Union[TargetKernel, Callable],
    ins: Dict[str, Field],
    out_specs: Mapping[str, Union[int, tuple]],
    *,
    config: Optional[TargetConfig] = None,
    params: Optional[Mapping] = None,
    out_layouts: Optional[Mapping[str, Layout]] = None,
) -> Dict[str, Field]:
    """Execute a kernel over the lattice (the paper's __targetLaunch__).

    ins         name -> input Field (all sharing nsites).
    out_specs   name -> ncomp (or (ncomp, dtype)) of each output Field.
    Returns     name -> output Field (layout = out_layouts[name] or the
                first input's layout).
    """
    if not isinstance(kern, TargetKernel):
        kern = TargetKernel(kern)
    config = config or TargetConfig()
    params = params or {}
    first = next(iter(ins.values()))
    for k, f in ins.items():
        if f.nsites != first.nsites:
            raise ValueError(f"all fields in one launch must share nsites; "
                             f"{k!r} has {f.nsites}, expected {first.nsites}")
    specs = {k: (v if isinstance(v, tuple) else (int(v), first.dtype))
             for k, v in out_specs.items()}
    out_layouts = dict(out_layouts or {})
    for k in specs:
        out_layouts.setdefault(k, first.layout)
    plan = plan_for_launch(
        config, first.nsites,
        [f.layout for f in ins.values()] + [out_layouts[k] for k in specs])
    if plan.engine == "torch":
        outs = kern._run_torch(ins, params)
        for k, (ncomp, dtype) in specs.items():
            if tuple(outs[k].shape) != (ncomp, first.nsites):
                raise ValueError(f"kernel {kern.name!r} output {k!r} has shape "
                                 f"{tuple(outs[k].shape)}, declared ({ncomp}, {first.nsites})")
        # the body's canonical outputs, packed into their layouts
        outs = {k: out_layouts[k].pack(outs[k].to(dtype)) for k, (_, dtype) in specs.items()}
    else:
        # the kernels' outputs, already in their layouts: wrapped, not packed
        outs = kern._run_cuda(ins, params, plan, {k: out_layouts[k] for k in specs})

    fields = {}
    for k, (ncomp, dtype) in specs.items():
        arr = outs[k]
        want = out_layouts[k].physical_shape(ncomp, first.nsites)
        if tuple(arr.shape) != want or arr.dtype != dtype:
            raise ValueError(f"kernel {kern.name!r} output {k!r} is {tuple(arr.shape)} "
                             f"{arr.dtype}, declared {want} {dtype} "
                             f"({out_layouts[k].name})")
        fields[k] = Field(k, ncomp, first.lattice, out_layouts[k], arr)
    return fields

"""Launch graphs: chains of kernels that run as one fused launch.

A :class:`LaunchGraph` is an ordered chain of stages whose outputs feed
later inputs (paper §2.1.1 site-local and stencil kernels, §3.2.3
reductions):

``add``          site-local stage: the body sees canonical ``(ncomp, L)``
                 tensors, one value per site.
``add_stencil``  stencil stage: the body also receives ``gather(name,
                 disp)``, the input window displaced by ``disp``
                 (``out(r) = in(r - disp)``, ``|disp| <= width`` per dim).
``add_reduce``   terminal reduction (``target_sum``/``target_max``
                 semantics), returned per component as an ``(ncomp,)``
                 tensor.

A launch takes Fields or BatchedFields.  BatchedField inputs share one
batch size; a plain Field input (MILC's gauge field) is shared by every
slot; a scalar is a number, a 0-d tensor or a ``(batch,)`` per-slot vector.
Field outputs come back as BatchedFields and reductions as ``(batch,
ncomp)``, each slot bitwise the single launch on that slot.

Engines:

``"torch"``  runs the composed bodies over whole-lattice tensors.  Stencil
             graphs pad every external input periodically by the ring the
             backward width analysis (:meth:`LaunchGraph.halo_widths`)
             assigns it; site-local stages recompute on halo sites, so a
             later stencil stage can gather neighbours of an intermediate.
``"cuda"``   sends the graph's signature (:meth:`LaunchGraph.structure`) to
             the hand-written kernel registered for it
             (:func:`register_cuda_graph`) and raises for any other
             signature.  The kernel reads each input Field in its own
             layout and writes each output in its ``out_layouts`` layout;
             the launch wraps those tensors as Fields with no relayout.
             Stage params are not part of the signature: the kernel reads
             them from the graph.  A tiled plan (by or bz set, see
             ``core.plan``) runs the graph's registered tiled kernel
             instead (K9, K5T: they walk the tiles in the reference's
             order, in every layout, and stage no window), and raises when
             there is none: it never falls back to the untiled kernel or
             to torch ops.  A batched launch runs the graph's registered
             batched kernel (the slot a grid axis), under a tiled plan its
             tiled batched kernel, and raises when there is none.

On "torch" a batched launch runs the single launch slot by slot and stacks
the results, so each slot is the single launch's bits by construction.

A DtypePolicy (the plan's, else ``TargetConfig.dtypes``; ``core.plan``)
makes precision a lowering decision, as in the JAX package's launch: float
inputs are rounded to the storage dtype (round to nearest even) and widened
to the compute dtype, scalars cast to the compute dtype, float field
outputs come back in the storage dtype and float sums in the accumulate
dtype, compensated where ``resolve_accumulate`` says so; max and integer
reductions are exempt.  On "torch" the bodies run on the cast inputs and a
policy sum folds its fp32 source, compensated sums in fp64 rounded once
(the plain version every compensated sum is held to).  On "cuda" the graph's
registered kernels must have a policy instance (``register_cuda_graph(...,
policy=True)``: wilson_normal and ludwig_lb_step, untiled and tiled, and
wilson_normal's batch instances) and the policy must be one they take
(``core.plan.cuda_policy``); anything else raises before a device is
touched.  The empty policy runs exactly the policy-free kernels.

:func:`tiled_plain` is the tiled lowering in torch ops, tile by tile in the
tiled kernels' order: the plain version every tiled kernel is held against.

A plan's ``view`` resolves per launch (``core.plan.adapt_plan``).  On
"cuda" an explicit ``view="block"`` stencil launch is checked as the JAX
package checks it (:func:`_block_geometry`, before any device is touched)
and then runs the same kernels as "staged-nd": they read every layout in
place.  The torch engine ignores the view: its stencils always pad
canonical views; a tiled block plan is checked as the reference checks
it, per tile (an AoSoA input is required, the output alignment is not).
A plan's ``rsplit`` reaches every registered kernel that folds partial rows
(``rsplit=``), tiled or not, which folds them in that many segments
combined in index order (``core.reduce``); the field outputs do not change.
:meth:`ReduceSpec.combine_partials` is that stage-2 combine in torch ops.

``halo`` says where the stencil inputs' halos come from.  ``"periodic"``
(single device) pads them inside the launch.  ``"pre"`` (the sharded
path, ``core.halo``) takes each input already padded by its ring and
exchanged by the caller: the output lattice is the interior, each input's
lattice less twice its ring.  The torch engine stages the caller's arrays
as they are; the cuda engine runs the graph's registered ``"pre"`` kernel
(``register_cuda_graph(..., pre=)``: K5H for wilson_normal, K5LH for
ludwig_lb_step and lb_collide_propagate), which walks a tiled plan's tile
itself (K5TH, K9H), and raises for any other graph.  ``"overlap"``
(or a "pre" launch whose plan chose it) takes the same inputs and runs the
interior/boundary split of ``core.overlap``: on "torch" a "pre" launch a
box, on "cuda" the graph's box kernel (``register_cuda_graph(...,
box=)``: K5HO, K5LHO) on the interior and then on the whole boundary,
each box's sites in the walk of its sub-plan's tiles (tiled K5HO, K9H),
writing in place into outputs allocated once in their layouts.  Under
both, a plan's ``rsplit`` leaves the field outputs as they are (no "pre"
or box kernel folds partial rows), and an explicit ``view="block"`` is
checked on the halo'd lattices as the JAX package checks it and then runs
the same kernels.  The LB graphs' kernels take every layout (K9H;
``pre_layouts=True``), wilson_normal's SoA only.  Still to be ported there,
raising before any launch (ROADMAP queue 2): wilson_normal off SoA and in
the block view, a DtypePolicy, a batch, and a reduction output (pap) with
its per-split and per-box partials.

This module also holds K3, the flat fused CG kernels
(``csrc/fused_flat.cu``) that replace the JAX package's
``LaunchGraph._build_flat`` for the ``cg_update`` and ``cg_xpay`` graphs,
and K3B, its batch instances for the serving chains (``cg_update_masked``,
``cg_xpay_masked``), each beside its plain PyTorch version; the third,
``dot_prod``, is ``target.site_mul`` with a batch.  The update chains also
take a bf16 ap (the refined solve's operator output; their ap16
instances), with fp32 x, r, p and outputs, and cg_update has a policy
instance (any input fp32 or bf16, bf16 storage, a compensated rr).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .._cuda import Kernel, check_field, check_tensor, check_typed_field
from .field import BatchedField, Field, backend_name
from .layout import SOA as SOA_LAYOUT
from .layout import Layout, LayoutKind, resolve_layouts
from .plan import (VIEW_BLOCK, DtypePolicy, LoweringPlan, adapt_plan, cuda_policy, default_plan,
                   graph_plan_key, launch_policy, plan_tile, policy_plan, resolve_accumulate,
                   sub_lattice_plan)
from .reduce import compensated_plain, fold_partials, fold_partials_batched
from .stencil import halo_pad, tile_boxes
from .target import (TargetConfig, TargetKernel, batch_operand, operand_shape, operand_slot,
                     require_cuda)

__all__ = ["LaunchGraph", "BoundLaunch", "ReduceSpec", "register_cuda_graph",
           "tiled_plain", "kahan_fold", "cg_update", "cg_xpay", "CG_UPDATE", "CG_XPAY",
           "cg_update_masked", "cg_xpay_masked", "CG_UPDATE_MASKED", "CG_XPAY_MASKED",
           "CG_UPDATE_AP16", "CG_UPDATE_MASKED_AP16", "CG_UPDATE_POLICY", "policy_stage_in",
           "check_pre_rings"]

log = logging.getLogger(__name__)

_RED_COMBINE = {"sum": torch.add, "max": torch.maximum}
_RED_FOLD = {"sum": lambda x, dim: x.sum(dim=dim),
             "max": lambda x, dim: x.amax(dim=dim)}


@dataclasses.dataclass(frozen=True)
class ReduceSpec:
    """One terminal reduction's metadata: the reduction monoid.

    op       "sum" | "max".
    source   the graph value being folded (None for a bare-op spec).
    ncomp    per-component width when known from the producing stage.
    dtype    the accumulate dtype (None: the launch's default).
    """

    op: str
    source: Optional[str] = None
    ncomp: Optional[int] = None
    dtype: Optional[object] = None

    def __post_init__(self):
        if self.op not in _RED_COMBINE:
            raise ValueError(
                f"unknown reduction op {self.op!r}; have {list(_RED_COMBINE)}")

    @property
    def combine(self) -> Callable:
        """The monoid combine fn — how any two partials merge."""
        return _RED_COMBINE[self.op]

    def init(self, shape, dtype, device=None) -> torch.Tensor:
        """An identity-filled accumulator (dtype-aware: an integer max starts
        at iinfo.min, not a float -inf cast)."""
        if self.op == "max":
            fill = (torch.iinfo(dtype).min if not dtype.is_floating_point
                    else float("-inf"))
            return torch.full(shape, fill, dtype=dtype, device=device)
        return torch.zeros(shape, dtype=dtype, device=device)

    def fold(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """Fold along ``axis`` (the site axis)."""
        return _RED_FOLD[self.op](x, axis)

    def combine_partials(self, parts: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The stage-2 combine of a split reduction: fold the stage-1
        partials along ``axis`` by a sequential combine in index order
        (((p0 + p1) + p2) + ...; ``torch.maximum`` keeps NaN), so the bits
        are fixed for a fixed partial count.  Exact for max and integer
        sums; fp sums reassociate within tolerance of the unsplit fold."""
        parts = torch.movedim(parts, axis, 0)
        acc = parts[0]
        for k in range(1, parts.shape[0]):
            acc = self.combine(acc, parts[k])
        return acc



def kahan_fold(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Compensated (Kahan) summation along ``axis``: the JAX package's
    sequential sum-plus-compensation scan, step for step in the same order
    and in x's dtype, with the other axes carried elementwise (a (ncomp,
    nsites) fold is nsites steps on (ncomp,) carries)."""
    x = torch.movedim(x, axis, 0)
    s = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    c = torch.zeros_like(s)
    for xi in x:
        y = xi - c
        t = s + y
        c = (t - s) - y
        s = t
    return s


def _kahan_combine(acc: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """The JAX package's Kahan combine of a widened ``(..., ncomp, 2)``
    accumulator (column 0 the running sum, column 1 the running
    compensation) with a ``(..., ncomp, 1)`` partial, step for step.  The
    cuda engine's compensated folds combine (hi, lo) pairs instead
    (``csrc/comp.cuh``); both are held to the fp64 oracle."""
    s, c = acc[..., 0:1], acc[..., 1:2]
    y = part - c
    t = s + y
    return torch.cat([t, (t - s) - y], dim=-1)


def _block_geometry(ordered_ins: Sequence[str], in_layouts: Sequence[Layout],
                    in_rings: Sequence[int], out_layouts: Mapping[str, Layout],
                    field_outputs: Sequence[str], lattice: Tuple[int, ...],
                    tiled: bool = False) -> None:
    """The launch-time check of a stencil launch under ``view="block"``
    (the JAX package's ``_block_geometry``, periodic halos; the form of
    ``core.plan.block_view_ok`` that names the offender): raises for an
    AoSoA input whose SAL does not divide its halo'd inner-plane count, for
    a launch with no AoSoA layout at all, and for an AoSoA output whose SAL
    does not divide the interior inner-plane count.  Under a ``tiled``
    plan, as in the reference, the view needs an AoSoA input and the
    outputs are not checked (its tiles write canonical tiles).  The cuda
    kernels read every layout in place, so on the card the check is all the
    view changes."""
    aosoa_in_play = False
    for name, lay, ring in zip(ordered_ins, in_layouts, in_rings):
        if lay.kind is not LayoutKind.AOSOA:
            continue
        aosoa_in_play = True
        inner_h = math.prod(s + 2 * ring for s in lattice[1:])
        if inner_h % lay.sal:
            raise ValueError(
                f"view='block': AoSoA(sal={lay.sal}) input {name!r} has halo'd "
                f"inner-plane site count {inner_h} not divisible by sal; x-slab windows "
                f"would split short arrays; use view='staged-nd' or a conforming sal "
                f"(core.plan.block_view_ok)")
    if tiled:
        if not aosoa_in_play:
            raise ValueError(
                "view='block' under a tiled plan (by/bz) lowers AoSoA inputs "
                "natively, but no input layout of this launch is AoSoA; use "
                "view='staged-nd'")
        return
    if not aosoa_in_play and not any(
            out_layouts[o].kind is LayoutKind.AOSOA for o in field_outputs):
        raise ValueError(
            "view='block' lowers AoSoA tiles natively, but no input or output "
            "layout of this launch is AoSoA; use view='staged-nd'")
    inner = math.prod(lattice[1:])
    bad = [o for o in field_outputs
           if out_layouts[o].kind is LayoutKind.AOSOA and inner % out_layouts[o].sal]
    if bad:
        raise ValueError(
            f"view='block': AoSoA output(s) {bad} have sal not dividing the interior "
            f"inner-plane site count {inner}; slab rows would split short arrays; "
            f"use view='staged-nd' or a conforming sal")


def _stage_in_cast(storage_dt, compute_dt):
    """The policy's stage-in cast of one input tensor: a float input is
    rounded to the storage dtype and widened to the compute dtype; any other
    input passes bitwise.  None when the policy casts nothing."""
    if storage_dt is None and compute_dt is None:
        return None
    cdt = compute_dt or storage_dt

    def cast(d: torch.Tensor) -> torch.Tensor:
        if not d.is_floating_point():
            return d
        if storage_dt is not None and d.dtype != storage_dt:
            d = d.to(storage_dt)
        return d.to(cdt) if d.dtype != cdt else d

    return cast


def _policy_sum(src: torch.Tensor, dt, comp: bool) -> torch.Tensor:
    """A policy sum of (ncomp, sites) values over the sites on the torch
    engine: compensated (:func:`~repro_torch.core.reduce.compensated_plain`),
    else accumulated in ``dt``."""
    return compensated_plain(src, dim=1) if comp else src.to(dt).sum(dim=1)


class _Policy(NamedTuple):
    """A launch's resolved DtypePolicy (see the module docstring)."""

    pol: Optional[DtypePolicy]
    cast: Optional[Callable]                # the stage-in cast, or None
    scalar_dt: Optional[torch.dtype]        # the scalars' dtype, None: the first input's
    acc_fold: Dict[str, Tuple[torch.dtype, bool]]   # policy sums: (dtype, compensated)


def _crop_ring(arr: torch.Tensor, r_from: int, r_to: int) -> torch.Tensor:
    """Shrink an (ncomp, *window) value from valid ring r_from to r_to."""
    if r_from == r_to:
        return arr
    d = r_from - r_to
    sl = (slice(None),) + tuple(slice(d, s - d) for s in arr.shape[1:])
    return arr[sl]


@dataclasses.dataclass(frozen=True)
class _Stage:
    kernel: Optional[TargetKernel]
    ins: Tuple[Tuple[str, str], ...]              # (body arg, graph value name)
    outs: Tuple[Tuple[str, str, Optional[int], object], ...]
    params: Tuple[Tuple[str, object], ...]
    kind: str = "map"                             # "map" | "stencil" | "reduce"
    width: int = 0                                # stencil halo reach
    op: str = ""                                  # reduce monoid

    def structure(self):
        """The stage's shape without its param values (see
        :meth:`LaunchGraph.structure`)."""
        body = self.kernel.body if self.kernel is not None else None
        return (self.kind, self.width, self.op, body, self.ins, self.outs,
                tuple(k for k, _ in self.params))


class _CudaEntry(NamedTuple):
    impl: Optional[Callable]        # the untiled single-lattice kernel
    outputs: Tuple[str, ...]        # what the kernels produce
    tiled: Optional[Callable]       # the tiled kernel
    batched: Optional[Callable]     # the batch instance
    policy: bool                    # every kernel of the entry takes a DtypePolicy
    tiled_batch: bool               # the tiled kernel has a batch instance
    pre: Optional[Callable]         # the kernel on pre-exchanged halos (halo="pre")
    pre_outputs: Tuple[str, ...]    # what that kernel produces
    box: Optional[Callable]         # that kernel on the split's boxes (halo="overlap")
    pre_layouts: bool               # the "pre" and box kernels take every layout


# LaunchGraph.structure() -> its kernels
_CUDA_GRAPHS: Dict[tuple, _CudaEntry] = {}
# what a "pre" or box kernel's missing output is: no such kernel writes a
# reduction's partial rows yet
_PRE_REDUCE = (" (a reduction under halo='pre' or 'overlap' is still to be ported, "
               "ROADMAP queue 2 (g))")


def register_cuda_graph(graph: "LaunchGraph", impl: Optional[Callable],
                        outputs: Sequence[str],
                        tiled: Optional[Callable] = None,
                        batched: Optional[Callable] = None,
                        policy: bool = False,
                        tiled_batch: bool = False,
                        pre: Optional[Callable] = None,
                        pre_outputs: Optional[Sequence[str]] = None,
                        box: Optional[Callable] = None,
                        pre_layouts: bool = False) -> None:
    """Run ``impl(graph, ins, scalars, lattice=, vvl=, out_layouts=)`` for
    every graph of ``graph``'s structure on the cuda engine,
    ``tiled(graph, ins, scalars, lattice=, plan=, out_layouts=)`` under a
    tiled plan and ``batched(graph, ins, scalars, lattice=, vvl=,
    out_layouts=, batch=, in_batched=)`` for a batched launch; with
    ``tiled_batch`` set, ``tiled`` also takes ``batch=, in_batched=`` for
    a batched launch under a tiled plan.
    ``ins`` maps value names to (physical tensor, Layout), ``scalars`` to
    0-d device tensors (``(batch,)`` ones when batched), ``out_layouts``
    each requested field output to its Layout, ``in_batched`` each input to
    whether it is a stack of ``batch`` fields (else one shared field); each
    returns every name in ``outputs``: fields as physical tensors the kernel
    wrote in their layouts (``(batch,) + physical`` when batched),
    reductions (ncomp,) (``(batch, ncomp)``).  ``impl`` may be None for a
    graph that only the serving path launches, batched.  ``policy``: every
    kernel registered here has a policy instance and takes ``policy=`` (a
    ``core.plan.CudaPolicy``) under a non-empty DtypePolicy; the launch
    raises for a policy on any other graph.  The kernels of a graph with a
    terminal reduction also take ``rsplit=`` (the plan's split factor),
    which their partial folds take.  ``pre(graph, ins, scalars, lattice=,
    rings=, plan=, out_layouts=)`` runs a ``halo="pre"`` launch: ``ins``
    are the caller's halo'd tensors, ``rings`` each input's ring,
    ``lattice`` the interior the outputs cover, ``plan`` the launch's (its
    vvl the block size; under a tiled plan it walks ``plan``'s tile,
    ``core.plan.plan_tile``); it returns ``pre_outputs`` (default
    ``outputs``).  ``box(graph, ins,
    scalars, lattice=, rings=, vvls=, tiles=, part=, interior=, boxes=,
    outs=, out_layouts=, scratch=)`` runs that kernel on boxes of the
    interior (the ``halo="overlap"`` split), called
    twice a split: ``part="interior"`` with ``boxes`` the interior box
    alone, then ``part="boundary"`` with every boundary box; ``ins`` and
    ``rings`` as for ``pre``, each box an (origin, extents) pair, ``vvls``
    each box's block size, ``tiles`` each box's sub-plan tile (bx, by, bz)
    or None where the sub-plan is untiled, ``interior`` the interior box in
    both calls, ``outs`` the field outputs' physical tensors over the whole
    interior in ``out_layouts``, of which it writes the boxes' sites, and
    ``scratch`` a dict the split passes to both calls (what the boundary
    reuses of the interior's launches).  A kernel may launch once a box or
    once a call.  The ``"pre"`` and box kernels take no policy; with
    ``pre_layouts`` set they take every layout, else SoA fields only."""
    _CUDA_GRAPHS[graph.structure()] = _CudaEntry(
        impl, tuple(outputs), tiled, batched, policy, bool(tiled_batch), pre,
        tuple(pre_outputs if pre_outputs is not None else outputs), box,
        bool(pre_layouts))


def check_pre_rings(graph: "LaunchGraph", rings: Mapping[str, int],
                    want: Mapping[str, int]) -> None:
    """The check of a ``"pre"`` kernel's impl: each input padded by the ring
    its kernel takes (``want``); raises before any launch."""
    if dict(rings) != dict(want):
        raise ValueError(f"cuda engine: graph {graph.name!r}'s halo='pre' kernel takes rings "
                         f"{dict(want)}, got {dict(rings)}")


def _slot_scalar(v, b: int):
    """Slot ``b``'s value of a batched launch's scalar: the ``(batch,)``
    vector's element, or the scalar itself."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return t[b] if t.dim() == 1 else v


class LaunchGraph:
    """An ordered chain of kernel stages fused into one launch."""

    def __init__(self, name: str = "fused"):
        self.name = name
        self._stages: List[_Stage] = []

    def __repr__(self):  # pragma: no cover - cosmetic
        names = [s.kernel.name if s.kernel else f"reduce:{s.op}"
                 for s in self._stages]
        return f"LaunchGraph({self.name}, stages={names})"

    # -- construction ----------------------------------------------------------

    def _check_not_after_reduce(self, kind: str, name: str) -> None:
        if any(s.kind == "reduce" for s in self._stages):
            raise ValueError(
                f"{kind} stage {name!r} cannot follow a reduction stage: a "
                f"reduction changes the value shape (per-site lattice -> "
                f"per-component), so only further terminal reductions may "
                f"come after it")

    def _prepare_stage(self, kern, ins, out_specs, params, rename):
        if not isinstance(kern, TargetKernel):
            kern = TargetKernel(kern)
        params = dict(params or {})
        for k, v in params.items():
            if isinstance(v, torch.Tensor):
                raise TypeError(
                    f"stage {kern.name!r} param {k!r} is a tensor; pass runtime "
                    f"values via launch(..., scalars={{...}})")
        rename = dict(rename or {})
        produced = {v for st in self._stages for (_, v, _, _) in st.outs}
        outs = []
        for body_key, spec in out_specs.items():
            ncomp, dtype = spec if isinstance(spec, tuple) else (spec, None)
            vname = rename.get(body_key, body_key)
            if vname in produced:
                raise ValueError(
                    f"graph value {vname!r} produced twice; use rename= to "
                    f"give stage {kern.name!r}'s output a fresh name")
            produced.add(vname)
            outs.append((body_key, vname, int(ncomp), dtype))
        return kern, tuple(sorted(ins.items())), tuple(outs), tuple(
            sorted(params.items()))

    def add(self, kern, ins: Mapping[str, str], out_specs, *,
            params: Optional[Mapping] = None,
            rename: Optional[Mapping[str, str]] = None) -> "LaunchGraph":
        """Append a site-local stage.  Returns self (chainable).

        ins        body argument name -> graph value name.
        out_specs  body output key -> ncomp (or (ncomp, dtype)).
        rename     body output key -> graph value name (default: the key).
        params     static keyword arguments of the body."""
        kern, ins_t, outs, params_t = self._prepare_stage(
            kern, ins, out_specs, params, rename)
        self._check_not_after_reduce("site-local", kern.name)
        self._stages.append(_Stage(kern, ins_t, outs, params_t))
        return self

    def add_stencil(self, kern, ins: Mapping[str, str], out_specs, *,
                    width: int = 1, params: Optional[Mapping] = None,
                    rename: Optional[Mapping[str, str]] = None) -> "LaunchGraph":
        """Append a stencil stage reaching ``width`` sites per lattice dim.
        The body is ``body(v, gather, **params)``: ``v[arg]`` is the centred
        (ncomp, *window) value, ``gather(arg, d)`` the window displaced by
        ``d``."""
        if width < 1:
            raise ValueError(f"stencil stage needs width >= 1, got {width}")
        kern, ins_t, outs, params_t = self._prepare_stage(
            kern, ins, out_specs, params, rename)
        self._check_not_after_reduce("stencil", kern.name)
        self._stages.append(_Stage(kern, ins_t, outs, params_t, kind="stencil",
                                   width=int(width)))
        return self

    def add_reduce(self, value: str, op: str = "sum", *,
                   name: Optional[str] = None) -> "LaunchGraph":
        """Append a terminal reduction of graph value ``value`` over all
        (interior) sites, returned by launch() as an ``(ncomp,)`` tensor
        named ``name`` (default ``"{value}_{op}"``)."""
        if op not in _RED_COMBINE:
            raise ValueError(
                f"unknown reduction op {op!r}; have {list(_RED_COMBINE)}")
        out_name = name or f"{value}_{op}"
        reduced = {v for st in self._stages if st.kind == "reduce"
                   for (_, v, _, _) in st.outs}
        if value in reduced:
            raise ValueError(
                f"cannot reduce {value!r}: it is itself a reduction result")
        produced = {v for st in self._stages for (_, v, _, _) in st.outs}
        if out_name in produced:
            raise ValueError(f"graph value {out_name!r} produced twice")
        self._stages.append(
            _Stage(None, (("x", value),), (("out", out_name, None, None),),
                   (), kind="reduce", op=op))
        return self

    # -- graph structure -------------------------------------------------------

    @property
    def has_stencil(self) -> bool:
        return any(st.kind == "stencil" for st in self._stages)

    def structure(self) -> tuple:
        """The signature the cuda engine dispatches on: every stage's kind,
        width, monoid, body function, wiring and param *names*."""
        return tuple(st.structure() for st in self._stages)

    def stage_params(self) -> List[Dict[str, object]]:
        """Each stage's static params, in stage order."""
        return [dict(st.params) for st in self._stages]

    def external_inputs(self) -> List[str]:
        """Value names consumed but never produced by an earlier stage, in
        first-use order — what launch() must be fed as Fields or scalars."""
        produced, ext = set(), []
        for st in self._stages:
            for _, vname in st.ins:
                if vname not in produced and vname not in ext:
                    ext.append(vname)
            for _, vname, _, _ in st.outs:
                produced.add(vname)
        return ext

    def _produced(self) -> Dict[str, Tuple[Optional[int], object]]:
        return {vname: (ncomp, dtype) for st in self._stages
                for (_, vname, ncomp, dtype) in st.outs}

    def _reduce_outputs(self) -> List[str]:
        return [v for st in self._stages if st.kind == "reduce"
                for (_, v, _, _) in st.outs]

    def reduce_specs(self) -> Dict[str, ReduceSpec]:
        """reduce output name -> :class:`ReduceSpec`."""
        prod = self._produced()
        specs: Dict[str, ReduceSpec] = {}
        for st in self._stages:
            if st.kind != "reduce":
                continue
            ((_, vname),) = st.ins
            for (_, out, _, dtype) in st.outs:
                specs[out] = ReduceSpec(
                    op=st.op, source=vname,
                    ncomp=prod.get(vname, (None, None))[0], dtype=dtype)
        return specs

    def _required_rings(self, outputs: Sequence[str]) -> Dict[str, int]:
        """Backward width analysis: minimum valid halo ring each graph value
        needs so the requested outputs are exact on the interior."""
        need: Dict[str, int] = {o: 0 for o in outputs}
        for st in reversed(self._stages):
            if st.kind == "reduce":
                for _, v in st.ins:
                    need[v] = max(need.get(v, 0), 0)
                continue
            r = max((need.get(v, 0) for (_, v, _, _) in st.outs), default=0)
            w = st.width if st.kind == "stencil" else 0
            for _, v in st.ins:
                need[v] = max(need.get(v, 0), r + w)
        return need

    def halo_widths(self, outputs: Optional[Sequence[str]] = None) -> Dict[str, int]:
        """Halo ring each external input needs (0 for site-local-only graphs)."""
        if outputs is None:
            outputs = [v for (_, v, _, _) in self._stages[-1].outs]
        need = self._required_rings(tuple(outputs))
        return {n: need.get(n, 0) for n in self.external_inputs()}

    def plan_signature(self) -> tuple:
        """The process-stable structural signature the tune table keys on:
        the graph's name and every stage's kind, kernel *name*, width,
        monoid, wiring, output specs and params (repr), never a function
        object (which does not survive the process boundary the table must
        cross; :meth:`structure` holds them)."""
        sig = []
        for st in self._stages:
            name = st.kernel.name if st.kernel is not None else st.op
            outs = tuple((b, v, nc, None if dt is None else str(dt)) for b, v, nc, dt in st.outs)
            sig.append((st.kind, name, st.width, st.op, st.ins, outs,
                        tuple((k, repr(v)) for k, v in st.params)))
        return (self.name, tuple(sig))

    def plan_key(self, ins: Mapping[str, Field], *, config: Optional[TargetConfig] = None,
                 outputs: Optional[Sequence[str]] = None, halo: str = "periodic",
                 lattice: Optional[Sequence[int]] = None) -> str:
        """The tune table's key of launching this graph with ``ins``
        (``core.plan.graph_plan_key``): the signature, each input's name,
        width, dtype, layout and lattice, the lattice (the interior under
        ``halo="pre"``; default the first input's), the engine, the halo
        strategy ("pre" and "overlap" share keys, as in the JAX package),
        the outputs, the backend (the CUDA device's name, or "cpu") and, for
        a batched launch, the batch size and which inputs are batched."""
        config = config or TargetConfig()
        ordered = [n for n in self.external_inputs() if n in ins]
        if outputs is None:
            outputs = [v for (_, v, _, _) in self._stages[-1].outs]
        first = ins[ordered[0]] if ordered else next(iter(ins.values()))
        if lattice is None:
            lattice = first.lattice
        inputs = tuple((n, ins[n].ncomp, str(ins[n].dtype).replace("torch.", ""),
                        ins[n].layout.name, tuple(ins[n].lattice)) for n in ordered)
        batch = max((ins[n].batch if isinstance(ins[n], BatchedField) else 0 for n in ordered),
                    default=0)
        batch_key = 0
        if batch:
            batch_key = (batch,) + tuple(int(isinstance(ins[n], BatchedField)) for n in ordered)
        return graph_plan_key(self.plan_signature(), engine=config.engine,
                              halo="pre" if halo == "overlap" else halo,
                              outputs=tuple(outputs), inputs=inputs, lattice=tuple(lattice),
                              backend=backend_name(first.device), batch=batch_key)

    def bytes_moved(self, ins_ncomp: Mapping[str, int], nsites: int,
                    outputs: Optional[Sequence[str]] = None,
                    itemsize: int = 4, dtypes: Optional[DtypePolicy] = None) -> Dict[str, int]:
        """Device-memory traffic model of this chain, fused vs unfused
        (reads + writes, ``itemsize`` bytes per element, or the storage
        itemsize of a ``dtypes`` policy).  unfused: every stage reads its
        inputs and writes its outputs; fused: each external input is read
        once and only the requested non-reduction outputs are written.  Halo
        re-reads and scalars are not modelled."""
        if dtypes is not None and dtypes.storage:
            itemsize = dtypes.storage_itemsize(itemsize)
        ncomp = dict(ins_ncomp)
        for vname, (nc, _) in self._produced().items():
            ncomp[vname] = 0 if nc is None else nc
        if outputs is None:
            outputs = [v for (_, v, _, _) in self._stages[-1].outs]
        unfused = 0
        for st in self._stages:
            for _, vname in st.ins:
                unfused += ncomp.get(vname, 0)
            for _, vname, nc, _ in st.outs:
                unfused += 0 if nc is None else nc
        fused = sum(ncomp.get(n, 0) for n in self.external_inputs())
        fused += sum(ncomp[o] for o in outputs)
        return {"unfused": unfused * nsites * itemsize,
                "fused": fused * nsites * itemsize}

    # -- execution --------------------------------------------------------------

    def bind(self, *, config: Optional[TargetConfig] = None,
             outputs: Optional[Sequence[str]] = None,
             out_layouts: Optional[Mapping[str, Layout]] = None,
             halo: str = "periodic",
             plan: Optional[LoweringPlan] = None) -> "BoundLaunch":
        """Freeze the launch keywords into a reusable callable."""
        return BoundLaunch(
            self, config=config,
            outputs=tuple(outputs) if outputs is not None else None,
            out_layouts=dict(out_layouts) if out_layouts else None,
            halo=halo, plan=plan)

    def launch(
        self,
        ins: Dict[str, Field],
        *,
        config: Optional[TargetConfig] = None,
        outputs: Optional[Sequence[str]] = None,
        scalars: Optional[Mapping] = None,
        out_layouts: Optional[Mapping[str, Layout]] = None,
        halo: str = "periodic",
        plan: Optional[LoweringPlan] = None,
    ) -> Dict[str, Union[Field, torch.Tensor]]:
        """Execute the fused chain.

        ins         graph value name -> input Field or BatchedField (all
                    sharing a lattice; BatchedFields one batch size, Fields
                    shared by every slot).
        outputs     graph value names to return (default: the last stage's
                    outputs).  Reductions come back as (ncomp,) tensors
                    ((batch, ncomp) when batched), everything else as Fields
                    (BatchedFields).
        scalars     graph value name -> runtime scalar (a number or a 0-d
                    tensor, or, in a batched launch, a (batch,) per-slot
                    vector; the cuda kernels read it on the device).
        out_layouts graph output name -> Layout (default: first input's).
        halo        "periodic" (single device: the launch pads the stencil
                    inputs), "pre" (each input comes padded by its ring,
                    ``halo_widths()``, and exchanged; the outputs cover the
                    interior) or "overlap" ("pre"'s inputs under the
                    interior/boundary split, ``core.overlap``; a plan that
                    chose "overlap" also upgrades a "pre" launch).
        plan        explicit LoweringPlan for this launch (overrides
                    config.plan_policy).
        """
        if not self._stages:
            raise ValueError("LaunchGraph has no stages")
        if not ins:
            raise ValueError("fused launch needs at least one input Field")
        if halo not in ("periodic", "pre", "overlap"):
            raise ValueError(f"halo must be 'periodic', 'pre' or 'overlap', got {halo!r}")
        config = config or TargetConfig()
        scalars = dict(scalars or {})
        stencil = self.has_stencil
        if halo != "periodic" and not stencil:
            raise ValueError(f"halo={halo!r} only applies to graphs with stencil stages")
        # "overlap" takes "pre"'s inputs
        pre = halo != "periodic"

        first = next(iter(ins.values()))
        # the leading batch axis: BatchedField inputs stack `batch`
        # independent same-shape lattices; plain Fields are shared by every
        # slot (one gauge field serving many right-hand sides)
        in_batch = {n: f.batch if isinstance(f, BatchedField) else 0 for n, f in ins.items()}
        batch = max(in_batch.values(), default=0)
        if batch and pre:
            raise ValueError(
                f"a batched launch of graph {self.name!r} under halo={halo!r} is not yet "
                f"ported (ROADMAP queue 2 (f))")
        if batch:
            bad_b = {n: b for n, b in in_batch.items() if b not in (0, batch)}
            if bad_b:
                raise ValueError(
                    f"batched inputs disagree on the batch size: {bad_b} vs {batch}; "
                    f"every BatchedField in one launch must stack the same number "
                    f"of lattices")
        double = sorted(set(ins) & set(scalars))
        if double:
            raise ValueError(
                f"value(s) {double} supplied as both input Fields and "
                f"scalars; each graph value must have exactly one binding")
        ext = self.external_inputs()
        missing = [n for n in ext if n not in ins and n not in scalars]
        if missing:
            raise ValueError(
                f"graph consumes value(s) {missing} produced by no earlier "
                f"stage and not supplied as inputs or scalars")
        ordered_ins = [n for n in ext if n in ins]
        ordered_scalars = [n for n in ext if n in scalars]
        if batch:
            for n in ordered_scalars:
                v = scalars[n]
                shape = tuple((v if isinstance(v, torch.Tensor) else torch.as_tensor(v)).shape)
                if shape not in ((), (batch,)):
                    raise ValueError(
                        f"batched launch scalar {n!r} must be a scalar or a "
                        f"({batch},) per-request vector, got shape {shape}")

        prod = self._produced()
        if outputs is None:
            outputs = [v for (_, v, _, _) in self._stages[-1].outs]
        outputs = tuple(outputs)
        unknown = [o for o in outputs if o not in prod]
        if unknown:
            raise ValueError(f"requested outputs {unknown} produced by no stage")
        red_names = set(self._reduce_outputs())
        field_outputs = tuple(o for o in outputs if o not in red_names)

        need = self._required_rings(outputs) if stencil else {}
        if pre:
            # the interior: each input's lattice less twice its ring
            rings = {n: need.get(n, 0) for n in ordered_ins}
            interiors = {n: tuple(s - 2 * r for s in ins[n].lattice) for n, r in rings.items()}
            lattice = interiors[ordered_ins[0]]
            bad = {n: lat for n, lat in interiors.items() if lat != lattice}
            if bad or any(s < 1 for s in lattice):
                raise ValueError(
                    f"pre-halo'd inputs disagree on the interior lattice (lattice - 2*ring "
                    f"per input, rings {rings}): "
                    f"{ {n: ins[n].lattice for n in ordered_ins} }")
        else:
            lattice = first.lattice
            bad = {k: f.lattice for k, f in ins.items() if f.lattice != lattice}
            if bad:
                raise ValueError(
                    f"all Fields in a fused launch must share nsites and lattice "
                    f"shape: {first.name!r} has {lattice}, mismatched {bad}")
        nsites = int(math.prod(lattice))

        out_layouts = dict(out_layouts or {})
        for o in field_outputs:
            out_layouts.setdefault(o, first.layout)
        out_info = {}
        for o in outputs:
            nc, dt = prod[o]
            if nc is None:  # reduction: ncomp of the reduced value
                src = self.reduce_specs()[o].source
                nc = prod.get(src, (None, None))[0]
                if nc is None:
                    nc = ins[src].ncomp
            out_info[o] = (int(nc), dt or first.dtype)

        # the footprint descriptor the shared-memory planner prices a
        # stencil launch by: (ncomp, ring, itemsize) per input, (ncomp,
        # itemsize) per field output
        smem_views = None
        if stencil:
            smem_views = (
                tuple((ins[n].ncomp, need.get(n, 0), ins[n].data.element_size())
                      for n in ordered_ins),
                tuple((out_info[o][0], out_info[o][1].itemsize) for o in field_outputs))

        all_layouts = ([ins[n].layout for n in ordered_ins]
                       + [out_layouts[o] for o in field_outputs])

        def default():
            # a default plan's view stays "auto": never the block view's check
            return default_plan(config, nsites=nsites, layouts=all_layouts, stencil=stencil,
                                lattice=lattice, smem_views=smem_views, bounded=pre, halo=halo)

        from_table = False
        if plan is None and getattr(config, "plan_policy", "default") == "tuned":
            from . import tune
            plan = tune.lookup(self.plan_key(ins, config=config, outputs=outputs, halo=halo,
                                             lattice=lattice))
            from_table = plan is not None
        elif plan is None:
            plan = policy_plan(config)
        if plan is None:
            plan = default()
        else:
            try:
                plan = adapt_plan(plan, stencil=stencil, halo=halo)
                # the "pre" kernels check their last block's bounds: vvl need
                # not divide the interior
                plan.validate(nsites=None if pre else nsites, lattice=lattice,
                              layouts=all_layouts, stencil=stencil)
                if stencil and plan.view == VIEW_BLOCK:
                    # the view's alignment, checked before any device is touched
                    _block_geometry(ordered_ins, [ins[n].layout for n in ordered_ins],
                                    [need.get(n, 0) for n in ordered_ins], out_layouts,
                                    field_outputs, lattice, tiled=plan.tiled)
            except ValueError:
                if not from_table:
                    raise
                # a table entry must never break a launch: the default plan
                log.warning("tuned plan %s does not fit the launch of graph %r (lattice %s); "
                            "using the default plan", plan.describe(), self.name, lattice,
                            exc_info=True)
                plan = default()
        # the config's policy applies where the plan carries none of its own
        _, dtypes = launch_policy(config, plan)
        if dtypes is not plan.dtypes:
            plan = dataclasses.replace(plan, dtypes=dtypes)
        policy = self._resolve_policy(plan, outputs, red_names, out_info, first)
        if plan.engine == "cuda" and not policy.pol:
            wide = [o for o in field_outputs
                    if out_info[o][1].is_floating_point and out_info[o][1] != torch.float32]
            if wide:
                raise ValueError(
                    f"cuda engine: a policy-free launch of graph {self.name!r} writes float32 "
                    f"fields, but its outputs {wide} would be {first.dtype} (the first "
                    f"input's dtype); pass a float32 first input or a dtype policy")

        if stencil and plan.halo == "overlap":
            # the split: interior and boundary sub-launches (core.overlap)
            from . import overlap
            return overlap.execute_split(self, ins, config=config, outputs=outputs,
                                         scalars=scalars, out_layouts=out_layouts, plan=plan)

        if plan.engine == "torch" and batch:
            vals = self._launch_torch_batched(ins, in_batch, scalars, batch, outputs,
                                              out_layouts, plan, red_names)
        elif plan.engine == "torch":
            vals = self._launch_torch(ins, ordered_ins, scalars, ordered_scalars,
                                      outputs, stencil, lattice, first, policy, pre)
            vals = {o: vals[o].to(out_info[o][1]) for o in outputs}
            # the bodies' canonical field outputs, packed into their layouts
            vals.update({o: out_layouts[o].pack(vals[o].reshape(out_info[o][0], nsites))
                         for o in field_outputs})
        else:
            # the kernels' field outputs, already in their layouts
            vals = self._launch_cuda(ins, ordered_ins, scalars, ordered_scalars,
                                     outputs, lattice, plan, first,
                                     {o: out_layouts[o] for o in field_outputs},
                                     batch, in_batch, policy,
                                     {n: need.get(n, 0) for n in ordered_ins} if pre else None)

        lead = (batch,) if batch else ()
        out: Dict[str, Union[Field, BatchedField, torch.Tensor]] = {}
        for o in outputs:
            ncomp, dtype = out_info[o]
            val = vals[o]
            want = lead + ((ncomp,) if o in red_names
                           else out_layouts[o].physical_shape(ncomp, nsites))
            if tuple(val.shape) != want or val.dtype != dtype:
                raise ValueError(
                    f"graph {self.name!r} output {o!r} is {tuple(val.shape)} {val.dtype}, "
                    f"expected {want} {dtype}")
            if o in red_names:
                out[o] = val
            elif batch:
                out[o] = BatchedField(o, batch, ncomp, lattice, out_layouts[o], val)
            else:
                out[o] = Field(o, ncomp, lattice, out_layouts[o], val)
        return out

    def _resolve_policy(self, plan, outputs, red_names, out_info, first) -> _Policy:
        """The plan's DtypePolicy resolved for this launch; rewrites
        ``out_info`` with the policy's output dtypes."""
        if not plan.dtypes:
            return _Policy(None, None, None, {})
        pol = plan.dtypes.validate()
        storage_dt = getattr(torch, pol.storage) if pol.storage else None
        compute_dt = getattr(torch, pol.compute) if pol.compute else None
        acc_name, comp = resolve_accumulate(pol.accumulate)
        ops = {o: spec.op for o, spec in self.reduce_specs().items()}
        acc_fold = {}
        for o in outputs:
            nc, dt = out_info[o]
            if not dt.is_floating_point:   # integer fields and sums are exempt
                continue
            if o in red_names:
                if acc_name and ops[o] == "sum":
                    out_info[o] = (nc, getattr(torch, acc_name))
                    acc_fold[o] = (getattr(torch, acc_name), comp)
            elif storage_dt is not None:
                out_info[o] = (nc, storage_dt)
        scalar_dt = None
        if (storage_dt is not None or compute_dt is not None) and first.dtype.is_floating_point:
            scalar_dt = compute_dt or storage_dt
        return _Policy(pol, _stage_in_cast(storage_dt, compute_dt), scalar_dt, acc_fold)

    def _launch_torch_batched(self, ins, in_batch, scalars, batch, outputs, out_layouts,
                              plan, red_names) -> Dict[str, torch.Tensor]:
        """The torch engine's batched launch: the single launch slot by slot
        (shared Fields as they are, per-slot scalars picked), stacked."""
        per = []
        for b in range(batch):
            ins_b = {n: f.element(b) if in_batch[n] else f for n, f in ins.items()}
            per.append(self.launch(ins_b, outputs=outputs, plan=plan,
                                   scalars={n: _slot_scalar(v, b) for n, v in scalars.items()},
                                   out_layouts=out_layouts))
        return {o: torch.stack([r[o] if o in red_names else r[o].data for r in per])
                for o in outputs}

    def _launch_torch(self, ins, ordered_ins, scalars, ordered_scalars,
                      outputs, stencil, lattice, first,
                      policy: _Policy, pre: bool = False) -> Dict[str, torch.Tensor]:
        cast = policy.cast or (lambda d: d)
        sdt = policy.scalar_dt or first.dtype
        specs = self.reduce_specs()

        def scalar(n):
            return torch.as_tensor(scalars[n], dtype=sdt, device=first.device).reshape(1, 1)

        if not stencil:
            values = {n: cast(ins[n].canonical()) for n in ordered_ins}
            values.update({n: scalar(n) for n in ordered_scalars})
            values, partials = self._run_stages(values)
            # a policy sum refolds its fp32 source, as the reference does
            partials.update({o: _policy_sum(values[specs[o].source], dt, comp)
                             for o, (dt, comp) in policy.acc_fold.items()})
            values.update(partials)
            return {o: values[o] for o in outputs}

        site_dims = tuple(range(1, len(lattice) + 1))
        need = self._required_rings(outputs)
        values = {}
        for n in ordered_ins:
            ring = need.get(n, 0)
            nd = cast(ins[n].canonical_nd())
            # "pre": the caller's halo'd array as it is, never padded again
            values[n] = (halo_pad(nd, ring, site_dims) if ring and not pre else nd, ring)
        values.update({n: (scalar(n), None) for n in ordered_scalars})
        values, partials = self._run_stages_nd(values, len(lattice))
        for o, (dt, comp) in policy.acc_fold.items():
            a0 = _crop_ring(*values[specs[o].source], 0)
            partials[o] = _policy_sum(a0.reshape(a0.shape[0], -1), dt, comp)
        res = dict(partials)
        for o in outputs:
            if o not in res:
                arr, r = values[o]
                res[o] = _crop_ring(arr, r, 0)
        return {o: res[o] for o in outputs}

    def _launch_cuda(self, ins, ordered_ins, scalars, ordered_scalars, outputs, lattice,
                     plan, first, out_layouts, batch, in_batch,
                     policy: _Policy, rings=None) -> Dict[str, torch.Tensor]:
        entry = _CUDA_GRAPHS.get(self.structure())
        pkw = {}
        if rings is not None:
            impl, produces, kw = self._pre_entry(
                entry, policy, lattice, rings, plan,
                {**{n: ins[n].layout for n in ordered_ins}, **out_layouts})
        else:
            if policy.pol:
                if entry is None or not entry.policy:
                    raise ValueError(
                        f"cuda engine: graph {self.name!r} has no policy instance of its "
                        f"kernels; a dtype policy ({policy.pol.tag()}) on it is not yet "
                        f"ported (use engine='torch', or no policy)")
                pkw = dict(policy=cuda_policy(policy.pol))
            impl, produces, kw = self._periodic_entry(entry, plan, lattice, batch)
            if self._reduce_outputs():
                kw["rsplit"] = plan.rsplit   # the kernel's partial folds (K2S where > 1)
        if batch:
            kw.update(batch=batch, in_batched={n: bool(in_batch[n]) for n in ordered_ins})
        extra = [o for o in outputs if o not in produces]
        if extra:
            raise ValueError(
                f"cuda engine: the kernel for graph {self.name!r} produces "
                f"{list(produces)}, not {extra}" + (_PRE_REDUCE if rings is not None else ""))
        for n in ordered_ins:
            require_cuda(f"input {n!r}", ins[n].data)
        sdt = policy.scalar_dt or first.dtype
        svals = {}
        for n in ordered_scalars:
            v = scalars[n]
            if isinstance(v, torch.Tensor):
                require_cuda(f"scalar {n!r}", v)
                v = v.to(sdt)
            else:
                v = torch.tensor(float(v), dtype=sdt, device=first.device)
            svals[n] = (v.broadcast_to((batch,)) if batch else v.reshape(())).contiguous()
        return impl(self, {n: (ins[n].data, ins[n].layout) for n in ordered_ins}, svals,
                    out_layouts=out_layouts, **kw, **pkw)

    def _pre_entry(self, entry, policy: _Policy, lattice, rings, plan, layouts):
        """(impl, outputs, keywords) of a halo="pre" launch: the graph's
        kernel on pre-exchanged halos, which walks a tiled plan's tile;
        raises where there is none and for what it does not take
        (:meth:`_pre_checks`)."""
        if entry is None or entry.pre is None:
            raise ValueError(
                f"cuda engine: no hand-written halo='pre' kernel is registered for "
                f"graph {self.name!r} (register one with register_cuda_graph(..., pre=)); "
                f"its pre-exchanged lowering is still to be ported (ROADMAP item 24)")
        self._pre_checks(entry, policy.pol, layouts, "'pre'")
        return entry.pre, entry.pre_outputs, dict(lattice=lattice, rings=rings, plan=plan)

    def _pre_checks(self, entry, pol, layouts, halo: str) -> None:
        """Raise for what the graph's "pre" and box kernels do not take: a
        dtype policy, and a field that is not SoA where they read and write
        SoA only (``register_cuda_graph(..., pre_layouts=False)``)."""
        if pol:
            raise ValueError(
                f"cuda engine: a dtype policy ({pol.tag()}) on graph {self.name!r} "
                f"under halo={halo} is not yet ported (ROADMAP queue 2 (e))")
        off = {n: lay.name for n, lay in layouts.items() if lay.kind is not LayoutKind.SOA}
        if off and not entry.pre_layouts:
            raise ValueError(
                f"cuda engine: graph {self.name!r}'s halo={halo} kernel reads and writes SoA "
                f"fields, got {off} (other layouts and the block view there are still to "
                f"be ported, ROADMAP queue 2 (g))")

    def _launch_cuda_boxes(self, ins, *, rings, lattice, interior, boundary, config, outputs,
                           scalars, out_layouts, plan, start=None, between=None):
        """The cuda engine's ``halo="overlap"`` split (``core.overlap``): the
        field outputs allocated once at the interior ``lattice`` in their
        ``out_layouts``, ``start()`` (the fill's mark), the graph's box
        kernel on the ``interior`` box, then ``between()`` (the exchange,
        which returns the boundary's inputs), then the box kernel on the
        whole ``boundary`` (in order) in one call; each box writes its sites
        in place, in the order of its sub-plan's tiles where
        :func:`~repro_torch.core.plan.sub_lattice_plan` keeps them.  Nothing
        but the launch runs between ``start()`` and ``between()``, so that
        the interior is on the card before the exchange's copies are issued
        beside it.  Raises, before any launch, where the graph has no box
        kernel and for what its "pre" launch refuses (a policy, a layout its
        kernels do not take, an output the kernel does not write)."""
        entry = _CUDA_GRAPHS.get(self.structure())
        ext = list(rings)
        out_layouts = dict(out_layouts or {})
        red_names = set(self._reduce_outputs())
        prod = self._produced()
        first = ins[ext[0]]
        field_outputs = [o for o in outputs if o not in red_names]
        for o in field_outputs:
            out_layouts.setdefault(o, first.layout)
        if entry is None or entry.box is None:
            raise ValueError(
                f"cuda engine: no hand-written box kernel is registered for graph "
                f"{self.name!r} (register one with register_cuda_graph(..., box=)); its "
                f"halo='overlap' split is still to be ported")
        _, dtypes = launch_policy(config, plan)
        self._pre_checks(entry, dtypes, {**{n: ins[n].layout for n in ext},
                                         **{o: out_layouts[o] for o in field_outputs}},
                         "'overlap'")
        extra = [o for o in outputs if o not in entry.pre_outputs]
        if extra:
            raise ValueError(
                f"cuda engine: the kernel for graph {self.name!r} produces "
                f"{list(entry.pre_outputs)}, not {extra}" + _PRE_REDUCE)
        boxes = [interior] + list(boundary)
        vvls, tiles = [], []
        for box in boxes:
            box_lat = tuple(e - s for s, e in box)
            sub = adapt_plan(sub_lattice_plan(plan, config, box_lat, halo="pre"), stencil=True,
                             halo="pre")
            vvls.append(sub.validate(lattice=box_lat, stencil=True,
                                     layouts=[ins[n].layout for n in ext]).vvl)
            tiles.append(plan_tile(sub))
        for n in ext:
            require_cuda(f"input {n!r}", ins[n].data)
        svals = {}
        for n, v in (scalars or {}).items():
            if isinstance(v, torch.Tensor):
                require_cuda(f"scalar {n!r}", v)
                svals[n] = v.to(first.dtype).reshape(()).contiguous()
            else:
                svals[n] = torch.tensor(float(v), dtype=first.dtype, device=first.device)
        nsites = math.prod(lattice)
        outs = {o: torch.empty(out_layouts[o].physical_shape(int(prod[o][0]), nsites),
                               dtype=torch.float32, device=first.device) for o in field_outputs}

        oe = [(tuple(s for s, _ in b), tuple(e - s for s, e in b)) for b in boxes]
        scratch: Dict = {}

        def run(part, idx, source):
            entry.box(self, {n: (source[n].data, source[n].layout) for n in ext}, svals,
                      lattice=lattice, rings=rings, vvls=[vvls[i] for i in idx],
                      tiles=[tiles[i] for i in idx], part=part, interior=oe[0],
                      boxes=[oe[i] for i in idx], outs=outs,
                      out_layouts={o: out_layouts[o] for o in field_outputs}, scratch=scratch)

        if start is not None:
            start()
        run("interior", [0], ins)
        source = between() if between is not None else ins
        if len(boxes) > 1:
            run("boundary", range(1, len(boxes)), source)
        return {o: Field(o, int(prod[o][0]), tuple(lattice), out_layouts[o], outs[o])
                for o in field_outputs}

    def _periodic_entry(self, entry, plan, lattice, batch):
        """(impl, outputs, keywords) of a periodic launch: the tiled, the
        batched or the single kernel; raises where the graph has none."""
        if plan.tiled:
            impl, produces = self._tiled_entry(entry, plan, lattice, batch)
            return impl, produces, dict(lattice=lattice, plan=plan)
        if batch:
            if entry is None or entry.batched is None:
                raise ValueError(
                    f"cuda engine: no hand-written batched CUDA kernel is registered "
                    f"for the signature of graph {self.name!r} (register one with "
                    f"register_cuda_graph(..., batched=), or use engine='torch')")
            return entry.batched, entry.outputs, dict(lattice=lattice, vvl=plan.vvl)
        if entry is None or entry.impl is None:
            raise ValueError(
                f"cuda engine: no hand-written CUDA kernel is registered for "
                f"the signature of graph {self.name!r} (register one with "
                f"register_cuda_graph, or use engine='torch')")
        return entry.impl, entry.outputs, dict(lattice=lattice, vvl=plan.vvl)

    def _tiled_entry(self, entry, plan, lattice, batch):
        """(tiled impl, outputs) for a tiled plan, batched or not; raises
        where the graph has no such kernel."""
        if entry is None or entry.tiled is None or (batch and not entry.tiled_batch):
            kind = "tiled batched" if batch else "tiled"
            raise ValueError(
                f"cuda engine: no hand-written {kind} kernel is registered for graph "
                f"{self.name!r} under tiled plan {plan.describe()} on lattice "
                f"{tuple(lattice)}; its tiled lowering is still to be ported (ROADMAP queue 2)")
        return entry.tiled, entry.outputs

    def _run_stages(self, values: Dict[str, torch.Tensor]) -> Tuple[
            Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Flat composed body (site-local graphs): one pass over all stages
        on (ncomp, L) tensors plus (1, 1) scalars.  Returns (values,
        partials) where partials holds the reduction folds."""
        partials: Dict[str, torch.Tensor] = {}
        for st in self._stages:
            if st.kind == "reduce":
                ((_, vname),) = st.ins
                partials[st.outs[0][1]] = _RED_FOLD[st.op](values[vname], 1)
                continue
            chunks = {arg: values[v] for arg, v in st.ins}
            outs = st.kernel.body(chunks, **dict(st.params))
            for body_key, vname, ncomp, _ in st.outs:
                arr = outs[body_key]
                if arr.shape[0] != ncomp:
                    raise ValueError(
                        f"stage {st.kernel.name!r} output {body_key!r} has "
                        f"ncomp {arr.shape[0]}, declared {ncomp}")
                values[vname] = arr
        return values, partials

    def _run_stages_nd(
        self,
        values: Dict[str, Tuple[torch.Tensor, Optional[int]]],
        site_ndim: int,
    ) -> Tuple[Dict[str, Tuple[torch.Tensor, Optional[int]]],
               Dict[str, torch.Tensor]]:
        """Stencil composed body: values are (tensor, ring) pairs where the
        tensor has shape (ncomp, *window) and ring counts the valid halo
        sites around the window's interior.  Site-local stages run over the
        whole window (recomputing on halo sites); stencil stages shrink the
        ring by their width; reductions fold the ring-0 interior."""
        partials: Dict[str, torch.Tensor] = {}
        for st in self._stages:
            if st.kind == "reduce":
                ((_, vname),) = st.ins
                arr, r = values[vname]
                a0 = _crop_ring(arr, r, 0)
                partials[st.outs[0][1]] = _RED_FOLD[st.op](
                    a0.reshape(a0.shape[0], -1), 1)
                continue

            stage_ins = [(arg, values[v]) for arg, v in st.ins]
            rings = [r for _, (_, r) in stage_ins if r is not None]
            if not rings:
                raise ValueError(f"stage {st.kernel.name!r} has no Field inputs")
            r_in = min(rings)

            if st.kind == "stencil":
                r_out = r_in - st.width
                if r_out < 0:
                    raise ValueError(
                        f"stencil stage {st.kernel.name!r} (width {st.width}) "
                        f"consumes a value valid only on ring {r_in}; its "
                        f"inputs need ring >= {st.width} — pad external "
                        f"inputs by halo_widths(), and do not chain it after a "
                        f"stage that already consumed the halo")
                by_arg = dict(stage_ins)
                width = st.width

                def gather(name, disp, _by_arg=by_arg, _r_out=r_out,
                           _width=width):
                    if name not in _by_arg:
                        raise KeyError(
                            f"gather({name!r}): not an input of this stage")
                    arr, r = _by_arg[name]
                    if r is None:
                        raise ValueError(
                            f"gather({name!r}): scalars have no geometry")
                    disp = tuple(int(d) for d in disp)
                    if len(disp) != site_ndim:
                        raise ValueError(
                            f"gather({name!r}): disp {disp} must have one "
                            f"entry per lattice dim ({site_ndim})")
                    if any(abs(d) > _width for d in disp):
                        raise ValueError(
                            f"gather({name!r}): |disp|={disp} exceeds stage "
                            f"width {_width}")
                    off = r - _r_out
                    sl = (slice(None),) + tuple(
                        slice(off - d, arr.shape[j + 1] - off - d)
                        for j, d in enumerate(disp))
                    return arr[sl]

                zeros = (0,) * site_ndim
                chunks = {}
                for arg, (arr, r) in stage_ins:
                    if r is None:  # scalar: broadcast over the nd window
                        chunks[arg] = arr.reshape((1,) * (1 + site_ndim))
                    else:
                        chunks[arg] = gather(arg, zeros)
                outs = st.kernel.body(chunks, gather, **dict(st.params))
                for body_key, vname, ncomp, _ in st.outs:
                    arr = outs[body_key]
                    if arr.shape[0] != ncomp:
                        raise ValueError(
                            f"stage {st.kernel.name!r} output {body_key!r} "
                            f"has ncomp {arr.shape[0]}, declared {ncomp}")
                    values[vname] = (arr, r_out)
                continue

            # site-local: crop all inputs to the common ring, flatten, run
            win_shape = None
            chunks = {}
            for arg, (arr, r) in stage_ins:
                if r is None:
                    chunks[arg] = arr  # (1, 1) broadcasts against (ncomp, L)
                else:
                    w = _crop_ring(arr, r, r_in)
                    win_shape = w.shape[1:]
                    chunks[arg] = w.reshape(w.shape[0], -1)
            outs = st.kernel.body(chunks, **dict(st.params))
            for body_key, vname, ncomp, _ in st.outs:
                arr = outs[body_key]
                if arr.shape[0] != ncomp:
                    raise ValueError(
                        f"stage {st.kernel.name!r} output {body_key!r} has "
                        f"ncomp {arr.shape[0]}, declared {ncomp}")
                values[vname] = (arr.reshape((ncomp,) + tuple(win_shape)), r_in)
        return values, partials


@dataclasses.dataclass(frozen=True)
class BoundLaunch:
    """A :meth:`LaunchGraph.launch` with its keywords frozen
    (:meth:`LaunchGraph.bind`).  Per-call keywords override the bound ones
    (``out_layouts`` merges, call entries winning)."""

    graph: LaunchGraph
    config: Optional[TargetConfig] = None
    outputs: Optional[Tuple[str, ...]] = None
    out_layouts: Optional[Mapping[str, Layout]] = None
    halo: str = "periodic"
    plan: Optional[LoweringPlan] = None

    def __call__(self, ins: Dict[str, Field], *, scalars: Optional[Mapping] = None,
                 config: Optional[TargetConfig] = None,
                 outputs: Optional[Sequence[str]] = None,
                 out_layouts: Optional[Mapping[str, Layout]] = None,
                 halo: Optional[str] = None,
                 plan: Optional[LoweringPlan] = None):
        layouts = dict(self.out_layouts or {})
        if out_layouts:
            layouts.update(out_layouts)
        return self.graph.launch(
            ins,
            config=config if config is not None else self.config,
            outputs=outputs if outputs is not None else self.outputs,
            scalars=scalars,
            out_layouts=layouts or None,
            halo=halo if halo is not None else self.halo,
            plan=plan if plan is not None else self.plan,
        )


def tiled_plain(graph: LaunchGraph, values: Mapping[str, torch.Tensor],
                lattice: Sequence[int], bx: int, by: int = 0, bz: int = 0, *,
                outputs: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """The tiled stencil lowering in torch ops: the plain version of every
    tiled kernel (the counterpart of the JAX package's interpret-mode tiled
    ``fused_kernel`` with ``finish_tile``).

    values   graph value name -> canonical (ncomp, *lattice) tensor, or a
             runtime scalar (a number or a 0-d tensor).
    Returns  output name -> canonical (ncomp, *lattice) tensor for fields,
             (ncomp,) for reductions.

    For each tile of :func:`tile_boxes` (x-slab outermost, z-tile fastest)
    it cuts the halo'd window from the periodic-padded inputs, runs the
    graph's stages on it, writes the interior tile and folds each
    reduction's per-tile partial into the running result in tile order."""
    lattice = tuple(int(s) for s in lattice)
    ndim = len(lattice)
    if outputs is None:
        outputs = [v for (_, v, _, _) in graph._stages[-1].outs]
    outputs = tuple(outputs)
    combine = {o: spec.combine for o, spec in graph.reduce_specs().items()}
    need = graph._required_rings(outputs)
    fields = {n: v for n, v in values.items()
              if isinstance(v, torch.Tensor) and v.dim() == ndim + 1}
    first = next(iter(fields.values()))
    padded = {n: (halo_pad(v, need.get(n, 0), range(1, ndim + 1)), need.get(n, 0))
              for n, v in fields.items()}
    scalars = {n: (torch.as_tensor(v, dtype=first.dtype, device=first.device).reshape(1, 1),
                   None) for n, v in values.items() if n not in fields}
    res: Dict[str, torch.Tensor] = {}
    for box in tile_boxes(lattice, bx, by, bz):
        win = dict(scalars)
        for n, (arr, ring) in padded.items():
            win[n] = (arr[(slice(None),) + tuple(slice(s, s + e + 2 * ring)
                                                 for s, e in box)], ring)
        win, partials = graph._run_stages_nd(win, ndim)
        for o in outputs:
            if o in combine:
                res[o] = combine[o](res[o], partials[o]) if o in res else partials[o]
                continue
            arr, ring = win[o]
            if o not in res:
                res[o] = torch.empty((arr.shape[0],) + lattice, dtype=arr.dtype,
                                     device=arr.device)
            res[o][(slice(None),) + tuple(slice(s, s + e) for s, e in box)] = \
                _crop_ring(arr, ring, 0)
    return res


# -- K3: the flat fused CG kernels ------------------------------------------------

CG_UPDATE = Kernel("cg_update", "rt_cg_update")
CG_XPAY = Kernel("cg_xpay", "rt_cg_xpay")
# K3 and K3B fed a bf16 ap (the refined inner CG, whose operator writes ap in
# the policy's bf16 storage); x, r, p and the outputs stay fp32
CG_UPDATE_AP16 = Kernel("cg_update_ap16", "rt_cg_update_ap16")
CG_UPDATE_MASKED_AP16 = Kernel("cg_update_masked_ap16", "rt_cg_update_masked_ap16")
# K3's policy instance: any of x, r, p, ap fp32 or bf16, rounded to bf16 at
# load under bf16 storage, x_new and r_new in bf16 there, rr compensated
# under a compensated accumulate
CG_UPDATE_POLICY = Kernel("cg_update_policy", "rt_cg_update_policy")


_CG_IN, _CG_OUT = ("x", "r", "p", "ap"), ("x_new", "r_new")


def _ap_dtype(ap: torch.Tensor) -> torch.dtype:
    """The dtype ap's slot takes: bf16 (the refined inner CG's operator
    output) or fp32; the kernel check refuses any other."""
    return torch.bfloat16 if ap.dtype == torch.bfloat16 else torch.float32


def policy_stage_in(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """An input of a policy instance's plain version as its kernel reads it:
    fp32, a bf16 input widened (exactly), rounded to bf16 first under
    ``bf16`` storage (the identity on a bf16 input)."""
    return (t.to(torch.bfloat16) if bf16 else t).float()


def cg_update_plain(x, r, p, ap, alpha, neg_alpha, layouts=None, policy=None):
    """x + alpha p, r + neg_alpha ap, and the per-component sum of the new
    residual squared — the cg_update graph's arithmetic in torch ops, on
    fields in ``layouts`` (names "x", "r", "p", "ap", "x_new", "r_new").  A
    bf16 input is widened to fp32 (exact), as the graph's type promotion
    does for ap.  ``policy`` (a ``core.plan.CudaPolicy``): under bf16
    storage the inputs are rounded to bf16 first and x_new, r_new come back
    in bf16; rr folds the fp32 r_new, in fp64 rounded once where
    compensated."""
    bf16, comp = policy or (False, False)
    lay = resolve_layouts(layouts, _CG_IN, _CG_OUT)
    x, r, p, ap = (policy_stage_in(lay[n].unpack(t), bf16) for n, t in zip(_CG_IN, (x, r, p, ap)))
    x_new = x + alpha * p
    r_new = r + neg_alpha * ap
    rr = compensated_plain(r_new * r_new, dim=1) if comp else (r_new * r_new).sum(dim=1)
    if bf16:
        x_new, r_new = x_new.to(torch.bfloat16), r_new.to(torch.bfloat16)
    return lay["x_new"].pack(x_new), lay["r_new"].pack(r_new), rr


def _cg_update_policy(x, r, p, ap, alpha, neg_alpha, vvl, lay, rsplit, bf16, comp):
    """K3's policy instance (see CG_UPDATE_POLICY)."""
    _, nsites = lay["x"].logical_shape(x.shape)
    ops = [check_typed_field(n, t, lay[n], 24, nsites, x.device)
           for n, t in zip(_CG_IN, (x, r, p, ap))]
    for name, t in (("alpha", alpha), ("neg_alpha", neg_alpha)):
        check_tensor(name, t, (), x.device)
    out_dt = torch.bfloat16 if bf16 else torch.float32
    x_new, r_new = (torch.empty(lay[n].physical_shape(24, nsites), dtype=out_dt, device=x.device)
                    for n in _CG_OUT)
    partials = torch.empty((-(-nsites // vvl), 24) + ((2,) if comp else ()), dtype=torch.float32,
                           device=x.device)
    in16 = sum(1 << k for k, (_, is16) in enumerate(ops) if is16)
    CG_UPDATE_POLICY.launch(x.device, x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
                            alpha.data_ptr(), neg_alpha.data_ptr(), x_new.data_ptr(),
                            r_new.data_ptr(), partials.data_ptr(), nsites, in16, int(bf16),
                            int(bf16), int(comp), *(d for d, _ in ops),
                            *(lay[n].descriptor() for n in _CG_OUT), vvl)
    return x_new, r_new, fold_partials(partials, "sum", compensated=comp, rsplit=rsplit)


def cg_update(x, r, p, ap, alpha, neg_alpha, vvl: int = 128, *, layouts=None, rsplit: int = 1,
              policy=None):
    """24-component fields x, r, p, ap (physical, in ``layouts``; names
    "x", "r", "p", "ap", "x_new", "r_new") and 0-d device scalars alpha,
    neg_alpha -> (x_new, r_new, rr (24,)).  One launch plus the partial
    fold (``rsplit`` segments, K2S where > 1).  ap may be bf16 (the refined
    solve's operator output): the kernel's ap16 instance widens it as it
    loads it.  ``policy`` (a ``core.plan.CudaPolicy``) asking for bf16
    storage or a compensated sum, or an x, r or p in bf16, runs the policy
    instance (CG_UPDATE_POLICY; :func:`cg_update_plain` its plain
    version)."""
    if x.device.type == "cpu":
        return cg_update_plain(x, r, p, ap, alpha, neg_alpha, layouts, policy)
    lay = resolve_layouts(layouts, _CG_IN, _CG_OUT)
    bf16, comp = policy or (False, False)
    if bf16 or comp or any(t.dtype == torch.bfloat16 for t in (x, r, p)):
        return _cg_update_policy(x, r, p, ap, alpha, neg_alpha, vvl, lay, rsplit, bf16, comp)
    _, nsites = lay["x"].logical_shape(x.shape)
    ap_dt = _ap_dtype(ap)
    desc = [check_field(n, t, lay[n], 24, nsites, x.device, dt)
            for n, t, dt in zip(_CG_IN, (x, r, p, ap), (torch.float32,) * 3 + (ap_dt,))]
    for name, t in (("alpha", alpha), ("neg_alpha", neg_alpha)):
        check_tensor(name, t, (), x.device)
    x_new, r_new = (torch.empty(lay[n].physical_shape(24, nsites), dtype=x.dtype,
                                device=x.device) for n in _CG_OUT)
    partials = torch.empty((-(-nsites // vvl), 24), dtype=x.dtype, device=x.device)
    (CG_UPDATE_AP16 if ap_dt == torch.bfloat16 else CG_UPDATE).launch(x.device, x.data_ptr(), r.data_ptr(), p.data_ptr(),
                     ap.data_ptr(), alpha.data_ptr(), neg_alpha.data_ptr(),
                     x_new.data_ptr(), r_new.data_ptr(), partials.data_ptr(),
                     nsites, *desc, *(lay[n].descriptor() for n in _CG_OUT), vvl)
    return x_new, r_new, fold_partials(partials, "sum", rsplit=rsplit)


def cg_xpay_plain(x, y, a, layouts=None):
    lay = resolve_layouts(layouts, ("x", "y"), ("out",))
    return lay["out"].pack(lay["y"].unpack(y) + a * lay["x"].unpack(x))


def cg_xpay(x, y, a, vvl: int = 128, *, layouts=None):
    """y + a x for fields x, y (physical, in ``layouts``; names "x", "y",
    "out") and a 0-d device scalar a."""
    if x.device.type == "cpu":
        return cg_xpay_plain(x, y, a, layouts)
    lay = resolve_layouts(layouts, ("x", "y"), ("out",))
    ncomp, nsites = lay["x"].logical_shape(x.shape)
    lx = check_field("x", x, lay["x"], ncomp, nsites, x.device)
    ly = check_field("y", y, lay["y"], ncomp, nsites, x.device)
    check_tensor("a", a, (), x.device)
    out = torch.empty(lay["out"].physical_shape(ncomp, nsites), dtype=x.dtype, device=x.device)
    CG_XPAY.launch(x.device, x.data_ptr(), y.data_ptr(), a.data_ptr(),
                   out.data_ptr(), ncomp, nsites, lx, ly, lay["out"].descriptor(), vvl)
    return out


# -- K3B: the batch instances of the flat chains (the serving path) ----------------
#
# Each wrapper takes every field operand either as ``batch`` fields stacked
# on a leading axis or as one field shared by every slot (told apart by
# rank), the per-slot scalars as (batch,) device vectors, and ``layouts``
# (names as in the single wrappers); its outputs are ``batch`` stacked
# fields.  The mask m selects: where m[b] > 0 the slot takes y + a x, else
# its y input as it is (so -0.0 and NaN pass through).

CG_UPDATE_MASKED = Kernel("cg_update_masked", "rt_cg_update_masked")
CG_XPAY_MASKED = Kernel("cg_xpay_masked", "rt_cg_xpay_masked")


def _masked_fma(y, a, x, m):
    """The plain masked update: y + a x where m > 0, y (its bits) elsewhere."""
    return torch.where(m > 0, y + a * x, y)


def cg_update_masked_plain(x, r, p, ap, alpha, neg_alpha, m, layouts=None):
    """cg_update_masked's arithmetic in torch ops, slot by slot."""
    lay = resolve_layouts(layouts, _CG_IN, _CG_OUT)
    xs, rs, rrs = [], [], []
    for b in range(m.shape[0]):
        xb, rb, pb, apb = (operand_slot(t, lay[n], b) for n, t in zip(_CG_IN, (x, r, p, ap)))
        r_new = _masked_fma(rb, neg_alpha[b], apb.to(rb.dtype), m[b])
        xs.append(lay["x_new"].pack(_masked_fma(xb, alpha[b], pb, m[b])))
        rs.append(lay["r_new"].pack(r_new))
        rrs.append((r_new * r_new).sum(dim=1))
    return torch.stack(xs), torch.stack(rs), torch.stack(rrs)


def cg_update_masked(x, r, p, ap, alpha, neg_alpha, m, vvl: int = 128, *, layouts=None,
                     rsplit: int = 1):
    """K3B: the masked CG update over ``batch = m.shape[0]`` slots of
    24-component fields x, r, p, ap (stacked or shared; ``layouts`` names
    "x", "r", "p", "ap", "x_new", "r_new") with (batch,) device vectors
    alpha, neg_alpha, m -> (x_new, r_new, rr (batch, 24)).  One launch plus
    the per-slot partial fold (``rsplit`` as in :func:`cg_update`).  ap may
    be bf16, as in :func:`cg_update`."""
    if x.device.type == "cpu":
        return cg_update_masked_plain(x, r, p, ap, alpha, neg_alpha, m, layouts)
    lay = resolve_layouts(layouts, _CG_IN, _CG_OUT)
    batch = m.shape[0]
    _, nsites = operand_shape(x, lay["x"])
    ap_dt = _ap_dtype(ap)
    ops = [batch_operand(n, t, lay[n], 24, nsites, batch, x.device, dt)
           for n, t, dt in zip(_CG_IN, (x, r, p, ap), (torch.float32,) * 3 + (ap_dt,))]
    for name, t in (("alpha", alpha), ("neg_alpha", neg_alpha), ("m", m)):
        check_tensor(name, t, (batch,), x.device)
    x_new, r_new = (torch.empty((batch,) + lay[n].physical_shape(24, nsites), dtype=x.dtype,
                                device=x.device) for n in _CG_OUT)
    partials = torch.empty((batch, -(-nsites // vvl), 24), dtype=x.dtype, device=x.device)
    (CG_UPDATE_MASKED_AP16 if ap_dt == torch.bfloat16 else CG_UPDATE_MASKED).launch(
        x.device, x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(), alpha.data_ptr(),
        neg_alpha.data_ptr(), m.data_ptr(), x_new.data_ptr(), r_new.data_ptr(),
        partials.data_ptr(), nsites, batch, *(st for _, st in ops), *(d for d, _ in ops),
        *(lay[n].descriptor() for n in _CG_OUT), vvl)
    return x_new, r_new, fold_partials_batched(partials, "sum", rsplit=rsplit)


def cg_xpay_masked_plain(x, y, a, m, layouts=None):
    lay = resolve_layouts(layouts, ("x", "y"), ("out",))
    return torch.stack([lay["out"].pack(_masked_fma(operand_slot(y, lay["y"], b), a[b],
                                                    operand_slot(x, lay["x"], b), m[b]))
                        for b in range(m.shape[0])])


def cg_xpay_masked(x, y, a, m, vvl: int = 128, *, layouts=None):
    """K3B: where(m > 0, y + a x, y) over ``batch = m.shape[0]`` slots of
    fields x, y (stacked or shared; ``layouts`` names "x", "y", "out") with
    (batch,) device vectors a, m -> ``batch`` stacked fields."""
    if x.device.type == "cpu":
        return cg_xpay_masked_plain(x, y, a, m, layouts)
    lay = resolve_layouts(layouts, ("x", "y"), ("out",))
    batch = m.shape[0]
    ncomp, nsites = operand_shape(x, lay["x"])
    (lx, sx), (ly, sy) = (batch_operand(n, t, lay[n], ncomp, nsites, batch, x.device)
                          for n, t in (("x", x), ("y", y)))
    check_tensor("a", a, (batch,), x.device)
    check_tensor("m", m, (batch,), x.device)
    out = torch.empty((batch,) + lay["out"].physical_shape(ncomp, nsites), dtype=x.dtype,
                      device=x.device)
    CG_XPAY_MASKED.launch(x.device, x.data_ptr(), y.data_ptr(), a.data_ptr(), m.data_ptr(),
                          out.data_ptr(), ncomp, nsites, batch, sx, sy, lx, ly,
                          lay["out"].descriptor(), vvl)
    return out

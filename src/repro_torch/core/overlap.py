"""Comms/compute overlap: the interior/boundary split of a halo'd launch.

The paper composes targetDP with MPI halo exchange (§5, Fig. 5), and the
exchange a step becomes the ceiling of the scaling once a rank's block
thins.  Production lattice codes hide it by running the compute that needs
no exchanged data beside the exchange.  The JAX package makes that
schedule a planned lowering strategy (``LoweringPlan.halo == "overlap"``);
this module is its port:

1. **fill** the halo'd arrays (``core.halo.fill_padded``: the block and the
   wrap of the dims that are not decomposed, by the caller), take the
   canonical arrays the exchange fills (a copy of a Field that is not SoA),
   and mark the end of both (``core.halo.fill_event``): the exchange on the
   side stream waits for that mark alone,
2. run the graph's **interior** sub-launch, over the sites further than the
   ring from every decomposed face, which reads only owned sites,
3. **start** the exchange of the decomposed dims (``core.halo.
   start_exchange``: on the card, on a side CUDA stream that waits only for
   the fill's mark, so it runs beside the interior),
4. **finish** the exchange (the current stream waits for the side stream),
5. run the thin **boundary** sub-launches, two slabs of the ring's width a
   decomposed dim (earlier dims cut to their interior range: a disjoint
   cover), in the reference's order,
6. **combine**: field outputs are the boxes' sites assembled; a reduction
   folds the boxes' partials in box order (``ReduceSpec.combine_partials``).

The JAX package starts the exchange before the interior; on the card the
port issues the interior first, since the host takes longer to issue the
exchange's slab copies than the card takes to run them: issued first, they
finish before the interior is on the card, and nothing overlaps.  The
interior's values do not depend on the order (it reads no halo).

Engines.  On "torch" each sub-launch is a ``halo="pre"`` launch of the
graph on the box's window (a slice of the input's canonical view), planned
by ``core.plan.sub_lattice_plan``, and the outputs are assembled in torch
ops, as the reference assembles them.  On "cuda" no window is copied and
nothing is assembled after the fact: the field outputs are allocated once
at the interior lattice, and the graph's box kernel
(``register_cuda_graph(..., box=)``) runs on the interior, then on the
whole boundary, reading windows in place from the whole halo'd inputs and
writing its boxes' sites of the outputs.  For wilson_normal (K5HO) each
part is one launch a kernel over a table of boxes: t on the interior's box
grown by 1, then ap on the interior; after the exchange, t on the rest of
the ring-1 array (the shell), then ap on every boundary box, the two
T-slabs taken as one box; t lives in one ring-1 array, so no site of it is
computed twice, and an operator issues four kernels.  The LB graphs' K5LHO
(K9H off SoA or under a tile) runs one launch a box, in every layout.  A
box whose sub-plan keeps the outer plan's tiles (``core.plan.
sub_lattice_plan``, as the reference's sub-launches keep them) walks its
sites in that tile order (K9H; K5HO's ap tables).  The box kernels take no
policy and write no partial rows, and wilson_normal's read and write SoA:
a cuda "overlap" launch that asks for a reduction, a policy or a layout
its kernels do not take raises where the "pre" one raises, and a graph
with no box kernel raises; nothing else ever runs in their place.

Plans.  An explicit plan (or a tuned one) is the outer plan of the split;
with none, the default "overlap" plan is the reference's: the untiled
default of the interior lattice (no shared-memory budget is priced, so it
does not tile), whose sub-plans take their slabs from
``sub_lattice_plan``.

Numerics.  Every site of a box is computed by the same arithmetic as in
the whole ``halo="pre"`` launch, so field outputs are bitwise the "pre"
launch's; a reduction's box partials reassociate the sum (tolerance, not
bits).  The sharded drivers therefore take their inner products from the
assembled fields (``apps/milc/driver.py``).

Entry points:

``execute_split``    ``LaunchGraph.launch``'s backend when the resolved plan
                     says ``halo="overlap"``: the split of a launch whose
                     inputs are already exchanged (no exchange to hide; it
                     measures the split's overhead, as under the tuner).
``overlap_launch``   the sharded form: owns the exchange of the inputs
                     (those not listed as ``exchanged``), runs the interior
                     beside it and the boundary after it.
``split_boxes``      the interior/boundary decomposition.

The JAX package's ``overlap/*`` telemetry spans are ``logging`` calls on
this module's logger until ``core.telemetry`` is ported.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from . import halo as halo_mod
from . import plan as plan_mod
from .field import Field
from .layout import SOA
from .plan import LoweringPlan
from .target import TargetConfig

__all__ = ["split_boxes", "execute_split", "overlap_launch"]

log = logging.getLogger(__name__)

# (start, stop) per lattice dim, in interior (output) coordinates
Box = Tuple[Tuple[int, int], ...]


def split_boxes(lattice: Sequence[int], ring: int,
                dims: Sequence[int]) -> Tuple[Optional[Box], List[Box]]:
    """The interior/boundary decomposition of a local lattice.

    lattice  the rank's interior extents
    ring     the boundary's thickness: the largest halo ring of the inputs
    dims     the lattice dims whose halos arrive by exchange

    Returns ``(interior_box, boundary_boxes)``: the interior shrinks by
    ``ring`` along every dim in ``dims``; the boundary is two slabs of
    thickness ``ring`` a dim, the earlier dims cut to their interior range,
    a disjoint cover.  ``(None, [])`` where a dim is too thin to hold an
    interior (``L - 2 ring < 1``): the caller falls back to "pre"."""
    dims = sorted(set(int(d) for d in dims))
    for d in dims:
        if d < 0 or d >= len(lattice):
            raise ValueError(f"split dim {d} out of range for lattice {tuple(lattice)}")
    interior = [(0, L) for L in lattice]
    for d in dims:
        if lattice[d] - 2 * ring < 1:
            return None, []
        interior[d] = (ring, lattice[d] - ring)
    boxes: List[Box] = []
    for i, d in enumerate(dims):
        base = [(0, L) for L in lattice]
        for dj in dims[:i]:
            base[dj] = (ring, lattice[dj] - ring)
        lo, hi = list(base), list(base)
        lo[d] = (0, ring)
        hi[d] = (lattice[d] - ring, lattice[d])
        boxes.append(tuple(lo))
        boxes.append(tuple(hi))
    return tuple(interior), boxes


def _window(f: Field, box: Box, ring: int) -> Field:
    """The halo'd window a sub-launch over ``box`` reads from the halo'd
    input ``f`` (ring ``ring``): halo'd coordinates ``[start, stop + 2
    ring)`` a dim, as a SoA Field (arbitrary boxes do not stay AoSoA-block
    aligned; ``sub_lattice_plan`` pins the sub-launches to the staged
    view)."""
    sl = (slice(None),) + tuple(slice(s, e + 2 * ring) for s, e in box)
    w = f.canonical_nd()[sl]
    return Field.from_canonical(f.name, w, tuple(w.shape[1:]), SOA)


def _geometry(graph, ins: Mapping[str, Field], outputs: Sequence[str]):
    """(external inputs, rings, ring, interior lattice) of a halo'd launch."""
    ext = [n for n in graph.external_inputs() if n in ins]
    rings = graph.halo_widths(outputs)
    ring = max((rings.get(n, 0) for n in ext), default=0)
    r0 = rings.get(ext[0], 0)
    lattice = tuple(s - 2 * r0 for s in ins[ext[0]].lattice)
    return ext, rings, ring, lattice


def _split_launch(graph, ins: Mapping[str, Field], *, dims: Sequence[int], config: TargetConfig,
                  outputs: Sequence[str], scalars: Optional[Mapping], out_layouts: Mapping,
                  plan: LoweringPlan,
                  start: Optional[Callable[[], None]] = None,
                  between: Optional[Callable[[], Mapping[str, Field]]] = None
                  ) -> Optional[Dict[str, Union[Field, torch.Tensor]]]:
    """Run the interior and boundary sub-launches and combine them.

    ``start()`` (the fill's mark) is called just before the interior
    sub-launch, after everything that can be planned and checked; the
    interior reads ``ins`` (only owned sites); ``between()``, called after
    it, runs the exchange and returns the boundary's inputs (the exchanged
    ones; default ``ins``).  Returns None, having called neither, where the
    split is degenerate (the caller falls back to "pre")."""
    ext, rings, ring, lattice = _geometry(graph, ins, outputs)
    if ring < 1:
        return None
    interior, boundary = split_boxes(lattice, ring, dims)
    if interior is None:
        return None
    if plan.engine == "cuda":
        return graph._launch_cuda_boxes(ins, rings={n: rings.get(n, 0) for n in ext},
                                        lattice=lattice, interior=interior, boundary=boundary,
                                        config=config, outputs=outputs, scalars=scalars,
                                        out_layouts=out_layouts, plan=plan, start=start,
                                        between=between)

    red_names = set(graph._reduce_outputs())
    field_outputs = [o for o in outputs if o not in red_names]
    red_specs = graph.reduce_specs()
    out_layouts = dict(out_layouts or {})
    for o in field_outputs:
        out_layouts.setdefault(o, ins[ext[0]].layout)

    def launch_box(box: Box, source: Mapping[str, Field]):
        box_lat = tuple(e - s for s, e in box)
        return graph.launch({n: _window(source[n], box, rings.get(n, 0)) for n in ext},
                            config=config, outputs=outputs, scalars=scalars, halo="pre",
                            plan=plan_mod.sub_lattice_plan(plan, config, box_lat,
                                                                  halo="pre"))

    gname = getattr(graph, "name", "?")
    if start is not None:
        start()
    log.debug("overlap/interior graph=%s box=%s", gname, interior)
    results = [(interior, launch_box(interior, ins))]
    source = between() if between is not None else ins
    for box in boundary:
        log.debug("overlap/boundary graph=%s box=%s", gname, box)
        results.append((box, launch_box(box, source)))

    out: Dict[str, Union[Field, torch.Tensor]] = {}
    for o in field_outputs:
        first = results[0][1][o]
        acc = torch.zeros((first.ncomp,) + lattice, dtype=first.dtype, device=first.device)
        for box, res in results:
            acc[(slice(None),) + tuple(slice(s, e) for s, e in box)] = res[o].canonical_nd()
        out[o] = Field.from_canonical(o, acc, lattice, out_layouts[o])
    for o in outputs:
        if o in red_names:
            # the box partials through the split reductions' stage-2 combine,
            # in box order (the interior first)
            out[o] = red_specs[o].combine_partials(torch.stack([res[o] for _, res in results]))
    return out


def _fall_back(graph, lattice, ring, dims) -> None:
    log.warning("halo='overlap' for graph %r: interior of lattice %s too thin for ring %d along "
                "dims %s - falling back to halo='pre'", getattr(graph, "name", "?"), lattice,
                ring, list(dims))


def execute_split(graph, ins: Mapping[str, Field], *, config: TargetConfig,
                  outputs: Sequence[str], scalars: Optional[Mapping], out_layouts: Mapping,
                  plan: LoweringPlan,
                  dims: Optional[Sequence[int]] = None) -> Dict[str, Union[Field, torch.Tensor]]:
    """The split of a launch whose inputs are already exchanged
    (``LaunchGraph.launch``'s backend for ``plan.halo == "overlap"``):
    every box reads the same halo'd inputs.  ``dims`` defaults to every
    lattice dim (the most boxes).  Falls back to one ``halo="pre"`` launch,
    logged, where the interior is too thin."""
    _, _, ring, lattice = _geometry(graph, ins, outputs)
    if dims is None:
        dims = range(len(lattice))
    out = _split_launch(graph, ins, dims=dims, config=config, outputs=outputs, scalars=scalars,
                        out_layouts=out_layouts, plan=plan)
    if out is not None:
        return out
    _fall_back(graph, lattice, ring, dims)
    return graph.launch(ins, config=config, outputs=outputs, scalars=scalars,
                        out_layouts=out_layouts, halo="pre",
                        plan=dataclasses.replace(plan, halo="pre"))


def _resolve_strategy(graph, ins, *, config, outputs, plan, lattice):
    """The halo strategy of a sharded launch, from the planning layer: an
    explicit plan, or the tuned table's entry (keyed as the "pre" launch
    is), may choose "overlap"; the default policy keeps "pre"."""
    if plan is None:
        policy = getattr(config, "plan_policy", "default")
        if isinstance(policy, LoweringPlan):
            plan = policy
        elif policy == "tuned":
            from . import tune
            plan = tune.lookup(graph.plan_key(ins, config=config, outputs=outputs, halo="pre",
                                              lattice=lattice))
    strategy = "overlap" if (plan is not None and plan.halo == "overlap") else "pre"
    return strategy, plan


def overlap_launch(graph, ins: Mapping[str, Field], *,
                   decomposed: Sequence[Tuple[int, str, int]],
                   config: Optional[TargetConfig] = None,
                   outputs: Optional[Sequence[str]] = None,
                   scalars: Optional[Mapping] = None,
                   out_layouts: Optional[Mapping] = None,
                   halo: Optional[str] = None,
                   exchanged: Sequence[str] = (),
                   plan: Optional[LoweringPlan] = None,
                   mesh=None) -> Dict[str, Union[Field, torch.Tensor]]:
    """A sharded halo'd launch with the exchange beside the interior.

    ins         graph value -> Field on the padded local lattice (every dim
                padded by that input's ring, the dims that are not
                decomposed wrap-filled: ``core.halo.fill_padded``, the
                "pre" contract before the exchange).  This function owns
                the exchange, which fills the inputs' halos in place.
    decomposed  ``Domain.decomposed``: (array dim, mesh axis, axis size) per
                decomposed lattice dim; ``mesh`` the ``launch.mesh.Mesh``
                that holds the axes (None where every axis has one rank).
    halo        "pre" (exchange, then one launch), "overlap" (the split) or
                None: the planning layer's choice (``config.plan_policy``,
                the tuned table; the default policy keeps "pre").
    exchanged   inputs whose halos are already exchanged (a gauge field,
                once a solve), skipped by this call's exchange.

    Under "overlap", once every box is planned and checked and the outputs
    allocated, the fill is marked, the interior sub-launch is issued on the
    current stream, the exchange runs (on the card, on a high-priority side
    stream that waits only for the fill), and the boundary sub-launches run
    after it.  Falls back to
    "pre", logged, where the interior is too thin."""
    config = config or TargetConfig()
    if not graph.has_stencil:
        raise ValueError("overlap_launch applies only to graphs with stencil stages "
                         "(site-local graphs have no halo to exchange)")
    if halo not in (None, "pre", "overlap"):
        raise ValueError(f"halo must be None, 'pre' or 'overlap', got {halo!r}")
    if outputs is None:
        outputs = [v for (_, v, _, _) in graph._stages[-1].outs]
    outputs = tuple(outputs)
    ext, rings, ring, lattice = _geometry(graph, ins, outputs)
    todo = [n for n in ext if n not in exchanged and rings.get(n, 0) >= 1]
    if halo is None:
        strategy, plan = _resolve_strategy(graph, ins, config=config, outputs=outputs,
                                           plan=plan, lattice=lattice)
    else:
        strategy = halo
    dims = [d - 1 for d, _, _ in decomposed]

    if strategy == "overlap":
        if plan is None:
            plan = plan_mod.default_plan(
                config, nsites=math.prod(lattice), layouts=[ins[n].layout for n in ext],
                stencil=True, lattice=lattice, bounded=True, halo="pre")
        if ring >= 1 and split_boxes(lattice, ring, dims)[0] is not None:
            ready, views = [], {}

            def start() -> None:
                # the arrays the exchange fills: the data itself in SoA, a
                # copy in any other layout, made here so that the mark below
                # covers it; the fill and the copies are on the current
                # stream, and the exchange waits for them alone, not for the
                # interior issued next
                views.update({n: ins[n].canonical_nd() for n in todo})
                ready.append(halo_mod.fill_event(ins[ext[0]].data))

            def finish() -> Mapping[str, Field]:
                log.debug("overlap/exchange graph=%s inputs=%s pre_exchanged=%s dims=%s",
                          getattr(graph, "name", "?"), todo,
                          [n for n in ext if n in exchanged], dims)
                pending = {n: halo_mod.start_exchange(views[n], decomposed, width=rings[n],
                                                      mesh=mesh, after=ready[0])
                           for n in todo}
                done = dict(ins)
                for n, p in pending.items():
                    nd = halo_mod.finish_exchange(p)
                    done[n] = ins[n].with_canonical(nd.reshape(ins[n].ncomp, -1))
                return done

            return _split_launch(graph, ins, dims=dims, config=config, outputs=outputs,
                                 scalars=scalars, out_layouts=out_layouts or {}, plan=plan,
                                 start=start, between=finish)
        _fall_back(graph, lattice, ring, dims)

    ex_ins = {n: (halo_mod.exchange_field(ins[n], decomposed, width=rings[n], mesh=mesh)
                  if n in todo else ins[n]) for n in ext}
    sub_plan = dataclasses.replace(plan, halo="pre") if plan is not None else None
    return graph.launch(ex_ins, config=config, outputs=outputs, scalars=scalars,
                        out_layouts=out_layouts, halo="pre", plan=sub_plan)

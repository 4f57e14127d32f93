"""The persisted plan autotuner (paper §3.2.2), per graph, layout and card.

The paper tunes VVL per architecture by hand; this module sweeps the
candidate plans of one LaunchGraph launch (``core.plan.candidate_plans``:
block sizes or x-slabs, the block view, split reductions, tiles and
dtype-policy twins), times each on the device, and persists the winner, so
that later processes running with ``TargetConfig(plan_policy="tuned")``
load the table instead of sweeping again.  One entry per plan key
(``LaunchGraph.plan_key``: the graph's signature, its inputs' widths,
dtypes, layouts and lattices, the engine, the outputs, the backend) holds
the winning :class:`~repro_torch.core.plan.LoweringPlan` and the sweep's
timings for audit.

The table lives in ``.targetdp_tune_torch.json`` in the working directory,
or at ``$TARGETDP_TORCH_TUNE_PATH``: its own file and variable, so the port
and the JAX package never read each other's plans.  The backend in a key is
the CUDA device's name (``torch.cuda.get_device_name``), or "cpu".  The
in-memory table is cached per path; :func:`clear_table_cache` drops it
(what a fresh process sees).

The file is stamped with ``schema_version`` 4 (the JAX package's: plans
with the split factor and the dtype policy).  A missing, corrupt or
unknown-version table loads as empty, and a malformed entry is a miss:
every such lookup misses and the tuner sweeps again, rather than decoding a
stale plan.

Dtype-policy candidates face a hard accuracy gate before they are timed:
each is launched once beside the default plan under ``accumulate=
"float64"`` and rejected (logged, never timed, never persisted) unless the
pooled relative L2 distance of its outputs stays under the gate.

The JAX package records the sweep as telemetry spans and events
(``tune/*``); until ``core.telemetry`` is ported they are ``logging`` calls
on this module's logger, and :func:`stats` keeps the counters.

Usage::

    from repro_torch.core import tune
    plan, info = tune.autotune_graph(graph, ins, config=cfg, outputs=("dist2", "u"))
    # later processes: TargetConfig(..., plan_policy="tuned") makes every
    # LaunchGraph.launch look its plan up in the persisted table.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from . import plan as plan_mod
from .field import BatchedField, Field, backend_name
from .plan import LoweringPlan

__all__ = ["DEFAULT_PATH", "ENV_VAR", "SCHEMA_VERSION", "tune_path", "load_table", "save_table",
           "clear_table_cache", "lookup", "record", "block_view_for", "plan_candidates_for",
           "autotune_graph", "stats", "reset_stats"]

DEFAULT_PATH = ".targetdp_tune_torch.json"
ENV_VAR = "TARGETDP_TORCH_TUNE_PATH"
# the JAX package's schema: 2 added the overlap halo strategy, 3 the split
# factor rsplit, 4 the dtype policy (and the accuracy gate); an older table
# is a clean miss
SCHEMA_VERSION = 4

log = logging.getLogger(__name__)

_TABLE: Optional[Dict[str, dict]] = None
_TABLE_PATH: Optional[str] = None

# sweep_launches counts the sweep's launches, warmup included (the "no
# sweep on a warm table" probe); lookups and hits count the tuned policy's
# table lookups; tunes the sweeps run
_STAT_KEYS = ("sweep_launches", "lookups", "hits", "tunes")
_STATS: Dict[str, int] = dict.fromkeys(_STAT_KEYS, 0)


def stats() -> Dict[str, int]:
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(dict.fromkeys(_STAT_KEYS, 0))


# -- the persisted table ---------------------------------------------------------

def tune_path() -> str:
    """Where the table lives: $TARGETDP_TORCH_TUNE_PATH or
    ./.targetdp_tune_torch.json."""
    return os.environ.get(ENV_VAR) or DEFAULT_PATH


def load_table(path: Optional[str] = None) -> Dict[str, dict]:
    """The in-memory table for ``path``, read from disk once and cached.  A
    missing or corrupt file, or one stamped with a missing or unknown
    ``schema_version``, is an empty table."""
    global _TABLE, _TABLE_PATH
    path = path or tune_path()
    if _TABLE is None or _TABLE_PATH != path:
        try:
            with open(path) as f:
                raw = json.load(f)
            entries = raw.get("entries", {})
            if raw.get("schema_version") != SCHEMA_VERSION:
                entries = {}
            _TABLE = dict(entries) if isinstance(entries, dict) else {}
        except (FileNotFoundError, json.JSONDecodeError, OSError, AttributeError):
            _TABLE = {}
        _TABLE_PATH = path
    return _TABLE


def clear_table_cache() -> None:
    """Drop the in-memory table, so the next access reads the disk (what a
    fresh process sees)."""
    global _TABLE, _TABLE_PATH
    _TABLE, _TABLE_PATH = None, None


def save_table(path: Optional[str] = None) -> str:
    """Write the in-memory table to disk (atomic replace); returns the path."""
    path = path or tune_path()
    table = load_table(path)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"schema_version": SCHEMA_VERSION, "entries": table}, f, indent=2,
                  sort_keys=True)
    os.replace(tmp, path)
    return path


def lookup(key: str, path: Optional[str] = None) -> Optional[LoweringPlan]:
    """The persisted winner for ``key``, or None (the tuned policy then
    plans by default).  A structurally malformed entry is a miss: tuning
    never breaks a launch."""
    _STATS["lookups"] += 1
    entry = load_table(path).get(key)
    if entry is None:
        return None
    try:
        plan = LoweringPlan.from_json(dict(entry["plan"]))
        # structural sanity only; the launch validates against its lattice
        plan.validate(stencil=plan.bx > 0 or plan.tiled or plan.halo == "overlap")
    except (KeyError, TypeError, ValueError):
        return None
    _STATS["hits"] += 1
    return plan


def record(key: str, plan: LoweringPlan, *, timings_us: Optional[Mapping[str, float]] = None,
           default: Optional[LoweringPlan] = None, meta: Optional[Mapping] = None,
           save: bool = True, path: Optional[str] = None) -> None:
    """Store ``plan`` as the winner for ``key`` (and persist by default)."""
    entry = {"plan": plan.to_json()}
    if timings_us:
        entry["timings_us"] = {k: round(float(v), 3) for k, v in timings_us.items()}
    if default is not None:
        entry["default_plan"] = default.to_json()
    entry["meta"] = dict(meta or {})
    entry["meta"].setdefault("created", time.time())
    load_table(path)[key] = entry
    if save:
        save_table(path)


# -- the sweep ---------------------------------------------------------------------

def _tensors(out) -> list:
    """The tensors of a launch's outputs (Fields' data, reductions), in
    output order."""
    return [v.data if isinstance(v, (Field, BatchedField)) else v for v in out.values()]


def _sync(out) -> None:
    """Wait for the devices the outputs lie on."""
    for dev in {t.device for t in _tensors(out)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _sweep(graph, ins, launch_kw, cands, iters: int, warmup: int):
    """Time every candidate: ``warmup`` launches each (the first builds the
    kernels), then ``iters`` round-robin rounds (the candidates
    interleaved, so drift biases them alike), keeping each candidate's
    minimum.  Every launch is synchronised on its device before the clock
    is read, and counts in ``sweep_launches``.  A candidate that raises is
    recorded as failed and skipped; the sweep goes on.

    Returns (times, failed): candidate -> best seconds, candidate -> error
    repr."""
    gname = getattr(graph, "name", "?")

    def run(plan):
        _sync(graph.launch(ins, plan=plan, **launch_kw))
        _STATS["sweep_launches"] += 1

    def fail(cand, e):
        failed[cand] = repr(e)
        log.warning("tune sweep: candidate %s failed for graph %r: %r", cand.describe(),
                    gname, e)

    times: Dict[LoweringPlan, float] = {}
    failed: Dict[LoweringPlan, str] = {}
    log.info("tune sweep of graph %r: %d candidates", gname, len(cands))
    for cand in cands:
        try:
            for _ in range(warmup):
                run(cand)
        except Exception as e:  # noqa: BLE001 - any lowering failure
            fail(cand, e)
    for _ in range(max(1, iters)):
        for cand in cands:
            if cand in failed:
                continue
            try:
                t0 = time.perf_counter()
                run(cand)
                dt = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001
                fail(cand, e)
                times.pop(cand, None)
                continue
            times[cand] = min(times.get(cand, dt), dt)
    log.info("tune sweep of graph %r: %d timed, %d failed; best %s", gname, len(times),
             len(failed), {c.describe(): round(t * 1e6, 3) for c, t in times.items()})
    return times, failed


def _interior_lattice(graph, ins, outputs=None, halo: str = "periodic") -> Tuple[int, ...]:
    """The lattice a launch's plans are made for: the first input's, less
    its ring twice where the caller exchanged the halos (``halo="pre"`` or
    ``"overlap"``), as ``LaunchGraph.launch`` derives it, so that the
    tuner's keys and the tuned launches' lookups agree."""
    name = next(iter(ins))
    lattice = tuple(ins[name].lattice)
    if graph.has_stencil and halo in ("pre", "overlap"):
        ring = graph.halo_widths(tuple(outputs) if outputs is not None else None).get(name, 0)
        lattice = tuple(s - 2 * ring for s in lattice)
    return lattice


def block_view_for(graph, ins, outputs=None, halo: str = "periodic") -> bool:
    """Whether this launch can lower on the native AoSoA view
    (``core.plan.block_view_ok``): each input's halo'd inner-plane count
    from the graph's ring analysis (the input's own lattice where the
    caller exchanged the halos), the outputs in the first input's layout,
    so the sweep proposes ``view="block"`` only where it lowers."""
    if not graph.has_stencil:
        return False
    outs = tuple(outputs) if outputs is not None else None
    rings = graph.halo_widths(outs)
    pre = halo in ("pre", "overlap")
    in_views = [(f.layout, math.prod(s + (0 if pre else 2 * rings.get(n, 0))
                                     for s in f.lattice[1:]))
                for n, f in ins.items()]
    interior = _interior_lattice(graph, ins, outs, halo)
    first = next(iter(ins.values()))
    return plan_mod.block_view_ok(in_views, [first.layout], math.prod(interior[1:]))


def plan_candidates_for(graph, ins, *, config, outputs: Optional[Sequence[str]] = None,
                        halo: str = "periodic", max_candidates: int = 8
                        ) -> Tuple[LoweringPlan, ...]:
    """The candidate plans of launching ``graph`` with ``ins`` under
    ``halo``, the default plan first: the sweep set of
    :func:`autotune_graph`.  A stencil launch passes its footprint
    descriptor (the same one the launch gives the default planner, so the
    sweep prunes what a launch would tile), the precise block-view verdict
    and whether the graph ends in a reduction; every launch passes its
    first input's dtype for the dtype twins and its batch size (a batch
    gets no overlap twins)."""
    lattice = _interior_lattice(graph, ins, outputs, halo)
    first = next(iter(ins.values()))
    smem_views = None
    if graph.has_stencil:
        outs = tuple(outputs) if outputs is not None else None
        rings = graph.halo_widths(outs)
        prod = graph._produced()
        red = set(graph._reduce_outputs())
        names = outs if outs is not None else tuple(prod)
        out_views = tuple((int(prod[o][0]), (prod[o][1] or first.dtype).itemsize)
                          for o in names if o not in red and o in prod)
        smem_views = (tuple((f.ncomp, rings.get(n, 0), f.data.element_size())
                            for n, f in ins.items()), out_views)
    batch = max((f.batch if isinstance(f, BatchedField) else 0 for f in ins.values()), default=0)
    return plan_mod.candidate_plans(
        config, nsites=math.prod(lattice), layouts=[f.layout for f in ins.values()],
        stencil=graph.has_stencil, lattice=lattice, halo=halo, max_candidates=max_candidates,
        block_view=block_view_for(graph, ins, outputs, halo), batch=batch,
        reduce=bool(graph._reduce_outputs()), smem_views=smem_views,
        in_dtype=str(first.dtype).replace("torch.", ""))


# -- the accuracy gate ---------------------------------------------------------------

def _accuracy_gate_for(policy) -> float:
    """The default gate (most rel-L2 from the float64-accumulate baseline)
    of a dtype-policy candidate, by what its storage throws away: bf16 or
    f16 storage 1e-2, fp32 storage 1e-5, else (accumulate-only: a strict
    improvement) 1e-6."""
    if policy.storage in ("bfloat16", "float16"):
        return 1e-2
    if policy.storage == "float32":
        return 1e-5
    return 1e-6


def _rel_l2(out, ref) -> float:
    """Relative L2 distance between two launches' outputs, pooled over every
    floating-point tensor (fields and sums alike), in fp64."""
    num = den = 0.0
    for a, b in zip(_tensors(out), _tensors(ref)):
        if not b.is_floating_point():
            continue
        a64, b64 = a.detach().double(), b.detach().double()
        num += float(torch.sum((a64 - b64) ** 2))
        den += float(torch.sum(b64 ** 2))
    return math.sqrt(num / den) if den > 0.0 else 0.0


def _gate_policy_candidates(graph, ins, launch_kw, cands, default, accuracy_gate):
    """Probe every dtype-policy candidate once against the baseline (the
    default plan under ``accumulate="float64"``) and reject, logged, each
    whose pooled rel-L2 exceeds its gate or whose probe raises.  Where the
    baseline itself raises (a graph whose cuda kernels have no policy
    instance) every policy candidate is rejected with that reason; the JAX
    package, whose every graph takes a policy, lets it propagate.  Returns
    (surviving candidates, rejected {plan: reason})."""
    pol_cands = [c for c in cands if c.dtypes]
    if not pol_cands:
        return cands, {}
    gname = getattr(graph, "name", "?")
    base = dataclasses.replace(default, dtypes=plan_mod.DtypePolicy(accumulate="float64"))
    log.info("tune accuracy gate of graph %r: baseline %s", gname, base.describe())
    rejected: Dict[LoweringPlan, str] = {}
    try:
        ref = graph.launch(ins, plan=base, **launch_kw)
        _sync(ref)
    except Exception as e:  # noqa: BLE001 - any lowering failure
        log.warning("tune accuracy gate: baseline %s failed on graph %r: %r; rejecting every "
                    "dtype-policy candidate", base.describe(), gname, e)
        rejected = {c: f"accuracy baseline raised: {e!r}" for c in pol_cands}
        return [c for c in cands if c not in rejected], rejected
    for cand in pol_cands:
        gate = accuracy_gate if accuracy_gate is not None else _accuracy_gate_for(cand.dtypes)
        try:
            err = _rel_l2(graph.launch(ins, plan=cand, **launch_kw), ref)
        except Exception as e:  # noqa: BLE001 - any lowering failure
            rejected[cand] = f"accuracy probe raised: {e!r}"
            log.warning("tune accuracy gate: probe for %s failed on graph %r: %r",
                        cand.describe(), gname, e)
            continue
        if err > gate:
            rejected[cand] = f"rel_l2 {err:.3e} > gate {gate:.1e}"
            log.warning("tune accuracy gate: rejecting %s on graph %r: rel_l2 %.3e exceeds "
                        "gate %.1e", cand.describe(), gname, err, gate)
    return [c for c in cands if c not in rejected], rejected


def autotune_graph(graph, ins, *, config, outputs: Optional[Sequence[str]] = None,
                   scalars: Optional[Mapping] = None, out_layouts: Optional[Mapping] = None,
                   halo: str = "periodic",
                   iters: int = 3, warmup: int = 1, max_candidates: int = 8,
                   min_gain: float = 0.05, force: bool = False, save: bool = True,
                   path: Optional[str] = None, accuracy_gate: Optional[float] = None,
                   cost_model: Optional[Callable[[LoweringPlan], float]] = None
                   ) -> Tuple[LoweringPlan, dict]:
    """Sweep the candidate plans of one launch of ``graph`` with ``ins`` and
    persist the winner.  Returns ``(plan, info)``: info holds the key,
    whether the table already had it (``cached``), and after a sweep the
    timings (µs), the failed and the rejected candidates, the default plan
    and the winner's µs.

    A warm table returns at once (``cached``, no launch) unless ``force``.
    ``min_gain`` is hysteresis toward the default plan: a candidate
    replaces it only by beating it by more than that fraction, so timing
    noise cannot persist a plan that is merely noisily fast.  A candidate
    that raises is recorded in ``info["failed"]`` and the entry's meta.
    Dtype-policy candidates pass the accuracy gate first
    (``accuracy_gate`` overrides the per-policy default: bf16/f16 storage
    1e-2, fp32 storage 1e-5, else 1e-6).  ``cost_model`` maps a candidate
    to a multiplier of its measured time (a solver's iterations to
    tolerance, so that candidates rank by time to solution).  ``halo`` is
    the launch's strategy ("pre": the sharded path's halo'd inputs, whose
    sweep on more than one rank includes the "overlap" twins)."""
    lattice = _interior_lattice(graph, ins, outputs, halo)
    key = graph.plan_key(ins, config=config, outputs=outputs, halo=halo, lattice=lattice)
    if not force:
        hit = lookup(key, path)
        if hit is not None:
            return hit, {"key": key, "cached": True}

    cands = plan_candidates_for(graph, ins, config=config, outputs=outputs, halo=halo,
                                max_candidates=max_candidates)
    default = cands[0]
    launch_kw = dict(config=config, outputs=outputs, scalars=scalars, out_layouts=out_layouts,
                     halo=halo)
    _STATS["tunes"] += 1
    cands, rejected = _gate_policy_candidates(graph, ins, launch_kw, cands, default,
                                              accuracy_gate)
    times, failed = _sweep(graph, ins, launch_kw, cands, iters, warmup)
    if not times:
        raise RuntimeError(
            f"every candidate plan failed for {getattr(graph, 'name', '?')}: "
            f"{ {c.describe(): e for c, e in failed.items()} }")

    def cost(c):
        return times[c] * float(cost_model(c)) if cost_model else times[c]

    best = min(times, key=lambda c: (cost(c), c.describe()))
    # hysteresis: keep the default unless the winner is measurably better
    if default in times and cost(best) > cost(default) * (1.0 - min_gain):
        best = default

    timings_us = {c.describe(): t * 1e6 for c, t in times.items()}
    failed_desc = {c.describe(): e for c, e in failed.items()}
    rejected_desc = {c.describe(): e for c, e in rejected.items()}
    first = next(iter(ins.values()))
    record(key, best, timings_us=timings_us, default=default,
           meta={"graph": getattr(graph, "name", "?"), "backend": backend_name(first.device),
                 "lattice": list(lattice), "smem_bytes": plan_mod.resolved_smem_bytes(config),
                 "failed": failed_desc, "rejected": rejected_desc},
           save=save, path=path)
    return best, {"key": key, "cached": False, "timings_us": timings_us, "failed": failed_desc,
                  "rejected": rejected_desc, "default": default, "best_us": times[best] * 1e6}

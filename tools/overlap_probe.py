"""Time the sharded MILC operator's halo schedules on one card, and count
the caching allocator's device allocations and syncs a call: where the
"overlap" schedule's time goes beside "pre".

  python3 tools/overlap_probe.py [--src DIR] [--lattice 64 64 64 32] [--reps 20]
  python3 tools/overlap_probe.py [--src DIR] --ludwig 256 256 256 [--reps 20]
  python3 tools/overlap_probe.py [--src DIR] --solve [--lattice 64 64 64 32]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (default:
this checkout's), so that two trees can be timed in one process each, in
turns.  On a one-rank mesh of four axes, every lattice dim decomposed over
one rank (each exchange the self-exchange), on random p (24, *lattice) and
u (72, *lattice) (the kernels' time does not depend on the values; u is
exchanged once, at width 2):

  exchange   p's halo'd array at width 2 (``exchange_padded``) alone
  pre        that, then the "pre" launch of the normal operator (K5H)
  split      the "overlap" split on the exchanged p: its box kernels alone
  overlap    ``fill_padded``, then ``overlap_launch(halo="overlap")``:
             the exchange beside the interior box

Each variant is warmed up 3 times, then run ``--reps`` times with the card
synchronised after the last (host wall time a call, as a solve sees it),
the variants in order, then in reverse.  Beside each: the allocator's
``num_device_alloc`` and ``num_sync_all_streams`` a call (its
``memory_stats``, where this PyTorch has them).  Then a torch.profiler
trace of one "overlap" call: each device event's stream, start and
duration relative to the call's first, and the ms during which the
interior box's kernels and the other stream's copies both ran.  Prints the
card's name and power limit, a line a variant, then one JSON line.

With ``--ludwig X Y Z`` it times the sharded Ludwig step instead (the
steps chip_smoke.py's D3 times): from ``init_state(seed=0)`` on a one-rank
mesh of three axes, ``make_sharded_step`` under "pre" and "overlap", one
step to warm up, then ``--reps`` steps with the card synchronised after
the last (host wall time a step), "pre" then "overlap", then in reverse;
the two schedules' last states compared bitwise.  Before the steps, the
kernels those steps run, timed alone on random halo'd dist (19) and force
(3) at the same lattice, SoA, vvl 128 (CUDA events, median of --reps,
after 3 warm-up calls): K5LH (``lb_step_pre_cuda``, the whole interior,
with u) and K5LHO (``lb_step_box_cuda`` on each box of the "overlap"
split, every dim decomposed, the boxes one after another: the sum a step),
the two outputs compared bitwise.

With ``--solve`` it times the sharded MILC solve instead (the solves
chip_smoke.py's D2 times): ``init_problem(seed=0)`` at ``--lattice`` on
the one-rank mesh, ``make_sharded_solver`` under "pre" and "overlap",
each solved once after ``torch.cuda.empty_cache()`` (cold, as D2 runs it)
and once more (warm), ms an iteration by the host clock with the card
synchronised, with the allocator's counts a solve; "pre" then "overlap",
then in reverse; x compared bitwise.  Needs a CUDA device; exits with 1
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

KAPPA = 0.12
AXES = ("x", "y", "z", "t")
BOX_KERNELS = 4    # K5HO's kernels an operator: the interior's t and ap, the boundary's


def stats():
    import torch
    s = torch.cuda.memory_stats()
    return {k: s.get(k) for k in ("num_device_alloc", "num_sync_all_streams", "num_alloc_retries")}


def ludwig_kernels(lat, reps) -> dict:
    """K5LH's and K5LHO's ms at the Ludwig lattice (see the module's
    docstring)."""
    import math
    import statistics
    import torch
    from repro_torch.core.overlap import split_boxes
    from repro_torch.kernels.lb_propagation import kernel as k8

    tau = 0.8
    V, Vh = math.prod(lat), math.prod(s + 2 for s in lat)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dh = 1.0 + 0.1 * torch.randn((19, Vh), generator=gen, device="cuda")
    fh = 0.01 * torch.randn((3, Vh), generator=gen, device="cuda")
    interior, boundary = split_boxes(lat, 1, range(3))
    boxes = [(tuple(a for a, _ in bx), tuple(c - a for a, c in bx))
             for bx in [interior] + boundary]
    d2 = torch.empty((19, V), device="cuda")
    u = torch.empty((3, V), device="cuda")

    def k5lh():
        return k8.lb_step_pre_cuda(dh, fh, tau, lat, 128)

    def k5lho():
        for o, e in boxes:
            k8.lb_step_box_cuda(dh, fh, tau, lat, o, e, d2, u, 128)
        return d2, u

    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    out = {"K5LH": median_ms(k5lh), "K5LHO": median_ms(k5lho), "boxes": len(boxes)}
    want = k5lh()
    out["bitwise"] = bool(torch.equal(k5lho()[0], want[0]) and torch.equal(u, want[1]))
    print(f"kernels K5LH {out['K5LH']:.4f} ms, K5LHO on {len(boxes)} boxes {out['K5LHO']:.4f} ms, "
          f"bitwise {out['bitwise']}")
    return out


def ludwig_steps(lat, reps, card) -> dict:
    """The sharded Ludwig step's ms under "pre" and "overlap" (see the
    module's docstring)."""
    import torch
    from repro_torch.apps.ludwig import LudwigConfig, init_state
    from repro_torch.apps.ludwig import driver as ludwig
    from repro_torch.core.target import TargetConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.lattice import Domain

    axes = AXES[:3]
    cfg = LudwigConfig(lattice=lat, target=TargetConfig("cuda", device="cuda"))
    state = init_state(cfg, seed=0)
    dom = Domain(lat, Mesh((1,) * 3, axes, rank=0, world_size=1, local_rank=0, device="cuda"),
                 axes, halo=2)
    d0, q0 = dom.scatter(state.dist.canonical_nd()), dom.scatter(state.q.canonical_nd())
    steps = {h: ludwig.make_sharded_step(cfg, dom, h) for h in ("pre", "overlap")}
    res, last = {h: [] for h in steps}, {}
    for order in (list(steps), list(steps)[::-1]):
        for h in order:
            steps[h](d0, q0)
            torch.cuda.synchronize()
            d, q = d0, q0
            t0 = time.perf_counter()
            for _ in range(reps):
                d, q = steps[h](d, q)
            torch.cuda.synchronize()
            res[h].append((time.perf_counter() - t0) / reps * 1e3)
            last[h] = (d, q)
            print(f"ludwig {h:8s} {res[h][-1]:.4f} ms a step")
    bitwise = all(torch.equal(a, b) for a, b in zip(last["pre"], last["overlap"]))
    print(f"ludwig overlap bitwise pre: {bitwise}")
    return {"card": card, "lattice": list(lat), "reps": reps, "bitwise_pre": bitwise,
            "ms_a_step": res}


def sharded_solves(lat, card) -> dict:
    """The sharded MILC solve's ms an iteration under "pre" and "overlap",
    cold and warm (see the module's docstring)."""
    import torch
    from repro_torch.apps.milc import MilcConfig, init_problem
    from repro_torch.apps.milc.driver import make_domain, make_sharded_solver
    from repro_torch.core.target import TargetConfig
    from repro_torch.launch.mesh import Mesh

    cfg = MilcConfig(lattice=lat, kappa=KAPPA, tol=1e-10, hot=0.6, max_iter=2000,
                     target=TargetConfig("cuda", device="cuda"))
    u, b = init_problem(cfg, seed=0)
    dom = make_domain(cfg, Mesh((1,) * 4, AXES, rank=0, world_size=1, local_rank=0,
                                device="cuda"), AXES)
    ul, bl = dom.scatter(u.canonical_nd()), dom.scatter(b.canonical_nd())
    res, xs = {h: {"cold": [], "warm": []} for h in ("pre", "overlap")}, {}
    allocs = {}
    for order in (list(res), list(res)[::-1]):
        for h in order:
            solver = make_sharded_solver(cfg, dom, h)
            torch.cuda.empty_cache()
            for run in ("cold", "warm"):
                torch.cuda.synchronize()
                s0 = stats()
                t0 = time.perf_counter()
                x, it, _ = solver(ul, bl)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / it * 1e3
                s1 = stats()
                res[h][run].append(ms)
                allocs[f"{h} {run}"] = {k: None if s0[k] is None else s1[k] - s0[k] for k in s0}
                print(f"solve {h:8s} {run}: {ms:.4f} ms an iteration, {it} iterations; "
                      f"a solve: {allocs[f'{h} {run}']}")
            xs[h] = x
            del solver
    bitwise = bool(torch.equal(xs["pre"], xs["overlap"]))
    print(f"solve overlap bitwise pre: {bitwise}")
    return {"card": card, "lattice": list(lat), "bitwise_pre": bitwise, "ms_an_iteration": res,
            "allocator": allocs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--lattice", type=int, nargs=4, default=(64, 64, 64, 32))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ludwig", type=int, nargs=3, default=None,
                    help="time the sharded Ludwig step at this lattice instead")
    ap.add_argument("--solve", action="store_true",
                    help="time the sharded MILC solve at --lattice instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("overlap_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.apps.milc.cg import wilson_normal_graph
    from repro_torch.core import halo
    from repro_torch.core.field import Field
    from repro_torch.core.overlap import overlap_launch
    from repro_torch.core.target import TargetConfig
    from repro_torch.launch.mesh import Mesh

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card)
    if args.ludwig:
        out = {"kernels": ludwig_kernels(tuple(args.ludwig), args.reps),
               **ludwig_steps(tuple(args.ludwig), args.reps, card)}
        print(json.dumps({"overlap_probe": {"src": args.src, "ludwig": out}}))
        return 0
    if args.solve:
        out = sharded_solves(tuple(args.lattice), card)
        print(json.dumps({"overlap_probe": {"src": args.src, "solve": out}}))
        return 0
    lat = tuple(args.lattice)
    tgt = TargetConfig("cuda", device="cuda")
    mesh = Mesh((1,) * 4, AXES, rank=0, world_size=1, local_rank=0, device="cuda")
    dec = tuple((d + 1, ax, 1) for d, ax in enumerate(AXES))
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn((24,) + lat, generator=gen, device="cuda")
    u = torch.randn((72,) + lat, generator=gen, device="cuda") * 0.3
    uh = halo.exchange_padded(u, dec, width=2, mesh=mesh)
    hl = tuple(uh.shape[1:])
    uF = Field.from_canonical("u", uh, hl)
    g = wilson_normal_graph(KAPPA)
    ph_ex = halo.exchange_padded(p, dec, width=2, mesh=mesh)

    def v_exchange():
        return halo.exchange_padded(p, dec, width=2, mesh=mesh)

    def v_pre():
        ph = halo.exchange_padded(p, dec, width=2, mesh=mesh)
        return g.launch({"p": Field.from_canonical("p", ph, hl), "u": uF}, config=tgt,
                        outputs=("ap",), halo="pre")["ap"]

    def v_split():
        return g.launch({"p": Field.from_canonical("p", ph_ex, hl), "u": uF}, config=tgt,
                        outputs=("ap",), halo="overlap")["ap"]

    def v_overlap():
        ph = halo.fill_padded(p, dec, width=2)
        return overlap_launch(g, {"p": Field.from_canonical("p", ph, hl), "u": uF},
                              decomposed=dec, config=tgt, outputs=("ap",), halo="overlap",
                              exchanged=("u",), mesh=mesh)["ap"]

    variants = {"exchange": v_exchange, "pre": v_pre, "split": v_split, "overlap": v_overlap}
    want = v_pre().data.clone()
    got = v_overlap().data
    bitwise = bool(torch.equal(got, want))
    print(f"overlap bitwise pre: {bitwise}")
    res = {n: [] for n in variants}
    per_call = {}
    for order in (list(variants), list(reversed(list(variants)))):
        for n in order:
            f = variants[n]
            for _ in range(3):
                f()
            torch.cuda.synchronize()
            s0 = stats()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                f()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / args.reps * 1e3
            s1 = stats()
            res[n].append(ms)
            per_call[n] = {k: (None if s0[k] is None else (s1[k] - s0[k]) / args.reps)
                           for k in s0}
            print(f"{n:9s} {ms:.4f} ms a call; a call: {per_call[n]}")

    from torch.profiler import ProfilerActivity, profile
    v_overlap()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        v_overlap()
        torch.cuda.synchronize()
        v_overlap()
        torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="overlap_probe_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset") and "stream" in e.get("args", {})),
                 key=lambda e: e["ts"])
    boxk = [i for i, e in enumerate(dev) if "wilson_normal_box" in e["name"]]
    trace = {"device_events": len(dev)}
    if len(boxk) >= BOX_KERNELS:
        # the last call: from the first of its box kernels (the interior's t
        # and ap, then the boundary's)
        first = boxk[-BOX_KERNELS]
        prev_end = max((e["ts"] + e["dur"] for e in dev[:first]), default=dev[first]["ts"])
        start = dev[first]["ts"]
        call = [e for e in dev if e["ts"] + e["dur"] > prev_end]
        main_stream = dev[first]["args"]["stream"]
        interior = [dev[boxk[-BOX_KERNELS]], dev[boxk[-BOX_KERNELS + 1]]]
        side = [e for e in call if e["args"]["stream"] != main_stream]
        ti = (interior[0]["ts"], interior[1]["ts"] + interior[1]["dur"])
        trace.update(events=[[e["args"]["stream"], round(e["ts"] - start, 3), round(e["dur"], 3),
                              e["name"][:40]] for e in call])
        if side:
            ts = (min(e["ts"] for e in side), max(e["ts"] + e["dur"] for e in side))
            trace.update(interior_ms=(ti[1] - ti[0]) / 1e3,
                         side_ms=(ts[1] - ts[0]) / 1e3,
                         side_busy_ms=sum(e["dur"] for e in side) / 1e3,
                         both_ms=max(0.0, min(ti[1], ts[1]) - max(ti[0], ts[0])) / 1e3)
        for e in trace["events"]:
            print("  trace", e)
        print(f"trace: {({k: v for k, v in trace.items() if k != 'events'})}")
    print(json.dumps({"overlap_probe": {"card": card, "src": args.src, "lattice": list(lat),
                                        "reps": args.reps, "bitwise_pre": bitwise,
                                        "ms": res, "per_call": per_call,
                                        "trace": {k: v for k, v in trace.items()
                                                  if k != "events"}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

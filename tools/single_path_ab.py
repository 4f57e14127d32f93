"""Time the MILC single solve's path on the card: its kernels and one CG
iteration, through the port found under ``--src``, so that two versions of
the port (two checkouts' ``src``) can be compared in one call; with
``--ludwig``, also the Ludwig step.

  python3 tools/single_path_ab.py [--src DIR] [--fold sum] [--lattice 64 64 64 32]
                                  [--ludwig 256 256 256]

The gauge field and source are random normal numbers drawn on the card (a
timing needs no SU(3) field, and drawing one on the host takes minutes at
full size), and the solve runs with tol 0 so that every solve takes exactly
``--iterations`` iterations.  ``--fold sum`` replaces the solver's
fixed-order component fold (``core.reduce.fold_components``, where the port
has it) by ``sum`` over the last axis, to time what the fold costs.

Kernels: CUDA events, median of 10.  The CG iteration: the median over
``--reps`` solves (after one warm-up solve) of a solve's wall time, set-up
included, over its iterations.  The Ludwig step (``--ludwig``): from
``init_state`` (seed 0) in SoA and repacked in AoS, one warm-up step, then
``--reps`` runs of 10 synchronised steps, ms a step each.  Prints the
card's name and power limit, then one JSON line.  Needs a CUDA device;
exits with 1 without one.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, reps: int = 1000) -> float:
    """Mean host time of fn() in microseconds, the device drained after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def ludwig_steps(lattice, reps, steps=10):
    """{layout: [ms a step, one value a run of ``steps`` steps]} for the
    Ludwig step from init_state in SoA and AoS."""
    from repro_torch.apps.ludwig import LudwigConfig, LudwigState, init_state, step
    from repro_torch.core import TargetConfig, parse_layout

    cfg = LudwigConfig(lattice=lattice, target=TargetConfig("cuda", device="cuda"))
    state = init_state(cfg, seed=0)
    out = {}
    for spec in ("soa", "aos"):
        lay = parse_layout(spec)
        lcfg = LudwigConfig(lattice=lattice, layout=lay, target=cfg.target)
        s = LudwigState(dist=state.dist.as_layout(lay), q=state.q.as_layout(lay))
        s = step(s, lcfg)
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                s = step(s, lcfg)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / steps * 1e3)
        out[spec] = runs
        del s
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the src directory that holds the repro_torch package to time")
    ap.add_argument("--fold", choices=["port", "sum"], default="port")
    ap.add_argument("--lattice", type=int, nargs=4, default=[64, 64, 64, 32])
    ap.add_argument("--iterations", type=int, default=26)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--label", default="")
    ap.add_argument("--ludwig", type=int, nargs=3, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import _cuda
    from repro_torch.apps.milc import MilcConfig, solve
    from repro_torch.apps.milc import cg as CG
    from repro_torch.core import SOA, Field, TargetConfig, fuse, reduce, target
    from repro_torch.kernels.wilson_dslash import kernel as wk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _cuda.library()
    has_fold = hasattr(CG, "fold_components")
    if args.fold == "sum":
        if not has_fold:
            raise SystemExit("--fold sum: this port has no fold_components")
        CG.fold_components = lambda v: v.sum(dim=-1)

    lattice, vvl, kappa = tuple(args.lattice), 128, 0.12
    V, dev = math.prod(lattice), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    u = Field("u", 72, lattice, SOA, torch.randn((72, V), generator=gen, device=dev) * 0.2)
    b = Field("b", 24, lattice, SOA, torch.randn((24, V), generator=gen, device=dev))
    x, y, p, q = (torch.randn((24, V), generator=gen, device=dev) for _ in range(4))
    partials = torch.randn((-(-V // vvl), 24), generator=gen, device=dev)
    alpha = torch.tensor(0.37, device=dev)
    prod = target.site_mul(x, y, vvl)
    kernels = {
        "mul": time_ms(lambda: target.site_mul(x, y, vvl)),
        "reduce_sum": time_ms(lambda: reduce.reduce_sites(prod, "sum", vvl)),
        "reduce_fold": time_ms(lambda: reduce.fold_partials(partials, "sum")),
        "cg_update": time_ms(lambda: fuse.cg_update(x, y, p, q, alpha, -alpha, vvl)),
        "cg_xpay": time_ms(lambda: fuse.cg_xpay(p, y, alpha, vvl)),
        "wilson_normal": time_ms(lambda: wk.wilson_normal_cuda(p, u.data, kappa, lattice, vvl)),
    }
    del x, y, p, q, partials, prod

    cfg = MilcConfig(lattice=lattice, kappa=kappa, tol=0.0, max_iter=args.iterations,
                     target=TargetConfig("cuda", device="cuda", vvl=vvl))
    solve_s = []
    for k in range(args.reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(cfg, u, b)
        torch.cuda.synchronize()
        if k:
            solve_s.append(time.perf_counter() - t0)
        if res.iterations != args.iterations:
            raise AssertionError(f"{res.iterations} iterations, expected {args.iterations}")
    rr = torch.randn(24, generator=gen, device=dev)
    fold_us = {"sum": host_us(lambda: rr.sum(dim=-1))}
    if has_fold:
        fold_us["fold_components"] = host_us(lambda: reduce.fold_components(rr))
    out = {"label": args.label, "card": smi, "fold": args.fold if has_fold else "sum (no fold)",
           "lattice": list(lattice), "kernel_ms": kernels,
           "ms_per_iteration": statistics.median(solve_s) / args.iterations * 1e3,
           "ms_per_iteration_all": [s / args.iterations * 1e3 for s in solve_s],
           "host_us_per_fold_call": fold_us}
    if args.ludwig:
        del u, b, rr
        torch.cuda.empty_cache()
        out["ludwig"] = list(args.ludwig)
        out["ludwig_ms_per_step"] = ludwig_steps(tuple(args.ludwig), args.reps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

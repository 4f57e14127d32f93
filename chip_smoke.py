"""Drive the PyTorch/CUDA port of the MILC Wilson-CG solve on one GPU.

    python3 chip_smoke.py [--lattice X Y Z T] [--small X Y Z T]

Phases (any failure raises and exits non-zero; nothing is caught):

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the hand-written kernels (src/repro_torch/csrc, one nvcc call)
   while the host generates the problem (random SU(3) gauge field and
   source at ``--lattice``, default (64, 64, 64, 32));
3. hold every kernel against its plain PyTorch version on the card at
   that lattice and time both (CUDA events, median of several runs);
4. with every launch count set to 0, solve M x = b on the "cuda" engine
   (kappa 0.12, hot 0.6, tol 1e-10, max_iter 2000), check
   |M x - b| / |b| < 1e-3 and that every kernel of the path launched;
5. at ``--small`` (default (16, 16, 16, 16)) solve on the "cuda" and the
   "torch" engine, both on the card: iterations within +-1, x within
   rel-L2 1e-4;
6. print the kernel table as one JSON line, then the result line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import _cuda  # noqa: E402
from repro_torch.apps.milc import MilcConfig, init_problem, residual_check, solve  # noqa: E402
from repro_torch.core import TargetConfig  # noqa: E402
from repro_torch.core import fuse, reduce, target  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as wk  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 outside the tensor cores
FIELD_RTOL = 1e-5           # fields: max|kernel - plain| <= FIELD_RTOL * max|plain|
SUM_RTOL = 1e-5             # sums: |kernel - plain| <= SUM_RTOL * sum|terms| per component
KAPPA, HOT, TOL, MAX_ITER = 0.12, 0.6, 1e-10, 2000

KERNELS = [target.G5, target.MUL, target.AXPY, reduce.REDUCE_SUM,
           reduce.REDUCE_MAX, reduce.REDUCE_FOLD, fuse.CG_UPDATE, fuse.CG_XPAY,
           wk.DSLASH, wk.WILSON_NORMAL_T, wk.WILSON_NORMAL_AP]

# the solve's path: name -> (counters, source, TPU kernel it replaces)
PATH = {
    "g5": ([target.G5], "site_local.cu", "src/repro/core/target.py:387"),
    "mul": ([target.MUL], "site_local.cu", "src/repro/core/target.py:387"),
    "reduce_sum": ([reduce.REDUCE_SUM], "reduce.cu", "src/repro/core/reduce.py:106"),
    "reduce_fold": ([reduce.REDUCE_FOLD], "reduce.cu", "src/repro/core/reduce.py:106"),
    "cg_update": ([fuse.CG_UPDATE], "fused_flat.cu", "src/repro/core/fuse.py:1411"),
    "cg_xpay": ([fuse.CG_XPAY], "fused_flat.cu", "src/repro/core/fuse.py:1411"),
    "dslash": ([wk.DSLASH], "dslash.cu", "src/repro/kernels/wilson_dslash/kernel.py:27"),
    "wilson_normal": ([wk.WILSON_NORMAL_T, wk.WILSON_NORMAL_AP], "wilson_normal.cu",
                      "src/repro/core/fuse.py:1721"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def field_err(got, want, name):
    err = (got - want).abs().max().item()
    lim = FIELD_RTOL * want.abs().max().item()
    if not err <= lim:
        raise AssertionError(f"{name}: max abs err {err} > {lim}")
    return err


def exact_err(got, want, name):
    if not torch.equal(got, want):
        raise AssertionError(
            f"{name}: not bitwise equal (max abs err {(got - want).abs().max().item()})")
    return 0.0


def sum_err(got, want, terms, name):
    err = (got - want).abs()
    lim = SUM_RTOL * terms.abs().sum(dim=-1)
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name}: sum err {err.max().item()} beyond {SUM_RTOL} "
                             f"x sum|terms|")
    return err.max().item()


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check_kernels(u, b, lattice, vvl):
    """Phase 3: every kernel against its plain version at the path's shapes."""
    V = math.prod(lattice)
    dev = b.data.device
    gen = torch.Generator(device=dev).manual_seed(1)
    psi, uu = b.data, u.data
    y, p, ap = (torch.randn((24, V), generator=gen, device=dev) for _ in range(3))
    alpha = torch.tensor(0.37, device=dev)
    neg_alpha = -alpha
    rows = {}

    def row(name, err, ms, plain_ms, nbytes, flops, library_ms=None):
        b_ms, b_by = bound(nbytes, flops)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=library_ms)
        log(f"  {name:14s} err {err:.3e}  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by})"
            + (f"  library {library_ms:.4f} ms" if library_ms is not None else ""))

    err = exact_err(target.site_g5(psi, 12, vvl), target.g5_plain(psi, 12), "g5")
    row("g5", err, time_ms(lambda: target.site_g5(psi, 12, vvl)),
        time_ms(lambda: target.g5_plain(psi, 12)), 2 * 96 * V, 12 * V)

    prod = target.site_mul(psi, y, vvl)
    err = exact_err(prod, psi * y, "mul")
    row("mul", err, time_ms(lambda: target.site_mul(psi, y, vvl)),
        time_ms(lambda: psi * y), 3 * 96 * V, 24 * V,
        library_ms=time_ms(lambda: torch.mul(psi, y)))

    err = field_err(target.site_axpy(0.75, psi, y, vvl), psi * 0.75 + y, "axpy")
    log(f"  axpy (not on the solve's path) err {err:.3e}")

    err = sum_err(reduce.reduce_sites(prod, "sum", vvl), reduce.reduce_plain(prod, "sum"),
                  prod, "reduce_sum")
    row("reduce_sum", err, time_ms(lambda: reduce.reduce_sites(prod, "sum", vvl)),
        time_ms(lambda: reduce.reduce_plain(prod, "sum")), 96 * V, 24 * V,
        library_ms=time_ms(lambda: torch.sum(prod, dim=1)))

    exact_err(reduce.reduce_sites(prod, "max", vvl), reduce.reduce_plain(prod, "max"),
              "reduce_max")
    log("  reduce_max (not on the solve's path) bitwise equal")

    partials = torch.randn((-(-V // vvl), 24), generator=gen, device=dev)
    err = sum_err(reduce.fold_partials(partials, "sum"), partials.sum(dim=0),
                  partials.T, "reduce_fold")
    row("reduce_fold", err, time_ms(lambda: reduce.fold_partials(partials, "sum")),
        time_ms(lambda: partials.sum(dim=0)), partials.numel() * 4 + 96,
        partials.numel(), library_ms=time_ms(lambda: torch.sum(partials, dim=0)))

    got = fuse.cg_update(psi, y, p, ap, alpha, neg_alpha, vvl)
    want = fuse.cg_update_plain(psi, y, p, ap, alpha, neg_alpha)
    err = max(field_err(got[0], want[0], "cg_update x_new"),
              field_err(got[1], want[1], "cg_update r_new"),
              sum_err(got[2], want[2], want[1] * want[1], "cg_update rr"))
    row("cg_update", err, time_ms(lambda: fuse.cg_update(psi, y, p, ap, alpha, neg_alpha, vvl)),
        time_ms(lambda: fuse.cg_update_plain(psi, y, p, ap, alpha, neg_alpha)),
        6 * 96 * V, 24 * 6 * V)

    err = field_err(fuse.cg_xpay(p, y, alpha, vvl), fuse.cg_xpay_plain(p, y, alpha), "cg_xpay")
    row("cg_xpay", err, time_ms(lambda: fuse.cg_xpay(p, y, alpha, vvl)),
        time_ms(lambda: fuse.cg_xpay_plain(p, y, alpha)), 3 * 96 * V, 2 * 24 * V,
        library_ms=time_ms(lambda: torch.addcmul(y, alpha, p)))

    err = field_err(wk.dslash_cuda(psi, uu, lattice, vvl), wk.dslash_plain(psi, uu, lattice),
                    "dslash")
    row("dslash", err, time_ms(lambda: wk.dslash_cuda(psi, uu, lattice, vvl)),
        time_ms(lambda: wk.dslash_plain(psi, uu, lattice), reps=3, warm=1),
        (24 + 72 + 24) * 4 * V, 1320 * V)

    got = wk.wilson_normal_cuda(psi, uu, KAPPA, lattice, vvl)
    want = wk.wilson_normal_plain(psi, uu, KAPPA, lattice)
    err = max(field_err(got[0], want[0], "wilson_normal ap"),
              sum_err(got[1], want[1], psi * want[0], "wilson_normal pap"))
    row("wilson_normal", err,
        time_ms(lambda: wk.wilson_normal_cuda(psi, uu, KAPPA, lattice, vvl)),
        time_ms(lambda: wk.wilson_normal_plain(psi, uu, KAPPA, lattice), reps=3, warm=1),
        (24 + 72 + 24) * 4 * V, (2 * (1320 + 48) + 48) * V)
    del got, want, prod, partials, y, p, ap
    torch.cuda.empty_cache()
    return rows


def solve_timed(cfg, u, b):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(cfg, u, b)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lattice", type=int, nargs=4, default=[64, 64, 64, 32])
    ap.add_argument("--small", type=int, nargs=4, default=[16, 16, 16, 16])
    args = ap.parse_args()
    lattice, small = tuple(args.lattice), tuple(args.small)

    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build the kernels while the host generates the problem
    cfg = MilcConfig(lattice=lattice, kappa=KAPPA, tol=TOL, hot=HOT, max_iter=MAX_ITER,
                     target=TargetConfig("cuda", device="cuda"))
    vvl = cfg.target.vvl
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        built = pool.submit(lambda: (_cuda.build(), time.perf_counter() - t0))
        u, b = init_problem(cfg, seed=0)
        gen_s = time.perf_counter() - t0
        lib, build_s = built.result()
    _cuda.library()
    log(f"build: {build_s:.1f} s ({lib.name}); problem {lattice} generated and "
        f"uploaded in {gen_s:.1f} s")

    # 3. every kernel against its plain version
    log(f"kernels at {lattice}, vvl {vvl} (V = {math.prod(lattice)}):")
    rows = check_kernels(u, b, lattice, vvl)

    # 4. the main path, counted
    for k in KERNELS:
        k.launches = 0
    res, solve_s = solve_timed(cfg, u, b)
    rc = residual_check(cfg, u, b, res.x)
    counts = {name: sum(k.launches for k in ks) for name, (ks, _, _) in PATH.items()}
    log(f"solve {lattice} on cuda: {res.iterations} iterations, {solve_s:.3f} s, "
        f"{solve_s / max(res.iterations, 1) * 1e3:.3f} ms/iter, residual "
        f"{float(res.residual):.3e}, |Mx-b|/|b| = {rc:.3e}")
    log(f"launches on the path: {counts}")
    if not torch.isfinite(res.x.data).all():
        raise AssertionError("solution has non-finite values")
    if not rc < 1e-3:
        raise AssertionError(f"residual_check {rc} >= 1e-3")
    idle = [n for n, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"kernels of the path never launched: {idle}")
    if res.iterations >= MAX_ITER:
        raise AssertionError("CG did not converge")
    del u, b, res
    torch.cuda.empty_cache()

    # 5. the cuda engine against the torch engine, both on the card
    scfg = MilcConfig(lattice=small, kappa=KAPPA, tol=TOL, hot=HOT, max_iter=MAX_ITER,
                      target=TargetConfig("cuda", device="cuda"))
    tcfg = MilcConfig(lattice=small, kappa=KAPPA, tol=TOL, hot=HOT, max_iter=MAX_ITER,
                      target=TargetConfig("torch", device="cuda"))
    su, sb = init_problem(scfg, seed=0)
    rc_, t_c = solve_timed(scfg, su, sb)
    rt_, t_t = solve_timed(tcfg, su, sb)
    rel = (torch.linalg.norm(rc_.x.data - rt_.x.data) / torch.linalg.norm(rt_.x.data)).item()
    log(f"solve {small}: cuda {rc_.iterations} it ({t_c:.3f} s), torch {rt_.iterations} it "
        f"({t_t:.3f} s), x rel-L2 {rel:.3e}")
    if abs(rc_.iterations - rt_.iterations) > 1 or not rel < 1e-4:
        raise AssertionError("cuda and torch engines disagree")

    # 6. the kernel table, then the result
    table = [dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
                  replaces=rep, launches=counts[name], **rows[name])
             for name, (_, src, rep) in PATH.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Time K4 and K5L against the parent's designs, in turns, on the same
tensors.

  python3 tools/k4_k5l_variants.py [--parent build/parent/src]
                                   [--lattice 64 64 64 32] [--ludwig 256 256 256]

Each variant is one source of a ``csrc/`` tree (this tree's, or the
parent's unpacked under ``--parent``: ``git archive <parent> src | tar -x
-C build/parent``), copied into the build directory with the defines the
variant names rewritten and compiled into a library of its own (the port's
nvcc flags, ``-Xptxas -v`` for each kernel's registers and spills),
launched through its C entry points.  K4 (``dslash.cu``, ``rt_dslash``),
also with its warp-staged kernels' registers capped for 4 blocks an SM
(``RT_DSLASH_WS_MIN_BLOCKS`` 4); K5L (``lb.cu``): ``rt_lb_step`` with and
without u and ``rt_lb_step_bf16`` at vvl 128; both in SoA, AoS, aosoa4,
aosoa8 and aosoa16, every output bitwise the parent's.  Random fields drawn
on the card; CUDA events, median of 10, a call at a time, variants in the
order given and then reversed.  Prints the card's name and power limit,
then one JSON line.  Needs a CUDA device; exits with 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# name -> (tree, source, {define: value}[, this tree's headers copied over
# the tree's]); tree "this" or "parent"
K4_VARIANTS = {"parent": ("parent", "dslash.cu", {}), "this": ("this", "dslash.cu", {}),
               "ws_4_blocks": ("this", "dslash.cu", {"RT_DSLASH_WS_MIN_BLOCKS": 4})}
K5L_VARIANTS = {"parent": ("parent", "lb.cu", {}), "this": ("this", "lb.cu", {})}
LAYOUTS = ("soa", "aos", "aosoa4", "aosoa8", "aosoa16")
VVL = 128


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


def build(_cuda, variants, parent_csrc):
    """Compile every variant at once; returns ({name: CDLL}, {name: ptxas
    lines of its kernels})."""
    procs, libs = {}, {}
    for name, (tree, src, defines, *headers) in variants.items():
        csrc = _cuda.BUILD_DIR / f"variant_{name}"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_cuda.CSRC if tree == "this" else parent_csrc, csrc)
        for header in headers:
            shutil.copy(_cuda.CSRC / header, csrc / header)
        path = csrc / src
        text = path.read_text()
        for key, value in defines.items():
            text, hits = re.subn(rf"^#define {key} \d+", f"#define {key} {value}", text,
                                 flags=re.M)
            if hits != 1:
                raise RuntimeError(f"{path}: no {key} define to set")
        path.write_text(text)
        libs[name] = _cuda.BUILD_DIR / f"variant_{name}.so"
        procs[name] = subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                        str(libs[name]), str(path)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    dlls, ptxas = {}, {}
    for name, pr in procs.items():
        out = pr.communicate()[0]
        if pr.returncode:
            raise RuntimeError(f"nvcc for {name} failed:\n{out}")
        ptxas[name] = [ln.split("ptxas info    : ")[-1].strip() for ln in out.splitlines()
                       if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        dll = ctypes.CDLL(str(libs[name]))
        for sym, sig in _cuda.SIGNATURES.items():
            if hasattr(dll, sym):
                fn = getattr(dll, sym)
                fn.argtypes, fn.restype = list(sig), ctypes.c_int
        dlls[name] = dll
    return dlls, ptxas


def turns(runs, label, check=True):
    """runs: {variant: fn -> outputs}; with ``check`` the outputs bitwise
    the first variant's; then each timed in turns; returns {variant: [ms,
    ms]}."""
    names = list(runs)
    ref = runs[names[0]]() if check else ()
    for n in names[1:] if check else ():
        for k, (a, b) in enumerate(zip(runs[n](), ref)):
            if not torch.equal(a.contiguous().view(torch.int16), b.contiguous().view(torch.int16)):
                raise AssertionError(f"{label}: {n} output {k} not bitwise {names[0]}'s")
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(time_ms(runs[n]))
    print(f"{label}: " + "; ".join(f"{n} {ms[n][0]:.4f}, {ms[n][1]:.4f}" for n in names) + " ms",
          flush=True)
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent" / "src"))
    ap.add_argument("--lattice", type=int, nargs=4, default=[64, 64, 64, 32])
    ap.add_argument("--ludwig", type=int, nargs=3, default=[256, 256, 256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _cuda
    from repro_torch.core import parse_layout
    from repro_torch.kernels.lb_collision.kernel import lb_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    k4, k5l = ({f"k4_{n}": v for n, v in K4_VARIANTS.items()},
               {f"k5l_{n}": v for n, v in K5L_VARIANTS.items()})
    dlls, ptxas = build(_cuda, {**k4, **k5l}, Path(args.parent) / "repro_torch" / "csrc")
    for name, lines in ptxas.items():
        kern = ""
        for ln in lines:
            if "Compiling entry" in ln:
                kern = ln.split("'")[1] if "'" in ln else ln
            elif "Used" in ln and ("tiled" in kern or "dslash_kernel" in kern
                                   or "lb_step" in kern):
                print(f"ptxas {name} {kern}: {ln}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result = {"card": smi, "lattice": list(args.lattice), "ludwig": list(args.ludwig)}

    # K4 in each layout: the parent's, design A, design B with each tile
    lat = tuple(args.lattice)
    V = math.prod(lat)
    u = torch.randn((72, V), generator=gen, device=dev) * 0.2
    psi = torch.randn((24, V), generator=gen, device=dev)

    def k4_run(name, lay, pl, ul):
        fn = dlls[name].rt_dslash

        def run():
            out = torch.empty_like(pl)
            d = lay.descriptor()
            rc = fn(pl.data_ptr(), ul.data_ptr(), out.data_ptr(), *lat, d, d, d, VVL, stream())
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return (out,)
        return run

    result["k4_ms"] = {}
    for spec in LAYOUTS:
        lay = parse_layout(spec)
        pl, ul = lay.pack(psi), lay.pack(u)
        result["k4_ms"][spec] = turns({n: k4_run(n, lay, pl, ul) for n in k4}, f"K4 {spec}")
        del pl, ul
    del u, psi
    torch.cuda.empty_cache()

    # K5L in each layout: both graphs and the policy instance
    llat = tuple(args.ludwig)
    V = math.prod(llat)
    dist = 0.05 + 0.01 * torch.rand((19, V), generator=gen, device=dev)
    force = 1e-3 * torch.randn((3, V), generator=gen, device=dev)
    prm = lb_params(0.8)

    def k5l_run(name, sym, with_u, dtype, lay, d, f):
        fn = getattr(dlls[name], sym)

        def run():
            d2 = torch.empty(lay.physical_shape(19, V), device=dev, dtype=dtype)
            uu = torch.empty(lay.physical_shape(3, V), device=dev, dtype=dtype) if with_u else None
            c = lay.descriptor()
            rc = fn(d.data_ptr(), f.data_ptr(), d2.data_ptr(), uu.data_ptr() if with_u else None,
                    *llat, *prm, c, c, c, c, VVL, stream())
            if rc:
                raise RuntimeError(f"{name} {sym}: CUDA error {rc}")
            return (d2, uu) if with_u else (d2,)
        return run

    result["k5l_ms"] = {}
    for spec in LAYOUTS:
        lay = parse_layout(spec)
        d, f = lay.pack(dist), lay.pack(force)
        for label, sym, with_u, dt in (("lb_step", "rt_lb_step", True, torch.float32),
                                       ("lb_collide_propagate", "rt_lb_step", False,
                                        torch.float32),
                                       ("lb_step_bf16", "rt_lb_step_bf16", True, torch.bfloat16)):
            result["k5l_ms"][f"{label}@{spec}"] = turns(
                {n: k5l_run(n, sym, with_u, dt, lay, d, f) for n in k5l}, f"K5L {label}@{spec}")
        del d, f
    result["ptxas"] = ptxas
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

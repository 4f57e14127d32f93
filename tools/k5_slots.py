"""Time K5B (the batched normal operator) built with each number of slots a
thread computes (``RT_NORMAL_SLOTS`` of ``csrc/wilson_normal.cuh``: 1 is one
slot a block, the links loaded once a slot; 2 and 4 load each link once for
that many slots), in turns, on the same tensors.

  python3 tools/k5_slots.py [--lattice 64 64 64 32] [--batch 4]

Each variant is a copy of ``csrc/`` in the build directory with
``RT_NORMAL_SLOTS`` set to n in ``wilson_normal.cuh``, its ``wilson_normal.cu``
compiled into a library of its own (the port's nvcc flags, ``-Xptxas -v``
for each kernel's registers and spills) and launched through its C entry
points; every variant's t, ap and partial rows must be bitwise
the first's.  Random fields drawn on the card; CUDA events, median of 10, a
call at a time, variants in the order 1, 2, 4, 4, 2, 1.  Prints the card's
name and power limit, then one JSON line.  Needs a CUDA device; exits with 1
without one.
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

VARIANTS = (1, 2, 4)
KAPPA, VVL = 0.12, 128


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lattice", type=int, nargs=4, default=[64, 64, 64, 32])
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {n: _cuda.BUILD_DIR / f"k5_slots_{n}.so" for n in VARIANTS}
    procs = {}
    for n, lib in libs.items():
        csrc = _cuda.BUILD_DIR / f"k5_slots_{n}"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_cuda.CSRC, csrc)
        head = csrc / "wilson_normal.cuh"
        text, hits = re.subn(r"^#define RT_NORMAL_SLOTS \d+", f"#define RT_NORMAL_SLOTS {n}",
                             head.read_text(), flags=re.M)
        if hits != 1:
            raise RuntimeError(f"{head}: no RT_NORMAL_SLOTS define to set")
        head.write_text(text)
        procs[n] = subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                     str(lib), str(csrc / "wilson_normal.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    regs = {}
    for n, pr in procs.items():
        out = pr.communicate()[0]
        if pr.returncode:
            raise RuntimeError(f"nvcc with RT_NORMAL_SLOTS {n} failed:\n{out}")
        # the SoA batched kernels' registers and spills (32-bit sites, n slots a thread)
        kern = None
        for ln in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                kern = m.group(1)
            elif kern and f"ILi0EiLi{n}E" in kern and "Used" in ln:
                regs.setdefault(n, {})["t" if "_t_" in kern else "ap"] = ln.split(": ")[-1]
    fns = {}
    for n, lib in libs.items():
        dll = ctypes.CDLL(str(lib))
        for name in ("rt_wilson_normal_t_batched", "rt_wilson_normal_ap_batched"):
            fn = getattr(dll, name)
            fn.argtypes, fn.restype = list(_cuda.SIGNATURES[name]), ctypes.c_int
        fns[n] = dll

    lat, B = tuple(args.lattice), args.batch
    V, dev = math.prod(lat), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn((72, V), generator=gen, device=dev) * 0.2
    p = torch.randn((B, 24, V), generator=gen, device=dev)

    def run(n):
        t = torch.empty((B, 24, V), device=dev)
        out = torch.empty_like(p)
        parts = torch.empty((B, -(-V // VVL), 24), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns[n].rt_wilson_normal_t_batched(p.data_ptr(), u.data_ptr(), t.data_ptr(), KAPPA,
                                               *lat, B, 0, 0, VVL, stream)
        rc = rc or fns[n].rt_wilson_normal_ap_batched(
            p.data_ptr(), t.data_ptr(), u.data_ptr(), out.data_ptr(), parts.data_ptr(), KAPPA,
            *lat, B, 0, 0, 0, VVL, stream)
        if rc:
            raise RuntimeError(f"RT_NORMAL_SLOTS={n}: CUDA error {rc}")
        return t, out, parts

    ref = run(VARIANTS[0])
    for n in VARIANTS[1:]:
        for k, (a, b) in enumerate(zip(run(n), ref)):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"RT_NORMAL_SLOTS={n}: output {k} not bitwise the first's")
    ms = {n: [] for n in VARIANTS}
    for n in VARIANTS + VARIANTS[::-1]:
        ms[n].append(time_ms(lambda: run(n)))
    for n in VARIANTS:
        print(f"RT_NORMAL_SLOTS={n}: {ms[n]} ms; registers {regs.get(n)}", flush=True)
    print(json.dumps({"card": smi, "lattice": list(lat), "batch": B, "ms": ms,
                      "ptxas": regs}), flush=True)


if __name__ == "__main__":
    main()

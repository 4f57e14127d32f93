"""Time K2's unsplit fold (pass 2) on the card through the port found under
``--src``, so that two versions of the port can be compared in one call.

  python3 tools/fold_ab.py [--src DIR] [--label NAME]

For each table, plain (65,536 x 24, the fused kernels' rr and pap rows at
(64,64,64,32); 2,048 x 24, pass 1's) and compensated (65,536 x 24 pairs),
it times ``core.reduce.fold_partials`` four ways: CUDA events around one
call (median of 200), the host's time a call over 2,000 calls with no
synchronisation between them, the call's launches replayed from a CUDA
graph (median of 200: the kernels alone), and the C entry point called
through ctypes alone (host time and events).  Prints the card's name and
power limit, then one JSON line (µs).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def events_us(torch, fn, reps=200):
    """Median time of fn() between two CUDA events, in µs."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def host_us(torch, fn, reps=2000):
    """Mean host time of fn() in µs, the device drained after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def graph_us(torch, fn):
    """Median time of fn()'s launches replayed from a CUDA graph, in µs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return events_us(torch, graph.replay)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the src directory that holds the repro_torch package to time")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fold_ab: no CUDA device")
    from repro_torch import _cuda
    from repro_torch.core import reduce as R

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    lib = _cuda.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"label": args.label, "src": args.src}
    for name, shape in (("plain65536", (65536, 24)), ("plain2048", (2048, 24)),
                        ("comp65536", (65536, 24, 2))):
        t = torch.randn(shape, generator=gen, device=dev)
        comp = len(shape) == 3
        nrows, ncomp = shape[:2]

        def call(t=t, comp=comp):
            return R.fold_partials(t, "sum", compensated=comp)

        # the entry point alone: out and scratch in one buffer, as the wrapper's
        buf = torch.empty(2 * (ncomp + R.fold_scratch(nrows, ncomp)), device=dev)
        ptrs = (t.data_ptr(), buf.data_ptr(), buf.data_ptr() + 8 * ncomp, nrows, ncomp)
        if comp:
            def c_call(ptrs=ptrs):
                lib.rt_reduce_fold_comp(*ptrs, 1, stream)
        else:
            def c_call(ptrs=ptrs):
                lib.rt_reduce_fold(*ptrs, 0, stream)
        for _ in range(20):
            call()
            c_call()
        out[name] = dict(event_us=events_us(torch, call), host_us=host_us(torch, call),
                         graph_us=graph_us(torch, call), c_host_us=host_us(torch, c_call),
                         c_event_us=events_us(torch, c_call))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

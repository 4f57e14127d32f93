"""Time the overlap split's box tables (K5HO) against thread-map and load
variants built from edited copies of ``csrc/wilson_halo.cu``, and K5H
against another tree's K5H, in turns on one card.

  python3 tools/k5h_designs.py [--parent ROOT] [--lattice 64 64 64 32] [--reps 10]

chip_smoke.py's D1 times the split's parts beside their byte and sector
bounds and the split against K5H; this tool times what D1 cannot: the
same launches built otherwise.  On random p and u padded by 2 (the
kernels' time does not depend on the values), every dim split (ring 2: the
interior and 8 slabs), through the table entry points
(``split_tables``):

  shell t, boundary ap     the boundary's two launches
  T-slabs t, T-slabs ap    the two T-slabs alone, paired (one entry with
                           a gap) and unpaired (two entries)
  split                    the four launches of one operator

with this tree's build ("port") and each variant of VARIANTS ("linear":
rows cut into a block's slots back to back; "ldcg": loads through L2
only; "walk": a thread walks the T sites of its row in a box of at most 4
along T, a warp's threads on consecutive z), the builds in order, then in
reverse; each variant's split checked bitwise against K5H first.
``--parent`` is the root of another tree with its kernels built
(``build/repro_torch`` there): its K5H's two launches are timed against
this tree's (parent, port, port, parent).  Each time is the median of
``--reps`` CUDA-event intervals around one call.  Prints the card's name
and power limit, a line a case, then one JSON line.  Needs a CUDA device
and nvcc; exits with 1 without a device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

KAPPA = 0.12
_WALK = r"""  rt_lattice c0;
  if (!rt_htab_site<I>(tb, c0)) return;
  const rt_hent hw = rt_htab_entry(tb, (int)blockIdx.x);
  const int nw = hw.lanes == 1 ? hw.ext.T : 1;
#pragma unroll 1
  for (int j = 0; j < nw; ++j) {
  rt_lattice c = c0;
  c.T += j + (j >= hw.tsplit ? hw.tgap : 0);
\1
  }
}
"""
# the thread-map and load variants, as (file, regex, replacement) edits of
# copies of csrc, each applied at least once
VARIANTS = {
    "linear": [("wilson_halo.cu", r"^#define RT_HROW_LANES_MAX \d+", "#define RT_HROW_LANES_MAX 0")],
    "ldcg": [("wilson.cuh", r"return __ldg\(p\); \}", "return __ldcg(p); }")],
    # a row of <= 4 sites takes one slot (lane 0), whose thread walks them
    "walk": [("wilson_halo.cu", r"(static inline int rt_row_lanes\(int T\) \{\n)",
              r"\1  if (T <= 4) return 1;\n"),
             ("wilson_halo.cu",
              r"  rt_lattice c;\n  if \(!rt_htab_site<I>\(tb, c\)\) return;\n(.*?)\n\}\n", _WALK)],
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TABLE_ARGS = [_P, _P, _P, _F, _I, _I, _I, _I, _P, _I, _I, _P]
_PRE_ARGS = [_P, _P, _P, _F, _I, _I, _I, _I, _I, _P]


def time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def declare(so, names, argtypes):
    for n in names:
        fn = getattr(so, n)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


def variant(csrc: Path, flags, build: Path, name: str, edits):
    """wilson_halo.cu with ``edits`` applied, built alone into a library of
    its own, its entry points declared."""
    from repro_torch._cuda import _nvcc
    d = build / f"k5h_{name}"
    d.mkdir(parents=True, exist_ok=True)
    for f in list(csrc.glob("*.cuh")) + [csrc / "wilson_halo.cu"]:
        text = f.read_text()
        for fname, pat, rep in edits:
            if fname == f.name:
                text, n = re.subn(pat, rep, text, flags=re.M | re.S)
                assert n >= 1, (fname, pat)
        (d / f.name).write_text(text)
    lib = d / "libk5h.so"
    subprocess.run([_nvcc(), *flags, "-shared", "-o", str(lib), str(d / "wilson_halo.cu")],
                   check=True)
    return declare(ctypes.CDLL(str(lib)), ("rt_wilson_normal_t_boxes", "rt_wilson_normal_ap_boxes"),
                   _TABLE_ARGS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lattice", type=int, nargs=4, default=(64, 64, 64, 32))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", default=None,
                    help="root of another tree (its kernels built), whose K5H is timed too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k5h_designs: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import _cuda
    from repro_torch.core.overlap import split_boxes
    from repro_torch.kernels.wilson_dslash import kernel as wk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card)
    lib = _cuda.library()
    libs = {"port": lib}
    for name, edits in VARIANTS.items():
        libs[name] = variant(_cuda.CSRC, _cuda.COMPILE_FLAGS, _cuda.BUILD_DIR, name, edits)
    lat = tuple(args.lattice)
    V, V1, Vh = (int(torch.tensor([s + 2 * w for s in lat]).prod()) for w in (0, 1, 2))
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn((24, Vh), generator=gen, device="cuda")
    u = torch.randn((72, Vh), generator=gen, device="cuda") * 0.3
    whole = wk.wilson_normal_pre_cuda(p, u, KAPPA, lat)
    t = torch.empty((24, V1), device="cuda")
    apo = torch.empty((24, V), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(so, kind, ents):
        tb, n = wk._table(ents)
        fn, src, dst = ((so.rt_wilson_normal_t_boxes, p, t) if kind == "t" else
                        (so.rt_wilson_normal_ap_boxes, t, apo))
        rc = fn(src.data_ptr(), u.data_ptr(), dst.data_ptr(), KAPPA, *lat, tb, n, 128, stream)
        assert rc == 0, rc

    interior, boundary = split_boxes(lat, 2, range(4))
    oe = [(tuple(a for a, _ in b), tuple(c - a for a, c in b)) for b in [interior] + boundary]
    tables = wk.split_tables(lat, oe[0], oe[1:])
    o, e = oe[0]
    tslabs = wk.shell_boxes(lat, o, e)[-2:]
    cases = {n: [tables[n]] for n in ("shell t", "boundary ap")}
    cases.update({"T-slabs t": [("t", wk.pair_t_slabs(tslabs))],
                  "T-slabs ap": [("ap", wk.pair_t_slabs(oe[-2:]))],
                  "T-slabs t unpaired": [("t", wk.table_entries(tslabs))],
                  "T-slabs ap unpaired": [("ap", wk.table_entries(oe[-2:]))],
                  "split": list(tables.values())})

    def run(so, name):
        return lambda: [launch(so, kind, ents) for kind, ents in cases[name]]

    bitwise = {}
    for name, so in libs.items():
        apo.fill_(float("nan"))
        run(so, "split")()
        torch.cuda.synchronize()
        bitwise[name] = bool(torch.equal(apo, whole))
    print(f"split bitwise K5H: {bitwise}")
    ms = {n: {lb: [] for lb in libs} for n in cases}
    for order in (list(libs), list(libs)[::-1]):
        for lb in order:
            for n in cases:
                ms[n][lb].append(time_ms(run(libs[lb], n), args.reps))
    if args.parent:
        found = sorted((Path(args.parent) / "build" / "repro_torch").glob("librepro_torch_*.so"))
        pre = {"parent": declare(ctypes.CDLL(str(found[-1])), ("rt_wilson_normal_pre_t",
                                                              "rt_wilson_normal_pre_ap"),
                                 _PRE_ARGS),
               "port": lib}

        def k5h(so, kind):
            if kind == "t":
                return lambda: so.rt_wilson_normal_pre_t(p.data_ptr(), u.data_ptr(), t.data_ptr(),
                                                         KAPPA, *lat, 128, stream)
            return lambda: so.rt_wilson_normal_pre_ap(t.data_ptr(), u.data_ptr(), apo.data_ptr(),
                                                      KAPPA, *lat, 128, stream)

        ms["k5h t"] = {lb: [] for lb in pre}
        ms["k5h ap"] = {lb: [] for lb in pre}
        for lb in ("parent", "port", "port", "parent"):
            for kind in ("t", "ap"):
                ms[f"k5h {kind}"][lb].append(time_ms(k5h(pre[lb], kind), args.reps))
    for n, row in ms.items():
        print(f"{n:20s} " + "  ".join(f"{lb} {v}" for lb, v in row.items()))
    print(json.dumps({"k5h_designs": {"card": card, "lattice": list(lat), "reps": args.reps,
                                      "bitwise_k5h": bitwise, "ms": ms}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

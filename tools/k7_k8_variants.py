"""Time K7 (the LB collision), K8 (the LB propagation) and K5L (the fused LB
step) against the parent's designs and each other, in turns, on the same
tensors.

  python3 tools/k7_k8_variants.py [--parent build/parent/src]
                                  [--ludwig 256 256 256] [--layouts soa aos ...]

Each variant is ``csrc/lb.cu`` of a tree (this tree's, or the parent's
unpacked under ``--parent``: ``git archive <parent> src | tar -x -C
build/parent``), built and launched through its C entry points by
``tools/k4_k5l_variants.py::build`` (its copy of the tree with the defines
the variant names rewritten):

  parent          the parent's lb.cu and headers
  parent_pinned   the parent's lb.cu with this tree's d3q19.cuh: the
                  collision's pinned roundings alone
  this            this tree's lb.cu
  k8_xs8          this tree's, K8's staged tiles walking 8 x-planes a block
                  (``RT_K8_XS``; the tree's 16)
  k8_sal8         this tree's, K8's staged tiles also for AoSoA with SAL 8
                  (``RT_K8_MAX_SAL``; the tree's 4)

At each layout (vvl 128): K7 (``rt_lb_collide``) in parent, parent_pinned
and this, held bitwise to the plain version on the card (parent within
1e-5 x max|plain|); K8 (``rt_lb_propagate``) in parent, this and the k8
variants, all bitwise the plain version, beside ``torch.take`` on the
layout's 19 V source offsets (``chip_smoke.take_index``, built before the
timing); K5L (``rt_lb_step``, with u) in parent, parent_pinned and this,
dist2 bitwise the plain version on the card (parent within tolerance), u
bitwise the parent's.  Random fields drawn on the card; CUDA events,
median of 10, a call at a time, the variants in order and then in reverse.
Prints the card's name and power limit, a line a kernel and layout, then
one JSON line.  Needs a CUDA device; exits with 1 without one.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# name -> (tree, source, {define: value}, this tree's headers over the tree's)
VARIANTS = {"parent": ("parent", "lb.cu", {}),
            "parent_pinned": ("parent", "lb.cu", {}, "d3q19.cuh"),
            "this": ("this", "lb.cu", {}),
            "k8_xs8": ("this", "lb.cu", {"RT_K8_XS": 8}),
            "k8_sal8": ("this", "lb.cu", {"RT_K8_MAX_SAL": 8})}
K7 = ("parent", "parent_pinned", "this")
K8 = ("parent", "this", "k8_xs8", "k8_sal8")
K5L = ("parent", "parent_pinned", "this")
LAYOUTS = ("soa", "aos", "aosoa4", "aosoa8", "aosoa16", "aosoa32")
VVL, TAU = 128, 0.8


def bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent" / "src"))
    ap.add_argument("--ludwig", type=int, nargs=3, default=[256, 256, 256])
    ap.add_argument("--layouts", nargs="+", default=list(LAYOUTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
    from chip_smoke import FIELD_RTOL, HBM_BYTES_PER_S, take_index
    from k4_k5l_variants import build, time_ms, turns
    from repro_torch import _cuda
    from repro_torch.core import parse_layout
    from repro_torch.kernels.lb_collision.kernel import collide_plain, lb_params
    from repro_torch.kernels.lb_propagation.kernel import lb_step_plain, propagate_plain
    from repro_torch.maths import d3q19

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dlls, ptxas = build(_cuda, VARIANTS, Path(args.parent) / "repro_torch" / "csrc")
    for name, lines in ptxas.items():
        kern = ""
        for ln in lines:
            if "Compiling entry" in ln:
                kern = ln.split("'")[1] if "'" in ln else ln
            elif "Used" in ln and ("collide" in kern or "propagate" in kern):
                print(f"ptxas {name} {kern}: {ln}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    lat = tuple(args.ludwig)
    V = math.prod(lat)
    w = torch.tensor([float(x) for x in d3q19.WV], device=dev)[:, None]
    dist = w * (1 + 0.1 * torch.randn((19, V), generator=gen, device=dev))
    force = 1e-3 * torch.randn((3, V), generator=gen, device=dev)
    prm = lb_params(TAU)
    result = {"card": smi, "ludwig": list(lat), "vvl": VVL,
              "bound_ms": {"lb_collide": 164 * V / HBM_BYTES_PER_S * 1e3,
                           "lb_propagate": 152 * V / HBM_BYTES_PER_S * 1e3,
                           "lb_step": 176 * V / HBM_BYTES_PER_S * 1e3},
              "k7_ms": {}, "k8_ms": {}, "k8_take_ms": {}, "k5l_ms": {}}
    print(f"bounds (ms): {result['bound_ms']}", flush=True)

    def call(name, sym, *a):
        rc = getattr(dlls[name], sym)(*a, stream())
        if rc:
            raise RuntimeError(f"{name} {sym}: CUDA error {rc}")

    for spec in args.layouts:
        lay = parse_layout(spec)
        c = lay.descriptor()
        d, f = lay.pack(dist), lay.pack(force)
        L = {"dist": lay, "force": lay, "out": lay}

        def k7(name):
            def run():
                out = torch.empty_like(d)
                call(name, "rt_lb_collide", d.data_ptr(), f.data_ptr(), out.data_ptr(), V, *prm,
                     c, c, c, VVL)
                return out
            return run

        want = collide_plain(d, f, TAU, L)
        for n in K7:
            got = k7(n)()
            if n == "parent":
                err = (got - want).abs().max().item()
                assert err <= FIELD_RTOL * want.abs().max().item(), (spec, n, err)
            else:
                assert bits(got, want), f"K7 {n} in {spec}: not bitwise the plain version"
        collided = want
        del want, got
        result["k7_ms"][spec] = turns({n: k7(n) for n in K7}, f"K7 {spec}", check=False)

        def k8_run(name):
            def run():
                out = torch.empty_like(collided)
                call(name, "rt_lb_propagate", collided.data_ptr(), out.data_ptr(), *lat, c, c, VVL)
                return out
            return run

        want = propagate_plain(collided, lat, {"dist": lay})
        for n in K8:
            assert bits(k8_run(n)(), want), f"K8 {n} in {spec}: not bitwise the plain version"
        idx = take_index(lat, lay, dev)
        assert bits(torch.take(collided, idx), want), f"torch.take in {spec}"
        del want
        result["k8_ms"][spec] = turns({n: k8_run(n) for n in K8}, f"K8 {spec}", check=False)
        result["k8_take_ms"][spec] = time_ms(lambda: torch.take(collided, idx))
        print(f"K8 {spec}: torch.take {result['k8_take_ms'][spec]:.4f} ms", flush=True)
        del idx, collided
        torch.cuda.empty_cache()

        def k5l(name):
            def run():
                d2 = torch.empty_like(d)
                uu = torch.empty_like(f)
                call(name, "rt_lb_step", d.data_ptr(), f.data_ptr(), d2.data_ptr(), uu.data_ptr(),
                     *lat, *prm, c, c, c, c, VVL)
                return d2, uu
            return run

        want2, _ = lb_step_plain(d, f, TAU, lat, layouts={"dist": lay, "force": lay,
                                                          "dist2": lay, "u": lay})
        ref_u = k5l("parent")()[1]
        for n in K5L:
            d2, uu = k5l(n)()
            assert bits(uu, ref_u), f"K5L {n} in {spec}: u not bitwise the parent's"
            if n == "parent":
                err = (d2 - want2).abs().max().item()
                assert err <= FIELD_RTOL * want2.abs().max().item(), (spec, n, err)
            else:
                assert bits(d2, want2), f"K5L {n} in {spec}: dist2 not bitwise the plain version"
        del want2, ref_u, d2, uu
        result["k5l_ms"][spec] = turns({n: k5l(n) for n in K5L}, f"K5L {spec}", check=False)
        del d, f
        torch.cuda.empty_cache()
    result["ptxas"] = ptxas
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

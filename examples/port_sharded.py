"""The port's decomposed lattice: the sharded MILC solve and Ludwig step on
a mesh of ranks, each schedule (the MILC solve's None, "pre" and "overlap",
the Ludwig step's "pre" and "overlap") held against the single-device path.

One process a rank.  Under torchrun the mesh reads RANK, WORLD_SIZE and
LOCAL_RANK; alone, the mesh has one rank and every exchange is the
self-exchange.  ``--device cpu`` runs the ranks on the CPU over gloo
(the torch engine); the default runs them on the card over NCCL (the cuda
engine).

    PYTHONPATH=src torchrun --nproc-per-node 4 examples/port_sharded.py --device cpu
    PYTHONPATH=src python examples/port_sharded.py --mesh 1 1 1
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch.apps.ludwig import LudwigConfig, init_state, step
from repro_torch.apps.ludwig.driver import make_sharded_step
from repro_torch.apps.milc import MilcConfig, init_problem, solve
from repro_torch.apps.milc.driver import make_domain, make_sharded_solver
from repro_torch.core import TargetConfig
from repro_torch.lattice import Domain
from repro_torch.launch.mesh import Mesh


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, nargs="+", default=None,
                    help="mesh shape over the lattice's first dims (default: 2 x (ranks / 2), "
                         "or the ranks on one axis)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--milc", type=int, nargs=4, default=[8, 8, 8, 8])
    ap.add_argument("--ludwig", type=int, nargs=3, default=[16, 16, 16])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    world = int(os.environ.get("WORLD_SIZE", "1"))
    shape = tuple(args.mesh) if args.mesh else ((2, world // 2) if world % 2 == 0 and world > 2
                                                else (world,))
    names = tuple(f"m{k}" for k in range(len(shape)))
    mesh = Mesh(shape, names, device=args.device)
    tgt = TargetConfig("cuda" if args.device == "cuda" else "torch", device=str(mesh.device))
    lead = mesh.rank == 0

    mc = MilcConfig(lattice=tuple(args.milc), kappa=0.12, tol=1e-10, max_iter=2000, target=tgt)
    u, b = init_problem(mc, seed=0)
    single = solve(mc, u, b)
    dom = make_domain(mc, mesh, names + (None,) * (4 - len(names)))
    for halo in (None, "pre", "overlap"):
        t0 = time.perf_counter()
        x, it, _ = make_sharded_solver(mc, dom, halo)(dom.scatter(u.canonical_nd()),
                                                     dom.scatter(b.canonical_nd()))
        sec = time.perf_counter() - t0
        xg, ref = dom.gather(x), single.x.canonical_nd()
        rel = (torch.linalg.norm(xg - ref) / torch.linalg.norm(ref)).item()
        if lead:
            print(f"milc {mc.lattice} on {shape} ranks, halo={halo!r}: {it} iterations "
                  f"(single {single.iterations}), x rel-L2 {rel:.2e}, {sec:.3f} s")

    lc = LudwigConfig(lattice=tuple(args.ludwig), target=tgt)
    st = init_state(lc, seed=0)
    dom = Domain(lc.lattice, mesh, names + (None,) * (3 - len(names)), halo=2)
    s = st
    for _ in range(args.steps):
        s = step(s, lc)
    for halo in ("pre", "overlap"):
        sstep = make_sharded_step(lc, dom, halo)
        d, q = dom.scatter(st.dist.canonical_nd()), dom.scatter(st.q.canonical_nd())
        for _ in range(args.steps):
            d, q = sstep(d, q)
        same = (torch.equal(dom.gather(d), s.dist.canonical_nd())
                and torch.equal(dom.gather(q), s.q.canonical_nd()))
        if lead:
            print(f"ludwig {lc.lattice} on {shape} ranks ({math.prod(shape)}), halo={halo!r}: "
                  f"{args.steps} sharded steps bitwise the single-device steps: {same}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Serving launcher: batched lattice-solve serving and batched LM decode.

Solve path (``--solve``): a shape-bucketed request scheduler for
multi-simulation serving.  Requests (source Fields) are queued per lattice
shape; each bucket owns a fixed number of batch *slots* and replays one
convergence-masked batched CG iteration
(``train.serve_step.build_cg_serve_step``) over all of its slots: one fused
operator launch and one fused masked-update launch a tick, however many
requests are packed in.  A converged (or max_iter'd) slot is harvested and
refilled from the queue at the next tick while in-flight slots are
untouched: the masking is a bitwise select, so every request's trajectory
is a dedicated ``apps.milc.driver.solve``'s, bit for bit.

LM path (``--arch``): greedy decode of a batch of random prompts through
``train.serve_step.generate``, for the families the port has.

Mixed-precision serving: a dtype policy on the server's config applies to
the operator launch (as ``driver.solve_batched`` applies
``MilcConfig.storage``), and ``refine_every > 0`` (``--refine-every``)
restarts a slot from its true residual every that many active iterations,
through the policy-free operator; the bucket keeps each slot's rhs for
that.  Admission and the update chain run without the policy, so every
outcome is bitwise ``solve_batched``'s one-slot run of its source.

A shared-memory budget on the server's config (``TargetConfig.smem_bytes``)
tiles the operator launch as it tiles ``driver.solve``'s, with no change
here: on "cuda" the batched operator runs K5T's batch instance, and every
outcome is the budgeted ``solve``'s, bit for bit.

The JAX package's serve telemetry (``telemetry.inc/sample/span`` around
admission, ticks and drains, and the ``--trace`` option) is left out: the
port has no ``core/telemetry.py`` yet (ROADMAP item 20), which adds it here
when it lands.  ``--plan-policy tuned`` runs every launch whose plan the
tuner persisted (``core.tune``, the port's own table) with that plan; the
serving launches are batched, and batched keys carry the batch, so they
miss a table swept on single launches and plan by default, as in the JAX
package.

  PYTHONPATH=src python -m repro_torch.launch.serve --solve --requests 6 --slots 2
  PYTHONPATH=src python -m repro_torch.launch.serve --solve --engine torch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --smoke-arch
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import BatchedField, Field, TargetConfig

__all__ = ["SolveRequest", "SolveOutcome", "SolveServer", "main"]


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One inversion request: solve M x = b for the bucket's operator."""
    rid: int
    b: Field


@dataclasses.dataclass(frozen=True)
class SolveOutcome:
    rid: int
    x: Field
    iterations: int
    residual: float


class _Bucket:
    """All state for one lattice shape: the operator, a FIFO admission
    queue, ``slots`` batch slots and the masked-iteration step."""

    def __init__(self, u: Field, kappa: float, config: TargetConfig, slots: int,
                 tol: float, max_iter: int, refine_every: int = 0):
        from repro_torch.apps.milc.cg import make_wilson_op
        from repro_torch.train.serve_step import build_cg_serve_step

        # a dtype policy applies to the step's operator alone: admission
        # runs the policy-free config, as solve_batched does
        self.u, self.kappa = u, float(kappa)
        self.config = dataclasses.replace(config, dtypes=None) if config.dtypes else config
        self.tol, self.max_iter, self.slots = tol, max_iter, slots
        self.refine_every = int(refine_every)
        _, self.apply_mdag, _ = make_wilson_op(u, self.kappa, self.config)
        self.step = build_cg_serve_step(u, self.kappa, config, tol=tol, max_iter=max_iter,
                                        refine_every=self.refine_every)
        self.queue: deque = deque()
        self.slot_rid: list = [None] * slots
        self.state = None  # shaped from the first admitted source
        self.rhs = None    # each slot's rhs, kept for the refinement restarts
        self.iterations_run = 0

    # -- slot state ------------------------------------------------------

    def _init_state(self, proto: Field):
        from repro_torch.apps.milc.cg import BatchedCGState

        z = BatchedField.zeros("x", self.slots, proto.ncomp, proto.lattice, proto.layout,
                               dtype=proto.dtype, device=proto.device)
        v = torch.zeros((self.slots,), dtype=proto.dtype, device=proto.device)
        self.state = BatchedCGState(
            x=z, r=z, p=z, rr=v, b2=v,
            it=torch.zeros((self.slots,), dtype=torch.int32, device=proto.device))
        self.rhs = z

    def _admit(self, slot: int, req: SolveRequest):
        """Pack a request into a free slot: rhs and |rhs|^2 come through the
        single-lattice M^dag and dot (the values a dedicated ``cg`` solve
        starts from), then land in the batch through per-slot writes into
        copies: in-flight slots' bits never move."""
        from repro_torch.apps.milc.cg import BatchedCGState, dot

        rhs = self.apply_mdag(req.b)
        if self.state is None:
            self._init_state(rhs)
        b2 = dot(rhs, rhs, self.config)
        st = self.state

        def put(vec, value):
            vec = vec.clone()
            vec[slot] = value
            return vec

        self.state = BatchedCGState(
            x=st.x.with_element(slot, rhs.with_data(torch.zeros_like(rhs.data))),
            r=st.r.with_element(slot, rhs),
            p=st.p.with_element(slot, rhs),
            rr=put(st.rr, b2), b2=put(st.b2, b2), it=put(st.it, 0))
        self.rhs = self.rhs.with_element(slot, rhs)
        self.slot_rid[slot] = req.rid

    def _harvest(self, slot: int) -> SolveOutcome:
        st = self.state
        # a copy: a view would keep the whole slot stack of this tick alive
        x = st.x.element(slot)
        out = SolveOutcome(rid=self.slot_rid[slot], x=x.with_data(x.data.clone()),
                           iterations=int(st.it[slot]),
                           residual=float(st.rr[slot] / st.b2[slot]))
        self.slot_rid[slot] = None
        return out

    # -- scheduler tick --------------------------------------------------

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_rid)

    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self.slot_rid)

    def tick(self) -> Dict[int, SolveOutcome]:
        """Admit into free slots, run one masked batched iteration, drain
        finished slots.  Returns {rid: outcome} for the requests that
        completed this tick."""
        from repro_torch.apps.milc.cg import batched_cg_active

        for slot in range(self.slots):
            if self.slot_rid[slot] is None and self.queue:
                self._admit(slot, self.queue.popleft())
        if not self.occupied:
            return {}
        if self.refine_every > 0:
            self.state = self.step(self.state, self.rhs)
        else:
            self.state = self.step(self.state)
        self.iterations_run += 1
        # the liveness read is the tick's one host synchronisation
        act = batched_cg_active(self.state, tol=self.tol, max_iter=self.max_iter).tolist()
        done = {}
        for slot in range(self.slots):
            if self.slot_rid[slot] is not None and not act[slot]:
                out = self._harvest(slot)
                done[out.rid] = out
        return done


class SolveServer:
    """Shape-bucketed batched solve scheduler.

    ``register(u, kappa)`` declares the operator for requests on
    ``u.lattice``; ``submit`` enqueues sources; ``run`` drains every queue
    to completion, interleaving ticks across buckets so mixed-shape request
    streams make progress together.  Each bucket packs up to ``slots``
    requests into one batched launch chain."""

    def __init__(self, config: TargetConfig, *, slots: int = 4, tol: float = 1e-8,
                 max_iter: int = 500, refine_every: int = 0):
        self.config = config
        self.slots, self.tol, self.max_iter = slots, tol, max_iter
        self.refine_every = int(refine_every)
        self.buckets: Dict[Tuple[int, ...], _Bucket] = {}

    def register(self, u: Field, kappa: float, slots: Optional[int] = None) -> None:
        """Declare the gauge field and kappa serving ``u.lattice``-shaped
        requests (one operator per shape bucket)."""
        self.buckets[u.lattice] = _Bucket(u, kappa, self.config, slots or self.slots,
                                          self.tol, self.max_iter, self.refine_every)

    def submit(self, req: SolveRequest) -> None:
        if req.b.lattice not in self.buckets:
            raise KeyError(f"no operator registered for lattice {req.b.lattice}; "
                           f"known: {sorted(self.buckets)}")
        self.buckets[req.b.lattice].queue.append(req)

    def run(self) -> Dict[int, SolveOutcome]:
        """Tick all buckets round-robin until every queue and slot is
        drained.  Returns {rid: SolveOutcome}."""
        results: Dict[int, SolveOutcome] = {}
        while any(b.busy for b in self.buckets.values()):
            for bucket in self.buckets.values():
                if bucket.busy:
                    results.update(bucket.tick())
        return results


# -- CLI -------------------------------------------------------------------

def _main_decode(args):
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.train.serve_step import generate

    cfg = get_arch(args.arch, smoke=args.smoke_arch)
    dev = torch.device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(1, cfg.vocab, (args.batch, 8), generator=gen).to(dev)
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, steps=args.steps, s_max=8 + args.steps + 8)
    dt = time.perf_counter() - t0
    print(f"{args.batch * args.steps} tokens in {dt:.2f}s")
    print(out[0].tolist())


def _main_solve(args):
    from repro_torch.apps.milc import driver, fields

    cfg = driver.MilcConfig(
        lattice=(4, 4, 4, 8), kappa=0.10, tol=1e-8, max_iter=args.steps,
        target=TargetConfig(args.engine, device=args.device, vvl=128,
                            plan_policy=args.plan_policy))
    server = SolveServer(cfg.target, slots=args.slots, tol=cfg.tol, max_iter=cfg.max_iter,
                         refine_every=args.refine_every)
    shapes = [(4, 4, 4, 8), (4, 4, 8, 8)]
    for i, lat in enumerate(shapes):
        u = Field.from_numpy("u", fields.random_su3_gauge(lat, seed=i, hot=cfg.hot), lat,
                             cfg.layout, device=args.device)
        server.register(u, cfg.kappa)
        for j in range(args.requests // len(shapes)):
            b = Field.from_numpy("b", fields.random_spinor(lat, seed=100 + 10 * i + j), lat,
                                 cfg.layout, device=args.device)
            server.submit(SolveRequest(rid=10 * i + j, b=b))
    t0 = time.perf_counter()
    results = server.run()
    dt = time.perf_counter() - t0
    ticks = sum(b.iterations_run for b in server.buckets.values())
    print(f"{len(results)} solves in {dt:.2f}s "
          f"({ticks} batched iterations across {len(server.buckets)} buckets)")
    for rid in sorted(results):
        r = results[rid]
        print(f"  rid={rid} lattice={r.x.lattice} iters={r.iterations} "
              f"residual={r.residual:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=32,
                    help="LM: tokens to generate; --solve: max_iter")
    ap.add_argument("--smoke-arch", action="store_true")
    ap.add_argument("--solve", action="store_true",
                    help="serve batched lattice solves instead of LM decode")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--engine", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--device", default="cuda", help="where the Fields and parameters live")
    ap.add_argument("--refine-every", type=int, default=0,
                    help="reliable-update period of mixed-precision serving: every N "
                         "active iterations a slot's residual is recomputed exactly "
                         "(b - A x) and its search direction restarted; 0 disables")
    ap.add_argument("--plan-policy", default="default", choices=["default", "tuned"],
                    help="lowering-plan policy of the serving launches: 'default' "
                         "heuristics, or 'tuned' picks persisted autotune winners "
                         "(core.tune's table; a miss plans by default)")
    args = ap.parse_args(argv)
    if args.solve:
        _main_solve(args)
    else:
        if args.arch is None:
            ap.error("--arch is required unless --solve is given")
        _main_decode(args)


if __name__ == "__main__":
    main()

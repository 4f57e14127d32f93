"""Ludwig liquid-crystal timestep driver (single device).

One timestep reproduces the paper's kernel decomposition (§2.1.1):

  Order Parameter Gradients   stencil   grad Q, lap Q          [torch ops]
  (molecular field)           local     H(Q, lap Q)            [K3L]
  Chemical Stress             local     sigma(Q, H, grad Q)    [K3L]
  (force)                     stencil   F = div sigma          [torch ops]
  Collision                   local     BGK + Guo forcing      [K5L; K9 tiled]
  Propagation                 stencil   streaming              [K5L; K9 tiled]
  Advection (+ Boundaries)    stencil   upwind div(u Q)        [torch ops]
  LC Update                   local     Beris-Edwards          [K3L]

Site-local stages run through the launch machinery, so the engine
("torch" or "cuda") and the data layout are configuration.  Adjacent
site-local stages are fused LaunchGraphs (molecular field + stress; BE rhs
+ Q update), and the LB half of the step (moments, collision, streaming)
is one stencil graph.  On the "cuda" engine each graph and body below is
registered against its hand-written kernel (``csrc/lb.cu``,
``csrc/ludwig_flat.cu``); the stencils marked "torch ops" are plain torch
ops on both engines, as the JAX package computes them with jnp ops outside
any Pallas kernel.

A shared-memory budget in ``LudwigConfig.target`` (``smem_bytes``, or
``$TARGETDP_TORCH_SMEM_BYTES``) tiles the LB half-step, the step's one
stencil graph, which then runs as K9 (``csrc/lb_tiled.cu``) in the state's
layout, with no driver change beyond the config.

``LudwigConfig.storage`` ("bfloat16", or "float32") runs the LB half-step
under a storage DtypePolicy (compute fp32, accumulate float64): dist and
force are read as stored in that dtype and dist2 and u come back in it; on
"cuda" that is K5L's policy instance, and K9's under a budget.  The carried
state stays fp32.

:func:`tune_step_graphs` autotunes the step's three launch graphs
(``core.tune``) and persists the winners; ``plan_policy="tuned"`` in
``LudwigConfig.target`` then runs them with no driver change.  A winner with
a storage policy writes its fields in bf16; the stages widen them (exactly)
back to the order parameter's dtype where they leave the launch (h, sigma
before the force divergence, q_new), as the LB half-step does for dist2 and
u, so the carried state and every stage input keep their dtype and the
step's later launches keep their table keys.  The JAX package lets bf16
outputs go on through jnp's promotion.

:func:`make_sharded_step` is the step on a decomposed lattice (a rank's
block of a ``lattice.Domain``, one process a rank): halo exchanges, then
the same periodic stencils on the halo'd local arrays and crops, the LB
half-step as the fused graph's ``halo="pre"`` launch (K5LH on "cuda"), or
under ``halo="overlap"`` through ``core.overlap`` (K5LHO a box on "cuda",
dist's and force's exchange beside the interior box), or under ``halo=None``
as the planning layer chooses; its fields are in ``cfg.layout`` (SoA where
the layout does not tile a halo'd block), and under a shared-memory budget
or an explicit plan the half-step's launch tiles, splits or takes the block
view (K9H on "cuda"), bitwise the untiled SoA steps.  Not yet ported:
``run_steps`` (with ``core/schedule.py``, ROADMAP item 21).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import (
    DtypePolicy, Field, LaunchGraph, Layout, SOA, TargetConfig, launch, target_sum,
    tileable_layout,
)
from repro_torch.core import halo as halo_mod
from repro_torch.core import stencil
from repro_torch.core.overlap import overlap_launch
from repro_torch.core.field import resolve_device
from repro_torch.core.fuse import check_pre_rings, register_cuda_graph
from repro_torch.core.plan import plan_tile
from repro_torch.core.target import register_cuda_body
from repro_torch.kernels.lb_collision import ref as lbref
from repro_torch.kernels.lb_collision.ops import collide_kernel
from repro_torch.kernels.lb_propagation import kernel as lbk
from repro_torch.kernels.lb_propagation import ops as prop_ops
from . import gradients as gr
from . import kernel as lck
from . import lc


@dataclasses.dataclass(frozen=True)
class LudwigConfig:
    lattice: Tuple[int, int, int] = (16, 16, 16)
    tau: float = 0.8            # LB relaxation time; nu = cs2 (tau - 1/2)
    a0: float = 0.01            # Landau-de Gennes bulk scale
    gamma: float = 3.0          # effective temperature (>2.7: nematic)
    kappa: float = 0.01         # elastic constant (one-constant approx.)
    gamma_rot: float = 0.3     # rotational diffusion Gamma
    xi: float = 0.7             # flow-aligning parameter
    dt: float = 1.0
    layout: Layout = SOA
    target: TargetConfig = TargetConfig()
    # storage dtype of the fused LB half-step's launch ("" = full
    # precision): distributions are read and written in this dtype, compute
    # stays fp32
    storage: str = ""


def _lb_target(cfg: LudwigConfig) -> TargetConfig:
    """The fused LB launch's config: ``cfg.target`` plus the storage-dtype
    policy when ``cfg.storage`` sets one."""
    if not cfg.storage:
        return cfg.target
    return dataclasses.replace(
        cfg.target, dtypes=DtypePolicy(storage=cfg.storage, compute="float32",
                                       accumulate="float64"))


@dataclasses.dataclass
class LudwigState:
    dist: Field   # (19,) distributions
    q: Field      # (5,)  order parameter


def init_state(cfg: LudwigConfig, seed: int = 0, q_amp: float = 1e-2) -> LudwigState:
    """Equilibrium at rest and a small random Q, on ``cfg.target.device``;
    the same bits as the JAX package's init_state from the same seed."""
    rng = np.random.default_rng(seed)
    nsites = int(np.prod(cfg.lattice))
    dev = resolve_device(cfg.target.device)
    rho = torch.ones((nsites,), dtype=torch.float32, device=dev)
    u = torch.zeros((3, nsites), dtype=torch.float32, device=dev)
    f0 = lbref.equilibrium(rho, u)
    dist = Field.from_canonical("dist", f0, cfg.lattice, cfg.layout)
    q0 = q_amp * rng.normal(size=(5, nsites)).astype(np.float32)
    q = Field.from_numpy("q", q0, cfg.lattice, cfg.layout, device=dev)
    return LudwigState(dist=dist, q=q)


# -- site-local kernel bodies wrapped for core.launch -------------------------------

def _mol_field_body(v, *, a0, gamma, kappa):
    return {"h": lc.molecular_field_chunk(v["q"], v["lapq"], a0=a0, gamma=gamma, kappa=kappa)}


def _stress_body(v, *, kappa, xi):
    return {"sigma": lc.stress_chunk(v["q"], v["h"], v["dq"], kappa=kappa, xi=xi)}


def _be_rhs_body(v, *, gamma_rot, xi):
    return {"rhs": lc.beris_edwards_rhs_chunk(v["q"], v["h"], v["w"], gamma_rot=gamma_rot, xi=xi)}


def _q_update_body(v, *, dt):
    return {"q": lc.q_update_chunk(v["q"], v["rhs"], v["adv"], dt=dt)}


def _moments_body(v):
    rho, u = lbref.moments(v["dist"])
    # half-force velocity correction (consistent with Guo forcing)
    u = u + 0.5 * v["force"] / rho[None, :]
    return {"rho": rho[None, :], "u": u}


def _fed_body(v, *, a0, gamma, kappa):
    return {"fed": lc.free_energy_density_chunk(v["q"], v["dq"], a0=a0, gamma=gamma, kappa=kappa)}


def _mkfield(name: str, arr_nd: torch.Tensor, cfg: LudwigConfig) -> Field:
    lat = tuple(arr_nd.shape[1:])
    return Field.from_canonical(name, arr_nd, lat, tileable_layout(cfg.layout, lat))


# -- stage functions (single device, periodic) ---------------------------------------

def stage_gradients(q_nd: torch.Tensor):
    """Order Parameter Gradients."""
    return gr.grad_central(q_nd), gr.laplacian(q_nd)


# stage stanzas shared by every graph builder below — one definition per
# kernel so the step and the benchmark/test chains cannot drift
def _add_mol_field(g: LaunchGraph, cfg: LudwigConfig) -> LaunchGraph:
    return g.add(_mol_field_body, {"q": "q", "lapq": "lapq"}, {"h": 5},
                 params=dict(a0=cfg.a0, gamma=cfg.gamma, kappa=cfg.kappa))


def _add_stress(g: LaunchGraph, cfg: LudwigConfig) -> LaunchGraph:
    return g.add(_stress_body, {"q": "q", "h": "h", "dq": "dq"}, {"sigma": 9},
                 params=dict(kappa=cfg.kappa, xi=cfg.xi))


def _add_be_rhs(g: LaunchGraph, cfg: LudwigConfig) -> LaunchGraph:
    return g.add(_be_rhs_body, {"q": "q", "h": "h", "w": "w"}, {"rhs": 5},
                 params=dict(gamma_rot=cfg.gamma_rot, xi=cfg.xi))


def _add_q_update(g: LaunchGraph, cfg: LudwigConfig) -> LaunchGraph:
    return g.add(_q_update_body, {"q": "q", "rhs": "rhs", "adv": "adv"},
                 {"q": 5}, rename={"q": "q_new"}, params=dict(dt=cfg.dt))


def chem_stress_graph(cfg: LudwigConfig) -> LaunchGraph:
    """molecular field -> stress as one fused chain (H also materialized:
    the BE update needs it later in the step)."""
    return _add_stress(_add_mol_field(LaunchGraph("ludwig_chem_stress"), cfg), cfg)


def lc_update_graph(cfg: LudwigConfig) -> LaunchGraph:
    """BE rhs -> Q update as one fused chain; rhs is never stored."""
    return _add_q_update(_add_be_rhs(LaunchGraph("ludwig_lc_update"), cfg), cfg)


def lc_chain_graph(cfg: LudwigConfig) -> LaunchGraph:
    """The 3-kernel LC chain (molecular field -> BE rhs -> Q update) fused
    into one launch — the benchmarks' fused-vs-unfused exhibit (on "cuda",
    K3C).  Not on the step's path."""
    g = _add_mol_field(LaunchGraph("ludwig_lc_chain"), cfg)
    return _add_q_update(_add_be_rhs(g, cfg), cfg)


def lb_step_graph(cfg: LudwigConfig) -> LaunchGraph:
    """The whole LB half of a timestep — moments, BGK collision and the
    streaming stencil — as one launch: dist and force are read once and
    the post-collision distributions are never stored."""
    return (
        LaunchGraph("ludwig_lb_step")
        .add(_moments_body, {"dist": "dist", "force": "force"},
             {"rho": 1, "u": 3})
        .add(collide_kernel, {"dist": "dist", "force": "force"}, {"dist": 19},
             rename={"dist": "dist1"}, params=dict(tau=cfg.tau))
        .add_stencil(prop_ops.propagate_body, {"dist": "dist1"}, {"dist": 19},
                     width=1, rename={"dist": "dist2"})
    )


def stage_chemical_stress(state_q: Field, dq_nd, lapq_nd, cfg: LudwigConfig):
    """molecular field + stress (one fused launch) + force divergence."""
    out = chem_stress_graph(cfg).bind(
        config=cfg.target, outputs=("h", "sigma"),
    )({"q": state_q, "lapq": _mkfield("lapq", lapq_nd, cfg),
       "dq": _mkfield("dq", dq_nd, cfg)})
    h = out["h"]
    if h.dtype != state_q.dtype:
        h = h.with_data(h.data.to(state_q.dtype))
    force_nd = gr.divergence(out["sigma"].canonical_nd().to(state_q.dtype))
    return h, force_nd


def stage_advection(q_nd, u_nd):
    """Advection (+ periodic boundaries: no correction term)."""
    return gr.advective_divergence(q_nd, u_nd)


def stage_lc_update(state_q: Field, h: Field, w_nd, adv_nd, cfg: LudwigConfig) -> Field:
    q_new = lc_update_graph(cfg).bind(
        config=cfg.target, outputs=("q_new",),
    )({"q": state_q, "h": h, "w": _mkfield("w", w_nd, cfg),
       "adv": _mkfield("adv", adv_nd, cfg)})["q_new"]
    if q_new.dtype != state_q.dtype:
        q_new = q_new.with_data(q_new.data.to(state_q.dtype))
    # keep the Field name stable across steps
    return dataclasses.replace(q_new, name=state_q.name)


def _w_tensor(u_nd: torch.Tensor) -> torch.Tensor:
    """W_ab = d u_a / d x_b as (9,) row-major from grad_central layout."""
    g = gr.grad_central(u_nd)  # [d/dx u(3), d/dy u(3), d/dz u(3)] => g[b*3+a]
    return torch.stack([g[b * 3 + a] for a in range(3) for b in range(3)])


def _lb_half_step(state: LudwigState, force: Field, cfg: LudwigConfig):
    """dist2 and u of the fused LB launch, under ``cfg.storage``'s policy;
    dist2 is cast back to the carried dtype (the write already rounded it)
    and u to the order parameter's."""
    lb = lb_step_graph(cfg).bind(config=_lb_target(cfg), outputs=("dist2", "u"))(
        {"dist": state.dist, "force": force})
    dist2, u = lb["dist2"], lb["u"]
    if dist2.dtype != state.dist.dtype:
        dist2 = dist2.with_data(dist2.data.to(state.dist.dtype))
    if u.dtype != state.q.dtype:
        u = u.with_data(u.data.to(state.q.dtype))
    return dataclasses.replace(dist2, name=state.dist.name), u


def step(state: LudwigState, cfg: LudwigConfig) -> LudwigState:
    """One full LC-LB timestep (single device, periodic)."""
    q_nd = state.q.canonical_nd()
    dq_nd, lapq_nd = stage_gradients(q_nd)
    h, force_nd = stage_chemical_stress(state.q, dq_nd, lapq_nd, cfg)
    force = _mkfield("force", force_nd, cfg)

    # moments + collision + streaming fused: one launch, dist and force read
    # once, post-collision dist never stored
    dist2, u = _lb_half_step(state, force, cfg)
    u_nd = u.canonical_nd()
    w_nd = _w_tensor(u_nd)
    adv_nd = stage_advection(q_nd, u_nd)

    q_new = stage_lc_update(state.q, h, w_nd, adv_nd, cfg)
    return LudwigState(dist=dist2, q=q_new)


def step_timed(state: LudwigState, cfg: LudwigConfig) -> Tuple[LudwigState, Dict[str, float]]:
    """One step with each stage timed in seconds on the host clock, the
    device synchronised around every stage (so the stages do not overlap).
    The stage names are the JAX package's, plus ``velocity_gradients``
    (``_w_tensor``), which the reference leaves untimed."""
    dev = state.q.device
    t: Dict[str, float] = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(name, fn, *a):
        sync()
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        t[name] = time.perf_counter() - t0
        return out

    q_nd = state.q.canonical_nd()
    dq_nd, lapq_nd = timed("order_parameter_gradients", stage_gradients, q_nd)
    h, force_nd = timed(
        "chemical_stress", stage_chemical_stress, state.q, dq_nd, lapq_nd, cfg
    )
    force = _mkfield("force", force_nd, cfg)
    dist2, u = timed("lb_step", _lb_half_step, state, force, cfg)
    u_nd = u.canonical_nd()
    w_nd = timed("velocity_gradients", _w_tensor, u_nd)
    adv_nd = timed("advection", stage_advection, q_nd, u_nd)
    q_new = timed("lc_update", stage_lc_update, state.q, h, w_nd, adv_nd, cfg)
    return LudwigState(dist=dist2, q=q_new), t


# -- sharded driver -------------------------------------------------------------------

def make_sharded_step(cfg: LudwigConfig, domain, halo: str = "pre"):
    """Build this rank's sharded step: ``step(dist_local, q_local) ->
    (dist_local, q_local)``, canonical (19, *local_shape) and (5, ...)
    blocks (``domain.scatter``).

    Inside: Q's width-2 exchange and the periodic gradients on the halo'd
    array (each wrap read lands on an exchanged halo, as the exchanges are
    dimension-ordered), the chemical stress at the halo'd lattice, the
    force divergence and crop; then width-1 exchanges of dist and force and
    the fused LB half-step's ``halo="pre"`` launch (the collision
    recomputed on the ring from the neighbours' pre-collision values), u's
    exchange, advection and the Beris-Edwards update on the interior.
    Every site computes what the single-device step computes there, so the
    sharded steps are bitwise the single ones.

    ``halo`` schedules the LB half-step's exchange: "pre" (exchange, then
    the launch), "overlap" (the interior/boundary split of
    ``core.overlap``: dist's and force's exchange beside the interior box)
    or None (the planning layer's choice: the default policy keeps "pre",
    a tuned table may pick "overlap").  All three are bitwise one another."""
    if halo not in (None, "pre", "overlap"):
        raise ValueError(f"halo must be None, 'pre' or 'overlap', got {halo!r}")
    WQ = 2  # q halo: grad/lap (1) + stress divergence (1)
    dec, mesh = domain.decomposed, domain.mesh

    def halo_of(x, w):
        # the halo'd block, exchange(pad(x)): for non-decomposed dims the
        # wrap IS the (local-)periodic halo; decomposed dims' come from the
        # neighbours
        return halo_mod.exchange_padded(x, dec, width=w, mesh=mesh)

    def crop(x, w):
        return stencil.interior(x, w, (1, 2, 3))

    def mk(name, arr):
        return _mkfield(name, arr, cfg)

    tgt = cfg.target
    chem_step = chem_stress_graph(cfg).bind(config=tgt, outputs=("h", "sigma"))
    lb_graph = lb_step_graph(cfg)
    lc_step = lc_update_graph(cfg).bind(config=tgt, outputs=("q_new",))

    def local_step(dist_nd: torch.Tensor, q_nd: torch.Tensor):
        # ---- Q stencils on the width-2 halo
        qh = halo_of(q_nd, WQ)
        cs = chem_step({"q": mk("q", qh), "lapq": mk("lapq", gr.laplacian(qh)),
                        "dq": mk("dq", gr.grad_central(qh))})
        h_nd = crop(cs["h"].canonical_nd().to(q_nd.dtype), WQ)
        # interior force: ring-1 divergence reads ring-2 gradients, which
        # wrap locally, so the true force halo is exchanged below
        force_nd = crop(gr.divergence(cs["sigma"].canonical_nd().to(q_nd.dtype)), WQ)

        # ---- the fused LB half-step on pre-exchanged halos: the
        # pre-collision dist and the force are filled, overlap_launch
        # exchanges them (under "overlap", beside the interior box) and the
        # launch collides the ring too
        lb = overlap_launch(
            lb_graph, {"dist": mk("dist", halo_mod.fill_padded(dist_nd, dec, width=1)),
                       "force": mk("force", halo_mod.fill_padded(force_nd, dec, width=1))},
            decomposed=dec, config=_lb_target(cfg), outputs=("dist2", "u"), halo=halo,
            mesh=mesh)
        dist2_nd = lb["dist2"].canonical_nd().to(dist_nd.dtype)
        u_nd = lb["u"].canonical_nd().to(q_nd.dtype)

        # ---- hydrodynamics: velocity gradients and advection from u's halo
        uh = halo_of(u_nd, 1)
        w_nd = crop(_w_tensor(uh), 1)
        adv_nd = crop(gr.advective_divergence(crop(qh, WQ - 1), uh), 1)

        # ---- Beris-Edwards update on the interior
        q_new = lc_step({"q": mk("q", q_nd), "h": mk("h", h_nd), "w": mk("w", w_nd),
                         "adv": mk("adv", adv_nd)})["q_new"]
        return dist2_nd, q_new.canonical_nd().to(q_nd.dtype)

    return local_step


# -- plan autotuning -------------------------------------------------------------------

def tune_step_graphs(cfg: LudwigConfig, state: LudwigState, **tune_kw):
    """Autotune every launch graph a timestep runs (the chem-stress chain,
    the fused LB half-step, the LC update chain) and persist the winners,
    so that a later run with ``cfg.target.plan_policy="tuned"`` (the same
    driver code) picks them up from the table: the paper's §3.2.2
    per-architecture tuning as a layer, not an edit.

    Returns {graph name: (plan, info)} from ``core.tune.autotune_graph``; a
    warm table returns each at once (``info["cached"]``)."""
    from repro_torch.core import tune

    q_nd = state.q.canonical_nd()
    dq_nd, lapq_nd = stage_gradients(q_nd)
    results = {}
    g = chem_stress_graph(cfg)
    results[g.name] = tune.autotune_graph(
        g, {"q": state.q, "lapq": _mkfield("lapq", lapq_nd, cfg),
            "dq": _mkfield("dq", dq_nd, cfg)},
        config=cfg.target, outputs=("h", "sigma"), **tune_kw)
    h, force_nd = stage_chemical_stress(state.q, dq_nd, lapq_nd, cfg)
    force = _mkfield("force", force_nd, cfg)
    g = lb_step_graph(cfg)
    results[g.name] = tune.autotune_graph(g, {"dist": state.dist, "force": force},
                                          config=cfg.target, outputs=("dist2", "u"), **tune_kw)
    lb = g.launch({"dist": state.dist, "force": force}, config=cfg.target,
                  outputs=("dist2", "u"))
    u_nd = lb["u"].canonical_nd().to(q_nd.dtype)
    w_nd = _w_tensor(u_nd)
    adv_nd = stage_advection(q_nd, u_nd)
    g = lc_update_graph(cfg)
    results[g.name] = tune.autotune_graph(
        g, {"q": state.q, "h": h, "w": _mkfield("w", w_nd, cfg),
            "adv": _mkfield("adv", adv_nd, cfg)},
        config=cfg.target, outputs=("q_new",), **tune_kw)
    return results


# -- diagnostics ---------------------------------------------------------------------

def diagnostics(state: LudwigState, cfg: LudwigConfig) -> Dict[str, torch.Tensor]:
    """Total mass, momentum, free energy (targetDP reduction API), each a
    tensor on the state's device."""
    mass = target_sum(state.dist, cfg.target).sum()
    q_nd = state.q.canonical_nd()
    dq_nd = gr.grad_central(q_nd)
    dq = _mkfield("dq", dq_nd, cfg)
    fed = launch(
        _fed_body, {"q": state.q, "dq": dq}, {"fed": 1},
        config=cfg.target,
        params=dict(a0=cfg.a0, gamma=cfg.gamma, kappa=cfg.kappa),
    )["fed"]
    free_energy = target_sum(fed, cfg.target)[0]
    rho, u = lbref.moments(state.dist.canonical())
    mom = torch.sum(rho[None] * u, dim=1)
    return {"mass": mass, "free_energy": free_energy, "momentum": mom}


# -- the hand-written kernels behind these bodies and graphs on "cuda" -----------------
#
# Each impl hands its kernel the input tensors with their layouts and the
# output layouts; the kernel writes each output in its layout.

def _split(ins, out_layouts):
    """(tensors, layouts) of an impl's inputs, the outputs' layouts added."""
    lays = {n: lay for n, (_, lay) in ins.items()}
    lays.update(out_layouts)
    return {n: t for n, (t, _) in ins.items()}, lays


def _chem_stress_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts, policy=None):
    # policy: K3L's policy instance (bf16 storage; the graph has no sums)
    mol, stress = graph.stage_params()
    t, lays = _split(ins, out_layouts)
    h, sigma = lck.chem_stress_cuda(
        t["q"], t["lapq"], t["dq"], a0=mol["a0"], gamma=mol["gamma"],
        kappa_m=mol["kappa"], kappa_s=stress["kappa"], xi=stress["xi"], vvl=vvl,
        layouts=lays, policy=policy)
    return {"h": h, "sigma": sigma}


def _lc_update_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts, policy=None):
    # policy: K3L's policy instance (bf16 storage; the graph has no sums)
    be, upd = graph.stage_params()
    t, lays = _split(ins, out_layouts)
    q_new = lck.lc_update_cuda(t["q"], t["h"], t["w"], t["adv"],
                               gamma_rot=be["gamma_rot"], xi=be["xi"], dt=upd["dt"],
                               vvl=vvl, layouts=lays, policy=policy)
    return {"q_new": q_new}


def _lb_step_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts, policy=None):
    # policy: a bf16 storage runs K5L's policy instance; the graph has no sums
    tau = graph.stage_params()[1]["tau"]
    t, lays = _split(ins, out_layouts)
    dist2, u = lbk.lb_step_cuda(t["dist"], t["force"], tau, lattice, vvl,
                                with_u="u" in out_layouts, layouts=lays,
                                bf16=bool(policy and policy.bf16))
    return {"dist2": dist2, "u": u}


def _lc_chain_cuda(graph, ins, scalars, *, lattice, vvl, out_layouts):
    mol, be, upd = graph.stage_params()
    t, lays = _split(ins, out_layouts)
    q_new = lck.lc_chain_cuda(t["q"], t["lapq"], t["w"], t["adv"], a0=mol["a0"],
                              gamma=mol["gamma"], kappa=mol["kappa"],
                              gamma_rot=be["gamma_rot"], xi=be["xi"], dt=upd["dt"], vvl=vvl,
                              layouts=lays)
    return {"q_new": q_new}


def _lb_step_tiled_cuda(graph, ins, scalars, *, lattice, plan, out_layouts, policy=None):
    # policy: a bf16 storage runs K9's policy instance
    tau = graph.stage_params()[1]["tau"]
    t, lays = _split(ins, out_layouts)
    dist2, u = lbk.lb_step_tiled_cuda(t["dist"], t["force"], tau, lattice,
                                      (plan.bx, plan.by, plan.bz), with_u="u" in out_layouts,
                                      layouts=lays, bf16=bool(policy and policy.bf16))
    return {"dist2": dist2, "u": u}


def _lb_step_pre_cuda(graph, ins, scalars, *, lattice, rings, plan, out_layouts):
    # K5LH (K9H under a tiled plan or off SoA): dist2 and u on the interior
    # from dist and force padded by 1, in their layouts
    check_pre_rings(graph, rings, {"dist": 1, "force": 1})
    t, lays = _split(ins, out_layouts)
    dist2, u = lbk.lb_step_pre_cuda(t["dist"], t["force"], graph.stage_params()[1]["tau"],
                                    lattice, plan.vvl, with_u="u" in out_layouts,
                                    tile=plan_tile(plan), layouts=lays)
    return {"dist2": dist2, "u": u}


def _lb_step_box_cuda(graph, ins, scalars, *, lattice, rings, vvls, tiles, part, interior, boxes,
                      outs, out_layouts, scratch):
    # K5LHO (K9H under a box's tile or off SoA): dist2 and u on each box of
    # the call, one launch a box, into the whole interior's
    check_pre_rings(graph, rings, {"dist": 1, "force": 1})
    t, lays = _split(ins, out_layouts)
    for (origin, extents), vvl, tile in zip(boxes, vvls, tiles):
        lbk.lb_step_box_cuda(t["dist"], t["force"], graph.stage_params()[1]["tau"], lattice,
                             origin, extents, outs["dist2"], outs.get("u"), vvl, tile=tile,
                             layouts=lays)


def _fed_cuda(ins, params, vvl, out_layouts):
    t, lays = _split(ins, out_layouts)
    return {"fed": lck.fed_cuda(t["q"], t["dq"], a0=params["a0"], gamma=params["gamma"],
                                kappa=params["kappa"], vvl=vvl, layouts=lays)}


register_cuda_graph(chem_stress_graph(LudwigConfig()), _chem_stress_cuda, ("h", "sigma"),
                    policy=True)
register_cuda_graph(lc_update_graph(LudwigConfig()), _lc_update_cuda, ("q_new",), policy=True)
register_cuda_graph(lc_chain_graph(LudwigConfig()), _lc_chain_cuda, ("q_new",))
register_cuda_graph(lb_step_graph(LudwigConfig()), _lb_step_cuda, ("dist2", "u"),
                    tiled=_lb_step_tiled_cuda, policy=True, pre=_lb_step_pre_cuda,
                    box=_lb_step_box_cuda, pre_layouts=True)
register_cuda_body(_fed_body, _fed_cuda)

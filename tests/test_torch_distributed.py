"""The port's decomposed lattice on several ranks: gloo ranks spawned on the
CPU (``torch.multiprocessing.spawn``, rendezvous through a file under the
test's temporary directory, so that parallel test workers never share a
port), one process a rank, each on its block of the lattice.

Held against (tolerances stated where used): ``np.roll`` of the global
array for the exchange on a 2 x 2 mesh (bitwise, edges and corners); the
port's own single-device ``step`` on the torch engine for 3 sharded Ludwig
steps (bitwise) and the JAX package's ``step`` (its test_distributed
tolerance); the JAX package's ``solve`` for the sharded MILC solve under
``halo=None`` and ``"pre"``, and its ``cg_refined`` for the refined solve
on the sharded operator (iterations +-1, x within rel-L2 1e-5); the
comms/compute overlap schedule (``halo="overlap"``) bitwise "pre", for 3
Ludwig steps at (8, 8, 8) (and the planned ``halo=None``) and the MILC
solve at (10, 10, 4, 4), whose blocks leave a real interior for ring 2
on every mesh, that solve also against the JAX package's (iterations
+-1, x within rel-L2 1e-5); the sharded plans on the cuda engine's
planning (CPU fields, the kernels' plain versions): 3 Ludwig steps under
a shared-memory budget that tiles the LB half-step and in aosoa(4) under
the block view, bitwise the untiled SoA steps (bitwise the single-device
step), and the "pre" solve under the budget at the unbudgeted one's
iterations, x bitwise; on the torch engine the steps and the "pre" solve
under a 227 KiB budget in aosoa(4), bitwise its SoA "pre" runs; its
production mesh, ``batch_axes`` and
``dp_size`` for the port's.  One
rank runs in this process (a mesh of one rank starts no process group);
2 and 4 ranks run once each, every case in one spawn, the results saved by
rank 0.
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.apps.ludwig import LudwigConfig, init_state, step  # noqa: E402
from repro_torch.apps.ludwig.driver import make_sharded_step  # noqa: E402
from repro_torch.apps.milc import MilcConfig, init_problem  # noqa: E402
from repro_torch.apps.milc import cg as PCG  # noqa: E402
from repro_torch.apps.milc.driver import make_domain, make_sharded_solver  # noqa: E402
from repro_torch.core import Field, LoweringPlan, TargetConfig, aosoa  # noqa: E402
from repro_torch.core import halo as halo_mod  # noqa: E402
from repro_torch.core.stencil import halo_pad  # noqa: E402
from repro_torch.lattice import Domain  # noqa: E402
from repro_torch.kernels.wilson_dslash import dslash_halo  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

TORCH = TargetConfig("torch", device="cpu")
LUDWIG_LAT, LUDWIG_STEPS = (8, 8, 8), 3
MILC_LAT, MILC_KAPPA = (8, 4, 4, 4), 0.10
# the overlap cases' MILC lattice: blocks of (5, 5, 4, 4) on the 2 x 2 mesh
# keep an interior of (1, 1, 4, 4) for the operator's ring 2
OVERLAP_MILC_LAT = (10, 10, 4, 4)
# the JAX package's tests/test_distributed.py tolerance for sharded steps
STEP_RTOL, STEP_ATOL = 5e-5, 1e-7
MILC_REL_X = 1e-5
REFINE_K = 5   # the refined solve's inner cap: several restarts at MILC_LAT
# each world's mesh: its shape and axis names; the lattice's first dims
# map to the axes in order
MESHES = {1: ((1,), ("mx",)), 2: ((2,), ("mx",)), 4: ((2, 2), ("mx", "my"))}
# the sharded plans' cases: the cuda engine's planning on CPU fields, whose
# kernel wrappers run their plain versions; a shared-memory budget that
# tiles the LB half-step's "pre" launch on every world's block ((1, 2, 4),
# (1, 2, 4) and (2, 1, 4) tiles) and wilson_normal's ((1, 1, 1))
CUDA_CPU = TargetConfig("cuda", device="cpu", vvl=64)
PLAN_BUDGET = 16384
BLOCK_PLAN = LoweringPlan("cuda", vvl=64, bx=1, view="block")


@contextlib.contextmanager
def _device_check_lifted():
    """The cuda engine's device check lifted in every module that makes it,
    restored on exit (world 1 runs in the test's own process)."""
    from repro_torch.core import fuse, reduce, target
    from repro_torch.kernels.lb_collision import ops as k7ops
    from repro_torch.kernels.lb_propagation import ops as k8ops
    from repro_torch.kernels.wilson_dslash import ops as k4ops

    mods = (fuse, reduce, target, k7ops, k8ops, k4ops)
    saved = [m.require_cuda for m in mods]
    for m in mods:
        m.require_cuda = lambda *a, **k: None
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.require_cuda = f


def _dim_axes(names, ndim):
    return tuple(names) + (None,) * (ndim - len(names))


def _refined_solve(mc: MilcConfig, dom: Domain, ul, bl):
    """``cg_refined`` on this rank's block: the sharded operator (an
    exchange and ``dslash_halo`` a dslash), every sum over the mesh
    (``psum_axes``); (x assembled, iterations, residual)."""
    tgt, mesh = mc.target, dom.mesh
    axes = tuple(ax for _, ax, _ in dom.decomposed)

    def halo(x):
        return dom.exchange(halo_pad(x, 1, range(1, x.dim())))

    def field(name, arr):
        return Field.from_canonical(name, arr, tuple(arr.shape[1:]))

    u_h = halo(ul)

    def dslash_fn(psi):
        out = dslash_halo(halo(psi.canonical_nd()), u_h, config=tgt, width=1)
        return psi.with_canonical(out.reshape(psi.ncomp, -1))

    _, apply_mdag, apply_normal = PCG.make_wilson_op(field("u", ul), mc.kappa, tgt,
                                                     dslash_fn=dslash_fn)

    def apply_a_dot(p):
        ap = apply_normal(p)
        return ap, PCG.dot(p, ap, tgt)

    res = PCG.cg_refined(apply_a_dot, apply_mdag(field("b", bl)), config=tgt, tol=mc.tol,
                         max_iter=mc.max_iter, refine_k=REFINE_K, psum_axes=axes, mesh=mesh)
    return dom.gather(res.x.canonical_nd()), int(res.iterations), float(res.residual)


def _cases(mesh: Mesh) -> dict:
    """Every case on this rank's block; the global results (on every rank)."""
    names = mesh.axis_names
    out = {}
    # the exchange against the global periodic pad, edges and corners
    x = torch.arange(3 * 8 * 8 * 8, dtype=torch.float32).reshape(3, 8, 8, 8)
    dom = Domain((8, 8, 8), mesh, _dim_axes(names, 3), halo=1)
    xh = dom.exchange(halo_pad(dom.scatter(x), 1, (1, 2, 3)))
    block = dom._block(mesh.coords)
    want = halo_pad(x, 1, (1, 2, 3))[(slice(None),) + tuple(
        slice(s.start, s.stop + 2) if s.start is not None else slice(None) for s in block[1:])]
    assert torch.equal(xh, want), f"rank {mesh.rank}: exchanged halos differ from the wrap"
    # the halo'd window shifted by +1 in x, assembled: np.roll's (the reference's test)
    out["roll"] = dom.gather(xh[:, :-2, 1:-1, 1:-1].contiguous())

    cfg = LudwigConfig(lattice=LUDWIG_LAT, target=TORCH)
    st = init_state(cfg, seed=0)
    dom = Domain(cfg.lattice, mesh, _dim_axes(names, 3), halo=2)
    sstep = make_sharded_step(cfg, dom)
    d, q = dom.scatter(st.dist.canonical_nd()), dom.scatter(st.q.canonical_nd())
    for _ in range(LUDWIG_STEPS):
        d, q = sstep(d, q)
    out["ludwig"] = (dom.gather(d), dom.gather(q))
    for halo in ("overlap", None):
        sstep = make_sharded_step(cfg, dom, halo)
        d, q = dom.scatter(st.dist.canonical_nd()), dom.scatter(st.q.canonical_nd())
        for _ in range(LUDWIG_STEPS):
            d, q = sstep(d, q)
        out[("ludwig", halo)] = (dom.gather(d), dom.gather(q))

    mc = MilcConfig(lattice=MILC_LAT, kappa=MILC_KAPPA, tol=1e-10, max_iter=2000, target=TORCH)
    u, b = init_problem(mc, seed=0)
    dom = make_domain(mc, mesh, _dim_axes(names, 4))
    ul, bl = dom.scatter(u.canonical_nd()), dom.scatter(b.canonical_nd())
    for halo in (None, "pre"):
        xl, it, res = make_sharded_solver(mc, dom, halo)(ul, bl)
        out[("milc", halo)] = (dom.gather(xl), int(it), float(res))
    out["refined"] = _refined_solve(mc, dom, ul, bl)

    mc = dataclasses.replace(mc, lattice=OVERLAP_MILC_LAT)
    u, b = init_problem(mc, seed=0)
    dom = make_domain(mc, mesh, _dim_axes(names, 4))
    ul, bl = dom.scatter(u.canonical_nd()), dom.scatter(b.canonical_nd())
    for halo in ("pre", "overlap"):
        xl, it, res = make_sharded_solver(mc, dom, halo)(ul, bl)
        out[("milc_wide", halo)] = (dom.gather(xl), int(it), float(res))
    out.update(_plan_cases(mesh))
    return out


def _plan_cases(mesh: Mesh) -> dict:
    """The sharded plans on the cuda engine's planning (CPU fields): 3
    Ludwig steps untiled in SoA, under PLAN_BUDGET and in aosoa(4) under
    the block view; the "pre" solve at MILC_LAT without and under the
    budget.  On the torch engine: the steps and the "pre" solve under the
    227 KiB budget in aosoa(4)."""
    names = mesh.axis_names
    out = {}
    torch_a4 = dict(layout=aosoa(4), target=dataclasses.replace(TORCH, smem_bytes=227 * 1024))
    cfg = LudwigConfig(lattice=LUDWIG_LAT, target=TORCH)
    st = init_state(cfg, seed=0)
    dom = Domain(LUDWIG_LAT, mesh, _dim_axes(names, 3), halo=2)
    sstep = make_sharded_step(dataclasses.replace(cfg, **torch_a4), dom, "pre")
    d, q = dom.scatter(st.dist.canonical_nd()), dom.scatter(st.q.canonical_nd())
    for _ in range(LUDWIG_STEPS):
        d, q = sstep(d, q)
    out[("ludwig_plan", "torch_aosoa4_budget")] = (dom.gather(d), dom.gather(q))
    mc = MilcConfig(lattice=MILC_LAT, kappa=MILC_KAPPA, tol=1e-10, max_iter=2000, target=TORCH)
    u, b = init_problem(mc, seed=0)
    dom = make_domain(mc, mesh, _dim_axes(names, 4))
    xl, it, res = make_sharded_solver(dataclasses.replace(mc, **torch_a4), dom, "pre")(
        dom.scatter(u.canonical_nd()), dom.scatter(b.canonical_nd()))
    out[("milc_plan", "torch_aosoa4_budget")] = (dom.gather(xl), int(it), float(res))
    with _device_check_lifted():
        base = LudwigConfig(lattice=LUDWIG_LAT, target=CUDA_CPU)
        st = init_state(LudwigConfig(lattice=LUDWIG_LAT, target=TORCH), seed=0)
        dom = Domain(LUDWIG_LAT, mesh, _dim_axes(names, 3), halo=2)
        for key, cfg in (
                ("soa", base),
                ("budget", dataclasses.replace(
                    base, target=dataclasses.replace(CUDA_CPU, smem_bytes=PLAN_BUDGET))),
                ("aosoa4_block", dataclasses.replace(
                    base, layout=aosoa(4),
                    target=dataclasses.replace(CUDA_CPU, plan_policy=BLOCK_PLAN)))):
            sstep = make_sharded_step(cfg, dom, "pre")
            d, q = dom.scatter(st.dist.canonical_nd()), dom.scatter(st.q.canonical_nd())
            for _ in range(LUDWIG_STEPS):
                d, q = sstep(d, q)
            out[("ludwig_plan", key)] = (dom.gather(d), dom.gather(q))
        mc = MilcConfig(lattice=MILC_LAT, kappa=MILC_KAPPA, tol=1e-10, max_iter=2000,
                        target=CUDA_CPU)
        u, b = init_problem(dataclasses.replace(mc, target=TORCH), seed=0)
        dom = make_domain(mc, mesh, _dim_axes(names, 4))
        ul, bl = dom.scatter(u.canonical_nd()), dom.scatter(b.canonical_nd())
        for key, m in (("unbudgeted", mc), ("budget", dataclasses.replace(
                mc, target=dataclasses.replace(CUDA_CPU, smem_bytes=PLAN_BUDGET)))):
            xl, it, res = make_sharded_solver(m, dom, "pre")(ul, bl)
            out[("milc_plan", key)] = (dom.gather(xl), int(it), float(res))
    return out


def _rank_main(rank: int, world: int, init_file: str, out_file: str) -> None:
    torch.set_num_threads(1)
    shape, names = MESHES[world]
    mesh = Mesh(shape, names, rank=rank, world_size=world, local_rank=0, device="cpu",
                init_method=f"file://{init_file}")
    try:
        out = _cases(mesh)
        if rank == 0:
            torch.save(out, out_file)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> that world's results, each world run once."""
    done = {}

    def get(world):
        if world not in done:
            if world == 1:
                shape, names = MESHES[1]
                done[1] = _cases(Mesh(shape, names, rank=0, world_size=1, local_rank=0,
                                       device="cpu"))
            else:
                d = tmp_path_factory.mktemp(f"ranks{world}")
                out_file = os.path.join(d, "out.pt")
                mp.spawn(_rank_main, args=(world, os.path.join(d, "rendezvous"), out_file),
                         nprocs=world, join=True)
                done[world] = torch.load(out_file)
        return done[world]
    return get


@pytest.fixture(scope="module")
def single_steps():
    """The port's own single-device steps on the torch engine and the JAX
    package's, from the same state."""
    import jax
    from repro.apps.ludwig import LudwigConfig as JLudwigConfig
    from repro.apps.ludwig import driver as JD
    from repro.core import TargetConfig as JTC

    cfg = LudwigConfig(lattice=LUDWIG_LAT, target=TORCH)
    s = init_state(cfg, seed=0)
    jcfg = JLudwigConfig(lattice=LUDWIG_LAT, target=JTC("jnp"))
    js = JD.init_state(jcfg, seed=0)
    jstep = jax.jit(JD.step, static_argnums=1)
    for _ in range(LUDWIG_STEPS):
        s = step(s, cfg)
        js = jstep(js, jcfg)
    return ((s.dist.canonical_nd(), s.q.canonical_nd()),
            (np.asarray(js.dist.to_numpy()), np.asarray(js.q.to_numpy())))


@pytest.fixture(scope="module")
def reference_solve():
    """The JAX package's solve: (x canonical-nd, iterations)."""
    from repro.apps.milc import MilcConfig as JMilcConfig
    from repro.apps.milc import init_problem as j_init_problem
    from repro.apps.milc import solve as j_solve

    jc = JMilcConfig(lattice=MILC_LAT, kappa=MILC_KAPPA, tol=1e-10, max_iter=2000)
    u, b = j_init_problem(jc, seed=0)
    res = j_solve(jc, u, b)
    return np.asarray(res.x.to_numpy()).reshape((24,) + MILC_LAT), int(res.iterations)


@pytest.fixture(scope="module")
def reference_solve_wide():
    """The JAX package's solve at the overlap cases' lattice."""
    from repro.apps.milc import MilcConfig as JMilcConfig
    from repro.apps.milc import init_problem as j_init_problem
    from repro.apps.milc import solve as j_solve

    jc = JMilcConfig(lattice=OVERLAP_MILC_LAT, kappa=MILC_KAPPA, tol=1e-10, max_iter=2000)
    u, b = j_init_problem(jc, seed=0)
    res = j_solve(jc, u, b)
    return (np.asarray(res.x.to_numpy()).reshape((24,) + OVERLAP_MILC_LAT),
            int(res.iterations))


@pytest.fixture(scope="module")
def reference_refined():
    """The JAX package's ``cg_refined`` on its fused normal operator, at
    REFINE_K: (x canonical-nd, iterations)."""
    from repro.apps.milc import MilcConfig as JMilcConfig
    from repro.apps.milc import cg as JCG
    from repro.apps.milc import init_problem as j_init_problem

    jc = JMilcConfig(lattice=MILC_LAT, kappa=MILC_KAPPA, tol=1e-10, max_iter=2000)
    u, b = j_init_problem(jc, seed=0)
    _, apply_mdag, _ = JCG.make_wilson_op(u, jc.kappa, jc.target)
    res = JCG.cg_refined(JCG.make_fused_normal(u, jc.kappa, jc.target), apply_mdag(b),
                         config=jc.target, tol=jc.tol, max_iter=jc.max_iter, refine_k=REFINE_K)
    return np.asarray(res.x.to_numpy()).reshape((24,) + MILC_LAT), int(res.iterations)


def test_exchange_on_a_2x2_mesh_matches_the_periodic_roll(runs):
    """4 ranks on a 2 x 2 mesh: every rank's exchanged halos equal the
    global periodic pad's (checked on each rank), and the halo'd window
    shifted by +1 in x, assembled, is np.roll of the global array,
    bitwise (the JAX package's tests/test_distributed.py:33-56)."""
    x = np.arange(3 * 8 * 8 * 8, dtype=np.float32).reshape(3, 8, 8, 8)
    np.testing.assert_array_equal(runs(4)["roll"].numpy(), np.roll(x, 1, axis=1))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_ludwig_steps_equal_the_single_device_step(runs, single_steps, world):
    """3 sharded steps at (8, 8, 8): bitwise the port's own single-device
    step (every site computes what it computes there), and within the
    reference's rtol 5e-5, atol 1e-7 of the JAX package's step."""
    d, q = runs(world)["ludwig"]
    (pd, pq), (jd, jq) = single_steps
    assert torch.equal(d, pd) and torch.equal(q, pq)
    np.testing.assert_allclose(d.numpy(), jd, rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_allclose(q.numpy(), jq, rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("halo", [None, "pre"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_milc_solve_matches_the_reference(runs, reference_solve, world, halo):
    """The sharded solve at (8, 4, 4, 4), kappa 0.10: the JAX package's
    solve's iteration count +-1, x within rel-L2 1e-5; every rank's
    iteration count and residual are the same (they were all-reduced)."""
    x, it, res = runs(world)[("milc", halo)]
    jx, jit_ = reference_solve
    assert abs(it - jit_) <= 1, (it, jit_)
    rel = np.linalg.norm(x.numpy() - jx) / np.linalg.norm(jx)
    assert rel < MILC_REL_X, rel
    assert res <= 1e-10


@pytest.mark.parametrize("halo", ["overlap", None])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_ludwig_steps_under_the_overlap_schedule(runs, world, halo):
    """3 sharded steps at (8, 8, 8) with the LB half-step under "overlap"
    (the split, the exchange between its interior and boundary boxes) and
    under the planned choice (the default policy: "pre"): bitwise the
    "pre" steps, which are bitwise the single-device step."""
    d, q = runs(world)[("ludwig", halo)]
    pd, pq = runs(world)["ludwig"]
    assert torch.equal(d, pd) and torch.equal(q, pq)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_milc_solve_under_the_overlap_schedule(runs, reference_solve_wide, world):
    """The sharded solve at (10, 10, 4, 4) under "overlap": "pre"'s
    iterations and x bitwise (<p, Ap> from the assembled fields), and the
    JAX package's solve's iteration count +-1, x within rel-L2 1e-5."""
    x, it, res = runs(world)[("milc_wide", "overlap")]
    px, pit, pres = runs(world)[("milc_wide", "pre")]
    assert it == pit and res == pres and torch.equal(x, px)
    jx, jit_ = reference_solve_wide
    assert abs(it - jit_) <= 1, (it, jit_)
    rel = np.linalg.norm(x.numpy() - jx) / np.linalg.norm(jx)
    assert rel < MILC_REL_X, rel
    assert res <= 1e-10


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_refined_solve_matches_the_reference(runs, reference_refined, world):
    """``cg_refined(psum_axes=, mesh=)`` on the sharded operator at (8, 4,
    4, 4), refine_k 5: the JAX package's ``cg_refined``'s iteration count
    +-1, x within rel-L2 1e-5; the restarts' norms and the inner solves'
    dots are all-reduced, so every rank stops on one iteration."""
    x, it, res = runs(world)["refined"]
    jx, jit_ = reference_refined
    assert abs(it - jit_) <= 1, (it, jit_)
    rel = np.linalg.norm(x.numpy() - jx) / np.linalg.norm(jx)
    assert rel < MILC_REL_X, rel
    assert res <= 1e-10


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_helpers_match_the_reference(monkeypatch, multi_pod):
    """``make_production_mesh``'s axes and sizes, ``batch_axes`` and
    ``dp_size`` are the JAX package's.  Its 256 or 512 ranks are not
    started here: the default process group is made to report that world
    (gloo), so the mesh is built as a rank of it would build it."""
    import types

    from repro.launch import mesh as jmesh

    world = 512 if multi_pod else 256
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda *a: world)
    got = pmesh.make_production_mesh(multi_pod=multi_pod, rank=world - 1, world_size=world,
                                     local_rank=0, device="cpu")
    # the reference's mesh from its own shape and axes (no 256 devices here)
    monkeypatch.setattr(jmesh.compat, "make_mesh", lambda shape, axes: types.SimpleNamespace(
        axis_names=tuple(axes), shape=dict(zip(axes, shape))))
    want = jmesh.make_production_mesh(multi_pod=multi_pod)
    assert got.axis_names == want.axis_names and got.shape == want.shape
    assert got.size == world and got.coords == tuple(n - 1 for n in got.shape.values())
    assert pmesh.batch_axes(got) == jmesh.batch_axes(want)
    assert pmesh.dp_size(got) == jmesh.dp_size(want) == (32 if multi_pod else 16)


def test_one_rank_exchange_goes_through_the_exchange_and_refuses_thin_extents():
    """A mesh of one rank needs no process group; its exchange is the
    self-copy, the periodic wrap; a local extent under 3 x width raises
    the reference's error."""
    mesh = Mesh((1, 1), ("a", "b"), rank=0, world_size=1, local_rank=0, device="cpu")
    assert mesh.group(("a", "b")) is None and mesh.neighbours("a") == (0, 0)
    x = torch.randn(2, 5, 6, generator=torch.Generator().manual_seed(0))
    dom = Domain((5, 6), mesh, ("a", "b"), halo=2)
    got = dom.exchange(dom.add_halo(x))
    assert torch.equal(got, halo_pad(x, 2, (1, 2)))
    assert torch.equal(dom.strip_halo(got), x)
    with pytest.raises(ValueError, match="too thin"):
        halo_mod.exchange_dim(torch.zeros(1, 5), axis_name="a", axis_size=1, dim=1, width=2)
    with pytest.raises(ValueError, match="mesh"):
        halo_mod.exchange_dim(torch.zeros(1, 9), axis_name="a", axis_size=2, dim=1, width=1)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_plans_bitwise_the_untiled_soa_runs(runs, single_steps, world):
    """The cuda engine's planning on CPU fields (the kernels' plain
    versions): 3 sharded Ludwig steps under a budget that tiles the LB
    half-step (K9H's tiled walk) and in aosoa(4) under the block view
    (K9H's addressing), bitwise the untiled SoA steps, which are bitwise the
    single-device step; the "pre" solve under the budget (K5TH) at the
    unbudgeted solve's iterations, x bitwise.  On the torch engine the
    steps and the "pre" solve under the 227 KiB budget in aosoa(4) are
    bitwise its SoA "pre" runs."""
    r = runs(world)
    d, q = r[("ludwig_plan", "soa")]
    (pd, pq), _ = single_steps
    assert torch.equal(d, pd) and torch.equal(q, pq)
    for key in ("budget", "aosoa4_block"):
        kd, kq = r[("ludwig_plan", key)]
        assert torch.equal(kd, d) and torch.equal(kq, q), key
    x, it, res = r[("milc_plan", "unbudgeted")]
    bx, bit, bres = r[("milc_plan", "budget")]
    assert bit == it and bres == res and torch.equal(bx, x)
    assert res <= 1e-10
    # the torch engine under the 227 KiB budget in aosoa(4): bitwise its SoA
    # "pre" steps and solve
    td, tq = r[("ludwig_plan", "torch_aosoa4_budget")]
    sd, sq = r["ludwig"]
    assert torch.equal(td, sd) and torch.equal(tq, sq)
    tx, tit, tres = r[("milc_plan", "torch_aosoa4_budget")]
    px, pit, pres = r[("milc", "pre")]
    assert tit == pit and tres == pres and torch.equal(tx, px)

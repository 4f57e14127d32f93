"""Port parity for batched solve serving: ``driver.solve_batched`` bitwise
against independent solves and held against the JAX package's
``solve_batched``, convergence-mask invariance, the shape-bucketed
``SolveServer`` draining mixed-shape streams bitwise against
``driver.solve``, and the refusals of what is not yet ported.

Ported from tests/test_serve.py; its telemetry test waits for the port's
telemetry (ROADMAP item 20), its generate() tests are covered by
test_torch_lm.py and test_torch_dense.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps.milc import driver as jdriver  # noqa: E402
from repro.apps.milc.cg import make_wilson_op as j_make_wilson_op  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import SOA as JSOA  # noqa: E402
from repro.core import TargetConfig as JTargetConfig  # noqa: E402
from repro_torch.apps.milc import cg as CG  # noqa: E402
from repro_torch.apps.milc import driver, fields  # noqa: E402
from repro_torch.core import SOA, BatchedField, Field, TargetConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import SolveRequest, SolveServer  # noqa: E402
from repro_torch.train.serve_step import build_cg_serve_step  # noqa: E402

LAT = (4, 4, 4, 8)
TORCH = TargetConfig("torch", device="cpu", vvl=128)


def _cfg(lattice=LAT, max_iter=40, target=TORCH):
    return driver.MilcConfig(lattice=lattice, kappa=0.10, tol=1e-8, max_iter=max_iter,
                             layout=SOA, target=target)


def _source_arrays(lat, n, seed0=10):
    return [fields.random_spinor(lat, seed=seed0 + i) for i in range(n)]


def _sources(cfg, n, seed0=10):
    return [Field.from_numpy("b", a, cfg.lattice, cfg.layout)
            for a in _source_arrays(cfg.lattice, n, seed0)]


def _filtered(cfg, u, b, n=6):
    """Spectrally filter a source (repeated normal-operator applications)
    so its CG converges at a different iteration count: the frozen-slot
    path runs while the rest of the batch keeps iterating."""
    _, _, apply_normal = CG.make_wilson_op(u, cfg.kappa, cfg.target)
    for _ in range(n):
        b = apply_normal(b)
    return b.with_data(b.data / torch.linalg.norm(b.data))


@pytest.fixture(scope="module")
def batch3():
    """Three sources (one filtered, one empty) solved batched by the port,
    and the same numpy sources solved batched by the JAX package."""
    cfg = _cfg()
    u, _ = driver.init_problem(cfg, seed=0)
    # the filtered source is made once, by the JAX package, and handed to both
    jcfg = jdriver.MilcConfig(lattice=LAT, kappa=0.10, tol=1e-8, max_iter=40, layout=JSOA,
                              target=JTargetConfig("jnp", vvl=128))
    ju, _ = jdriver.init_problem(jcfg, seed=0)
    arrs = _source_arrays(LAT, 3)
    _, _, j_normal = j_make_wilson_op(ju, jcfg.kappa, jcfg.target)
    jb = JField.from_numpy("b", arrs[1], LAT, JSOA)
    for _ in range(6):
        jb = j_normal(jb)
    arrs[1] = np.asarray(jb.to_numpy() / np.linalg.norm(np.asarray(jb.data)), np.float32)
    arrs[2] = arrs[2] * 0.0
    bs = [Field.from_numpy("b", a, LAT, SOA) for a in arrs]
    res = driver.solve_batched(cfg, u, bs)
    jres = jdriver.solve_batched(jcfg, ju, [JField.from_numpy("b", a, LAT, JSOA) for a in arrs])
    return cfg, u, bs, res, jres


def test_solve_batched_bitwise_vs_independent_solves(batch3):
    """Divergent convergence points (one slot freezes early, one slot is
    empty): every live request's x, iteration count and residual are
    bitwise the dedicated single solve's."""
    cfg, u, bs, res, _ = batch3
    its = res.iterations.tolist()
    assert isinstance(res.x, BatchedField) and res.x.batch == 3
    assert its[1] < its[0], its  # the freeze path actually ran
    assert its[2] == 0 and not res.x.element(2).data.any()
    for i in (0, 1):
        r1 = driver.solve(cfg, u, bs[i])
        assert torch.equal(res.x.element(i).data, r1.x.data)
        assert its[i] == r1.iterations
        assert torch.equal(res.residual[i], r1.residual)
        assert driver.residual_check(cfg, u, bs[i], res.x.element(i)) < 1e-3


def test_solve_batched_matches_reference(batch3):
    """Per slot against the JAX package's solve_batched (jnp engine) on the
    same numpy sources: iterations +-1, x within rel-L2 1e-5; the empty
    slot 0 iterations and x = 0 in both."""
    _, _, _, res, jres = batch3
    jits = np.asarray(jres.iterations).tolist()
    for i, (it, jit) in enumerate(zip(res.iterations.tolist(), jits)):
        assert abs(it - jit) <= 1, (i, it, jit)
    x, jx = res.x.to_numpy(), np.asarray(jres.x.to_numpy())
    for i in (0, 1):
        assert np.linalg.norm(x[i] - jx[i]) / np.linalg.norm(jx[i]) < 1e-5
    assert jits[2] == 0 and not np.any(x[2]) and not np.any(jx[2])


def test_convergence_mask_invariance():
    """A request's trajectory must not depend on its batch neighbours:
    solve the same source next to a fast-converging neighbour and next to
    an empty slot: identical bits both times."""
    cfg = _cfg()
    u, _ = driver.init_problem(cfg, seed=0)
    b0, b1 = _sources(cfg, 2)
    fast = _filtered(cfg, u, b1)
    empty = b1.with_data(b1.data * 0.0)
    r_fast = driver.solve_batched(cfg, u, [b0, fast])
    r_empty = driver.solve_batched(cfg, u, BatchedField.stack([b0, empty]))
    assert torch.equal(r_fast.x.element(0).data, r_empty.x.element(0).data)
    assert int(r_fast.iterations[0]) == int(r_empty.iterations[0])
    assert torch.equal(r_fast.residual[0], r_empty.residual[0])


def _mixed_shape_workload():
    shapes = [LAT, (4, 4, 8, 8)]
    cfgs, us, reqs = {}, {}, []
    for i, lat in enumerate(shapes):
        cfg = _cfg(lattice=lat)
        u, _ = driver.init_problem(cfg, seed=i)
        cfgs[lat], us[lat] = cfg, u
        for j in range(3):
            rid = 10 * i + j
            reqs.append(SolveRequest(rid=rid, b=_sources(cfg, 1, seed0=100 + rid)[0]))
    return shapes, cfgs, us, reqs


def test_scheduler_drains_mixed_shapes_bitwise():
    """A mixed-shape request stream through the bucketed scheduler, more
    requests than slots (so slots drain and refill mid-flight): every
    completed solve is bitwise the dedicated driver.solve result."""
    shapes, cfgs, us, reqs = _mixed_shape_workload()
    server = SolveServer(cfgs[LAT].target, slots=2, tol=cfgs[LAT].tol,
                         max_iter=cfgs[LAT].max_iter)
    for lat in shapes:
        server.register(us[lat], cfgs[lat].kappa)
    for req in sorted(reqs, key=lambda r: r.rid % 10):  # shapes interleaved
        server.submit(req)
    results = server.run()
    assert sorted(results) == sorted(r.rid for r in reqs)
    for req in reqs:
        lat = req.b.lattice
        want = driver.solve(cfgs[lat], us[lat], req.b)
        out = results[req.rid]
        assert torch.equal(out.x.data, want.x.data)
        assert out.iterations == want.iterations
        assert out.residual == float(want.residual)
    # 3 requests through 2 slots: a slot was refilled, so a bucket ran
    # more ticks than its longest solve
    for lat in shapes:
        bucket = server.buckets[lat]
        longest = max(results[r.rid].iterations for r in reqs if r.b.lattice == lat)
        assert bucket.iterations_run > longest and not bucket.busy


def test_serve_step_is_the_batched_iteration():
    """build_cg_serve_step's step, replayed by hand, is cg_batched bitwise."""
    cfg = _cfg()
    u, _ = driver.init_problem(cfg, seed=0)
    _, apply_mdag, _ = CG.make_wilson_op(u, cfg.kappa, cfg.target)
    rhs = BatchedField.stack([apply_mdag(b) for b in _sources(cfg, 2)])
    step = build_cg_serve_step(u, cfg.kappa, cfg.target, tol=cfg.tol, max_iter=cfg.max_iter)
    state = CG.batched_cg_state(rhs, cfg.target)
    while bool(CG.batched_cg_active(state, tol=cfg.tol, max_iter=cfg.max_iter).any()):
        state = step(state)
    ref = CG.cg_batched(CG.make_fused_normal(u, cfg.kappa, cfg.target), rhs, config=cfg.target,
                        tol=cfg.tol, max_iter=cfg.max_iter)
    assert torch.equal(state.x.data, ref.x.data) and torch.equal(state.it, ref.iterations)


def test_scheduler_rejects_unregistered_shape():
    cfg = _cfg()
    server = SolveServer(cfg.target)
    with pytest.raises(KeyError, match="no operator registered"):
        server.submit(SolveRequest(rid=0, b=_sources(cfg, 1)[0]))


def test_what_is_not_yet_ported_raises(monkeypatch, tmp_path, capsys):
    """Mixed-precision serving runs (test_torch_dtype.py holds it to the JAX
    package); what stays unported raises: a policy on the masked update
    chain on the cuda engine (before any device check).  A policy on a
    tiled plan runs K5T's policy instance: it passes the plan checks and
    refuses the CPU fields.  The tuned plan policy is ported (core.tune):
    the CLI serves under it, its batched launches missing the table and
    planning by default (test_torch_tune.py holds the outcomes)."""
    from repro_torch.core import DtypePolicy, LoweringPlan

    cfg = _cfg(lattice=(2, 2, 2, 4))
    u, b = driver.init_problem(cfg, seed=0)
    rhs = BatchedField.stack([b, b])
    normal = CG.make_fused_normal(u, cfg.kappa, cfg.target)
    res = CG.cg_batched(normal, rhs, config=cfg.target, refine_every=5)
    assert torch.equal(res.x.element(0).data, res.x.element(1).data)
    step = build_cg_serve_step(u, cfg.kappa, cfg.target, tol=1e-8, max_iter=10, refine_every=2)
    state = step(CG.batched_cg_state(rhs, cfg.target), rhs)
    assert torch.equal(state.it, torch.tensor([1, 1], dtype=torch.int32))
    bf16 = DtypePolicy(storage="bfloat16", compute="float32", accumulate="float64")
    cuda = TargetConfig("cuda", device="cpu", dtypes=bf16)
    with pytest.raises(ValueError, match="no policy instance.*not yet ported"):
        CG.fused_masked_cg_update(rhs, rhs, rhs, rhs, torch.ones(2), torch.ones(2), cuda)
    tiled = TargetConfig("cuda", device="cpu",
                         plan_policy=LoweringPlan("cuda", vvl=32, bx=1, by=1, dtypes=bf16))
    with pytest.raises(ValueError, match="CUDA device"):
        CG.make_fused_normal(u, cfg.kappa, tiled)(b)
    from repro_torch.core import tune

    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune.json"))
    tune.clear_table_cache()
    tune.reset_stats()
    serve.main(["--solve", "--engine", "torch", "--device", "cpu", "--plan-policy", "tuned",
                "--requests", "2", "--slots", "1", "--steps", "20"])
    assert "2 solves" in capsys.readouterr().out
    assert tune.stats()["lookups"] > 0 and tune.stats()["hits"] == 0


def test_default_engine_is_the_card():
    """Serving defaults to the cuda engine, which refuses CPU fields rather
    than running them in torch ops."""
    cfg = _cfg(lattice=(2, 2, 2, 4))
    u, b = driver.init_problem(cfg, seed=0)
    server = SolveServer(TargetConfig())
    assert server.config.engine == "cuda" and server.config.device == "cuda"
    server.register(u, cfg.kappa)
    server.submit(SolveRequest(rid=0, b=b))
    with pytest.raises(ValueError, match="CUDA device"):
        server.run()
    with pytest.raises(ValueError, match="CUDA device"):
        driver.solve_batched(_cfg(lattice=(2, 2, 2, 4), target=TargetConfig()), u, [b])


def test_serve_cli_solves_on_the_cpu(capsys):
    serve.main(["--solve", "--engine", "torch", "--device", "cpu", "--requests", "2",
                "--slots", "1", "--steps", "40"])
    out = capsys.readouterr().out
    assert "2 solves in" in out and "across 2 buckets" in out
    assert out.count("rid=") == 2

"""Port parity for mixed precision, part two (split from
tests/test_torch_dtype.py so that the driver's per-file test workers share
its time; each file builds one of the two module-scoped refined solves):
Ludwig's bf16 LB storage against full precision and the JAX package's bf16
steps, and refined serving (``solve_batched`` and the ``SolveServer``
drain under the bf16 policy) against the JAX package's ``solve_batched``
and the port's one-slot runs.

The JAX side runs on the jnp engine; inputs are numpy arrays from a
seed."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.apps.ludwig import LudwigConfig as JLudwigConfig  # noqa: E402
from repro.apps.ludwig import driver as JLD  # noqa: E402
from repro.apps.milc import driver as JMD  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig, init_state, step  # noqa: E402
from repro_torch.apps.milc import driver as PMD  # noqa: E402
from repro_torch.apps.milc import fields as PF  # noqa: E402
from repro_torch.core import DtypePolicy, Field, TargetConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import SolveRequest, SolveServer  # noqa: E402

BF16 = DtypePolicy(storage="bfloat16", compute="float32", accumulate="float64")
TORCH = TargetConfig("torch", device="cpu")
MILC_LAT = (4, 4, 4, 8)


def _np(t):
    """A port tensor or Field (bf16 too) as fp32 numpy."""
    if isinstance(t, Field):
        t = t.canonical_nd()
    return t.detach().float().numpy()


def _jnp(a):
    return np.asarray(a.to_numpy() if isinstance(a, JField) else a).astype(np.float32)


def _milc_cfgs(lat=MILC_LAT, **kw):
    cfg = PMD.MilcConfig(lattice=lat, kappa=0.1, tol=1e-10, target=TORCH, **kw)
    jcfg = JMD.MilcConfig(lattice=lat, kappa=0.1, tol=1e-10, target=JTC("jnp", vvl=128), **kw)
    return cfg, jcfg


def test_ludwig_storage_knob_vs_full_precision_and_reference():
    """3 steps at (8, 8, 8): storage float32 bitwise the policy-free steps;
    bfloat16 within 1e-2 rel of full precision, and dist and q within rel-L2
    1e-4 of the JAX package's bf16 steps (measured 0 and 1.1e-8)."""
    lat = (8, 8, 8)
    states = {}
    for storage in ("", "float32", "bfloat16"):
        cfg = LudwigConfig(lattice=lat, target=TORCH, storage=storage)
        s = init_state(cfg, seed=0)
        for _ in range(3):
            s = step(s, cfg)
        states[storage] = s
    ref = states[""]
    for f in ("dist", "q"):
        assert torch.equal(getattr(states["float32"], f).data, getattr(ref, f).data)
        got = getattr(states["bfloat16"], f)
        assert got.data.dtype == torch.float32
        r = _np(getattr(ref, f)).astype(np.float64)
        assert np.linalg.norm(_np(got) - r) / np.linalg.norm(r) < 1e-2
    jcfg = JLudwigConfig(lattice=lat, target=JTC("jnp"), storage="bfloat16")
    js = JLD.init_state(jcfg, seed=0)
    for _ in range(3):
        js = JLD.step(js, jcfg)
    for f in ("dist", "q"):
        got, want = _np(getattr(states["bfloat16"], f)), _jnp(getattr(js, f))
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4, f


@pytest.fixture(scope="module")
def refined_batch():
    """solve_batched with storage bf16 on three sources (one empty) and
    refine_k 10, on both packages; the port's one-slot runs."""
    cfg, jcfg = (dataclasses.replace(c, storage="bfloat16", refine_k=10, max_iter=200)
                 for c in _milc_cfgs())
    u, _ = PMD.init_problem(cfg, seed=0)
    ju, _ = JMD.init_problem(jcfg, seed=0)
    arrs = [PF.random_spinor(MILC_LAT, seed=20 + i) for i in range(3)]
    arrs[2] = arrs[2] * 0.0
    bs = [Field.from_numpy("b", a, MILC_LAT) for a in arrs]
    res = PMD.solve_batched(cfg, u, bs)
    jres = JMD.solve_batched(jcfg, ju, [JField.from_numpy("b", a, MILC_LAT) for a in arrs])
    ones = [PMD.solve_batched(cfg, u, [b]) for b in bs[:2]]
    return cfg, u, bs, res, jres, ones


def test_refined_solve_batched_vs_reference_and_one_slot_runs(refined_batch):
    """Each live slot: iterations within +-2 of the JAX package's
    solve_batched, x within rel-L2 5e-5 of its x, residual_check < 1e-3
    (measured 1.3e-5: the restarts come every 10 iterations, not at the
    end), and bitwise the port's one-slot run of that source; the empty
    slot 0 iterations and x = 0."""
    cfg, u, bs, res, jres, ones = refined_batch
    its, jits = res.iterations.tolist(), np.asarray(jres.iterations).tolist()
    jx = np.asarray(jres.x.to_numpy())
    for i in (0, 1):
        assert abs(its[i] - jits[i]) <= 2, (i, its, jits)
        x = _np(res.x.element(i))
        assert np.linalg.norm(x - jx[i]) / np.linalg.norm(jx[i]) < 5e-5
        assert PMD.residual_check(cfg, u, bs[i], res.x.element(i)) < 1e-3
        assert torch.equal(res.x.element(i).data, ones[i].x.element(0).data)
        assert its[i] == int(ones[i].iterations[0])
        assert torch.equal(res.residual[i], ones[i].residual[0])
    assert its[2] == 0 and not res.x.element(2).data.any()


def test_refined_server_drain_bitwise_one_slot_runs(refined_batch):
    """A SolveServer with the bf16 policy and refine_every 10, 2 slots and
    3 requests (a slot refills mid-flight): every outcome bitwise the
    one-slot solve_batched run of its source; the CLI's --refine-every
    runs on the CPU."""
    cfg, u, bs, _, _, ones = refined_batch
    srv = SolveServer(dataclasses.replace(TORCH, dtypes=BF16), slots=2, tol=cfg.tol,
                      max_iter=cfg.max_iter, refine_every=10)
    srv.register(u, cfg.kappa)
    b3 = Field.from_numpy("b", PF.random_spinor(MILC_LAT, seed=33), MILC_LAT)
    for rid, b in enumerate([bs[0], bs[1], b3]):
        srv.submit(SolveRequest(rid, b))
    out = srv.run()
    want = ones + [PMD.solve_batched(cfg, u, [b3])]
    for rid, w in enumerate(want):
        assert torch.equal(out[rid].x.data, w.x.element(0).data)
        assert out[rid].iterations == int(w.iterations[0])
        assert out[rid].residual == float(w.residual[0])
    serve.main(["--solve", "--engine", "torch", "--device", "cpu", "--requests", "2",
                "--slots", "1", "--steps", "60", "--refine-every", "7"])

"""The plan autotuner on the port (``core.tune``), against the JAX package.

``tests/test_tune.py``'s contracts one for one on the port's torch engine
(sweep -> JSON table -> warm hit with no sweep launch, ``plan_policy=
"tuned"``, tuned == default, the table's robustness), the tuner tests of
``tests/test_dtype.py``, ``test_rsplit.py``, ``test_tile.py``,
``test_view.py``, ``test_plan.py`` and ``test_property.py`` (its hypothesis
properties as parametrised grids), the candidate sets held to the JAX
package's on a grid of configs, lattices, layouts and budgets, the table key
stable across processes, and the MILC and Ludwig drivers' tuners.  The
serve CLI under the tuned policy and the tuned bf16 update-chain winner
against the reference's are in tests/test_torch_tune_serve.py and
tests/test_torch_tune_bf16_update.py.

The torch engine has one candidate, its default plan.  Sweeps of several
candidates run the cuda engine's planning on CPU fields with the device
check lifted (the ``cuda_on_cpu`` fixture): each kernel wrapper then runs
its plain version, the fields' CPU path, so the sweep, the gate and the
launches of every candidate are real and only the device is not."""

import dataclasses
import json
import logging
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import AOS as J_AOS  # noqa: E402
from repro.core import SOA as J_SOA  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import aosoa as j_aosoa  # noqa: E402
from repro.core import plan as JP  # noqa: E402
from repro.core import tune as JT  # noqa: E402
from repro.apps.milc import cg as JCG  # noqa: E402
from repro.apps.ludwig import driver as JLD  # noqa: E402
from repro.apps.ludwig import LudwigConfig as JLudwigConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig, init_state, step  # noqa: E402
from repro_torch.apps.ludwig import driver as PLD  # noqa: E402
from repro_torch.apps.milc import MilcConfig, init_problem, solve  # noqa: E402
from repro_torch.apps.milc import cg as PCG  # noqa: E402
from repro_torch.apps.milc import driver as PMD  # noqa: E402
from repro_torch.core import (AOS, SOA, DtypePolicy, Field, LaunchGraph, LoweringPlan,  # noqa: E402
                              TargetConfig, aosoa)
from repro_torch.core import fuse as PFU  # noqa: E402
from repro_torch.core import plan as PP  # noqa: E402
from repro_torch.core import tune  # noqa: E402
from repro_torch.kernels.lb_propagation.ops import collide_propagate_graph  # noqa: E402

LAT = (4, 4, 8)  # 128 sites, as tests/test_tune.py
TORCH = TargetConfig("torch", device="cpu")
CUDA_ON_CPU = TargetConfig("cuda", device="cpu", vvl=64)
BF16 = DtypePolicy(storage="bfloat16", compute="float32", accumulate="float64")


@pytest.fixture()
def tune_env(tmp_path, monkeypatch):
    """An isolated table per test (the variable is the API)."""
    path = tmp_path / "tune_table.json"
    monkeypatch.setenv(tune.ENV_VAR, str(path))
    monkeypatch.delenv(PP.SMEM_ENV, raising=False)
    tune.clear_table_cache()
    tune.reset_stats()
    yield path
    tune.clear_table_cache()


@pytest.fixture()
def cuda_on_cpu(monkeypatch):
    """The cuda engine's launches on CPU fields: the device check lifted in
    every module that makes it, so each kernel wrapper runs its plain
    version (its CPU path)."""
    from repro_torch.core import reduce as PR
    from repro_torch.core import target as PTG
    from repro_torch.kernels.lb_collision import ops as K7OPS
    from repro_torch.kernels.lb_propagation import ops as K8OPS
    from repro_torch.kernels.wilson_dslash import ops as K4OPS

    for mod in (PFU, PR, PTG, K7OPS, K8OPS, K4OPS):
        monkeypatch.setattr(mod, "require_cuda", lambda *a, **k: None)


def _scale_body(v):
    return {"t": 2.0 * v["x"]}


def _graph():
    return LaunchGraph("tune_probe").add(_scale_body, {"x": "x"}, {"t": 3})


def _field(rng, lay=SOA, ncomp=3, name="x", lat=LAT):
    arr = rng.normal(size=(ncomp, *lat)).astype(np.float32)
    return Field.from_numpy(name, arr, lat, lay)


def _update_ins(rng, lay=SOA):
    """The cg_update graph's four 24-component inputs on LAT."""
    return {n: _field(rng, lay, 24, n) for n in ("x", "r", "p", "ap")}


_UPD = dict(outputs=("x_new", "r_new", "rr"), scalars={"alpha": 0.3, "neg_alpha": -0.3})


# -- tests/test_tune.py on the port ----------------------------------------------------

def test_autotune_sweeps_persists_and_rehits(tune_env, rng):
    """Write the table in one 'process', drop the in-memory cache (what a
    fresh process sees), tune again: a table hit with no sweep launch."""
    fx = _field(rng)
    plan, info = tune.autotune_graph(_graph(), {"x": fx}, config=TORCH, iters=1, warmup=0,
                                     max_candidates=4)
    assert not info["cached"]
    assert tune.stats()["sweep_launches"] > 0
    raw = json.loads(tune_env.read_text())
    assert raw["entries"][info["key"]]["plan"] == plan.to_json()
    assert len(info["timings_us"]) == tune.stats()["sweep_launches"]
    tune.clear_table_cache()
    tune.reset_stats()
    plan2, info2 = tune.autotune_graph(_graph(), {"x": fx}, config=TORCH, iters=1, warmup=0,
                                       max_candidates=4)
    assert info2["cached"] and plan2 == plan
    assert tune.stats()["sweep_launches"] == 0, "a warm table must not sweep again"


def test_plan_policy_tuned_round_trip(tune_env, rng):
    """Tuned launches look the winner up by plan key and give the default
    policy's bits."""
    fx = _field(rng)
    tune.autotune_graph(_graph(), {"x": fx}, config=TORCH, iters=1, warmup=0)
    want = _graph().launch({"x": fx}, config=TORCH)["t"].data
    tune.clear_table_cache()
    tune.reset_stats()
    got = _graph().launch({"x": fx}, config=dataclasses.replace(TORCH, plan_policy="tuned"))
    assert torch.equal(got["t"].data, want)
    s = tune.stats()
    assert s["lookups"] == 1 and s["hits"] == 1 and s["sweep_launches"] == 0, s


def test_plan_policy_tuned_miss_falls_back_to_default(tune_env, rng):
    """A cold table never breaks a launch: a miss plans by default and
    records nothing."""
    fx = _field(rng, aosoa(32))
    out = _graph().launch({"x": fx}, config=dataclasses.replace(TORCH, plan_policy="tuned"))
    assert torch.equal(out["t"].canonical(), 2.0 * fx.canonical())
    s = tune.stats()
    assert s["lookups"] == 1 and s["hits"] == 0, s
    assert not tune_env.exists()


def test_explicit_plan_policy_on_config(rng):
    """plan_policy may be a LoweringPlan: every launch under that config
    runs it; a plan that does not fit the launch raises its validation
    error."""
    fx = _field(rng)
    cfg = TargetConfig("cuda", device="cpu", plan_policy=LoweringPlan("torch"))
    got = _graph().launch({"x": fx}, config=cfg)["t"]
    assert torch.equal(got.canonical(), 2.0 * fx.canonical())
    bad = TargetConfig("cuda", device="cpu", plan_policy=LoweringPlan("cuda", vvl=96))
    with pytest.raises(ValueError, match="must divide nsites"):
        _graph().launch({"x": fx}, config=bad)


def test_scalars_and_stencil_graph_tuning(tune_env, cuda_on_cpu, rng):
    """Tuning covers stencil graphs (the bx sweep, tiles) and graphs with
    runtime scalars; the tuned plan's launch is bitwise the default's, or
    within the accuracy gate where the winner carries a dtype policy."""
    f0 = (1.0 + 0.1 * rng.normal(size=(19, *LAT))).astype(np.float32)
    frc = (0.01 * rng.normal(size=(3, *LAT))).astype(np.float32)
    ins = {"dist": Field.from_numpy("dist", f0, LAT), "force": Field.from_numpy("force", frc, LAT)}
    graph = collide_propagate_graph(0.8)
    cfg = TargetConfig("cuda", device="cpu", vvl=128)
    plan, info = tune.autotune_graph(graph, ins, config=cfg, outputs=("dist2",), iters=1,
                                     warmup=0, max_candidates=3)
    assert plan.bx >= 1 and LAT[0] % plan.bx == 0
    assert not info["failed"], info["failed"]
    # lb_collide_propagate has no policy instance: its dtype twin is rejected
    assert all("baseline raised" in r for r in info["rejected"].values())
    want = graph.launch(ins, config=cfg, outputs=("dist2",))["dist2"]
    got = graph.launch(ins, config=cfg, outputs=("dist2",), plan=plan)["dist2"]
    assert torch.equal(got.data, want.data)
    ins = _update_ins(rng)
    plan, info = tune.autotune_graph(PCG.cg_update_graph(24), ins, config=CUDA_ON_CPU,
                                     iters=1, warmup=0, **_UPD)
    assert not info["failed"] and any("dt=bf16" in d for d in info["timings_us"]), info


def test_stencil_tuned_keys_agree(tune_env, rng):
    """The autotuner keys a stencil launch on the lattice the launch keys on
    (the periodic halo pads inside the launch), so a tuned launch hits the
    table."""
    def lap_body(v, gather):
        return {"z": gather("y", (1, 0, 0)) + gather("y", (-1, 0, 0))}

    g = LaunchGraph("pre_tune").add_stencil(lap_body, {"y": "x"}, {"z": 3}, width=1)
    x = rng.normal(size=(3, *LAT)).astype(np.float32)
    fx = Field.from_numpy("x", x, LAT)
    plan, info = tune.autotune_graph(g, {"x": fx}, config=TORCH, iters=1, warmup=0)
    tune.reset_stats()
    out = g.launch({"x": fx}, config=dataclasses.replace(TORCH, plan_policy="tuned"))["z"]
    assert out.lattice == LAT and tune.stats()["hits"] == 1
    want = np.roll(x, 1, axis=1) + np.roll(x, -1, axis=1)
    np.testing.assert_allclose(out.canonical_nd().numpy(), want, rtol=1e-6)


def test_corrupt_table_yields_empty(tune_env):
    tune_env.write_text("{ not json")
    assert tune.load_table() == {}
    assert tune.lookup("nope") is None


def test_table_is_schema_version_stamped(tune_env, rng):
    fx = _field(rng)
    plan, info = tune.autotune_graph(_graph(), {"x": fx}, config=TORCH, iters=1, warmup=0)
    raw = json.loads(tune_env.read_text())
    assert raw["schema_version"] == tune.SCHEMA_VERSION == JT.SCHEMA_VERSION
    tune.clear_table_cache()
    assert tune.lookup(info["key"]) == plan


def test_unknown_schema_version_degrades_to_misses(tune_env, rng):
    """A table with a missing or unknown schema_version is an empty table:
    lookups miss, tuned launches plan by default, and a new tune sweeps and
    stamps the file again."""
    fx = _field(rng)
    g = _graph()
    key = g.plan_key({"x": fx}, config=TORCH)
    good = {"plan": LoweringPlan("torch").to_json()}
    for stale in ({"version": 1, "entries": {key: good}},
                  {"schema_version": 99, "entries": {key: good}},
                  {"entries": {key: good}}):
        tune_env.write_text(json.dumps(stale))
        tune.clear_table_cache()
        assert tune.load_table() == {}
        assert tune.lookup(key) is None
    out = g.launch({"x": fx}, config=dataclasses.replace(TORCH, plan_policy="tuned"))["t"]
    assert torch.equal(out.canonical(), 2.0 * fx.canonical())
    tune.reset_stats()
    plan, info = tune.autotune_graph(g, {"x": fx}, config=TORCH, iters=1, warmup=0)
    assert not info["cached"] and tune.stats()["sweep_launches"] > 0
    assert json.loads(tune_env.read_text())["schema_version"] == tune.SCHEMA_VERSION


@pytest.mark.parametrize("version,axis", [(2, "rsplit"), (3, "dtypes")])
def test_older_schema_table_is_a_clean_miss(tune_env, rng, version, axis):
    """A version-2 table (before rsplit) and a version-3 one (before the
    dtype policy) are clean misses; a new tune stamps the current version
    with plans that name the axis."""
    fx = _field(rng)
    g = _graph()
    key = g.plan_key({"x": fx}, config=TORCH)
    old_plan = {k: v for k, v in LoweringPlan("torch").to_json().items() if k != axis}
    tune_env.write_text(json.dumps({"schema_version": version,
                                    "entries": {key: {"plan": old_plan}}}))
    tune.clear_table_cache()
    assert tune.load_table() == {} and tune.lookup(key) is None
    tune.reset_stats()
    plan, info = tune.autotune_graph(g, {"x": fx}, config=TORCH, iters=1, warmup=0)
    assert not info["cached"] and tune.stats()["sweep_launches"] > 0
    raw = json.loads(tune_env.read_text())
    assert raw["schema_version"] == tune.SCHEMA_VERSION
    assert axis in raw["entries"][info["key"]]["plan"]


def test_malformed_entry_is_a_miss_not_a_crash(tune_env, rng):
    """Valid JSON with a broken entry (no plan, an unknown engine, a block
    size no card takes) is a miss: tuned launches plan by default."""
    fx = _field(rng)
    cfg = dataclasses.replace(TORCH, plan_policy="tuned")
    g = _graph()
    key = g.plan_key({"x": fx}, config=cfg)
    tune_env.write_text(json.dumps({"schema_version": tune.SCHEMA_VERSION, "entries": {
        key: {"timings_us": {}},
        "other": {"plan": {"engine": "pallas"}},
        "odd": {"plan": {"engine": "cuda", "vvl": 7}}}}))
    tune.clear_table_cache()
    for k in (key, "other", "odd"):
        assert tune.lookup(k) is None
    out = g.launch({"x": fx}, config=cfg)["t"]
    assert torch.equal(out.canonical(), 2.0 * fx.canonical())


def test_sweep_skips_failing_candidates(tune_env, cuda_on_cpu, monkeypatch, rng):
    """A candidate whose launch raises is recorded as failed and skipped; the
    sweep completes and persists a working winner."""
    ins = _update_ins(rng)
    real_launch = LaunchGraph.launch

    def flaky_launch(self, ins, **kw):
        plan = kw.get("plan")
        if plan is not None and plan.vvl == 128:
            raise RuntimeError("out of shared memory")
        return real_launch(self, ins, **kw)

    monkeypatch.setattr(LaunchGraph, "launch", flaky_launch)
    plan, info = tune.autotune_graph(PCG.cg_update_graph(24), ins, config=CUDA_ON_CPU, iters=1,
                                     warmup=0, max_candidates=4, **_UPD)
    assert plan.vvl != 128
    assert any("shared memory" in e for e in info["failed"].values()), info
    entry = json.loads(tune_env.read_text())["entries"][info["key"]]
    assert entry["meta"]["failed"]


def test_min_gain_hysteresis_keeps_default(tune_env, cuda_on_cpu, monkeypatch, rng):
    """A candidate only noisily faster never replaces the default plan; a
    decisively faster one does."""
    ins = _update_ins(rng)

    def fake_sweep(graph, ins, launch_kw, cands, iters, warmup):
        return {c: (100e-6 if i == 0 else 97e-6) for i, c in enumerate(cands)}, {}

    monkeypatch.setattr(tune, "_sweep", fake_sweep)
    g = PCG.cg_update_graph(24)
    plan, info = tune.autotune_graph(g, ins, config=CUDA_ON_CPU, min_gain=0.05, **_UPD)
    assert plan == info["default"], "a 3% gain must not beat 5% hysteresis"

    def fake_sweep2(graph, ins, launch_kw, cands, iters, warmup):
        return {c: (100e-6 if i == 0 else 50e-6) for i, c in enumerate(cands)}, {}

    monkeypatch.setattr(tune, "_sweep", fake_sweep2)
    plan2, info2 = tune.autotune_graph(g, ins, config=CUDA_ON_CPU, min_gain=0.05, force=True,
                                       **_UPD)
    assert plan2 != info2["default"], "a 2x gain must replace the default"


def test_torch_engine_tunes_to_single_candidate(tune_env, rng):
    """The torch engine has no block size to sweep: the set is its default
    plan (still persisted, so the table records every planned launch)."""
    plan, info = tune.autotune_graph(_graph(), {"x": _field(rng)}, config=TORCH, iters=1,
                                     warmup=0)
    assert plan == LoweringPlan("torch") and len(info["timings_us"]) == 1
    assert PP.candidate_plans(TORCH, nsites=64, layouts=[SOA]) == (LoweringPlan("torch"),)


def test_table_roundtrip_across_real_processes(tmp_path):
    """Sweep and persist in one python process, load and hit (no sweep
    launch) in a fresh one; the plan key is the same in both."""
    table = tmp_path / "cross_process.json"
    prog = textwrap.dedent("""
        import json
        import numpy as np
        from repro_torch.apps.milc.cg import cg_update_graph
        from repro_torch.core import Field, LaunchGraph, TargetConfig, tune

        def body(v):
            return {"t": 2.0 * v["x"]}

        lat = (4, 4, 8)
        fx = Field.from_numpy("x", np.ones((3, *lat), np.float32), lat)
        g = LaunchGraph("xproc").add(body, {"x": "x"}, {"t": 3})
        cfg = TargetConfig("torch", device="cpu")
        plan, info = tune.autotune_graph(g, {"x": fx}, config=cfg, iters=1, warmup=0)
        f24 = Field.from_numpy("x", np.ones((24, *lat), np.float32), lat)
        key2 = cg_update_graph(24).plan_key({n: f24 for n in ("x", "r", "p", "ap")},
                                            config=TargetConfig("cuda", device="cpu"))
        print(json.dumps({"cached": info["cached"], "key": info["key"], "key2": key2,
                          "sweeps": tune.stats()["sweep_launches"], "plan": plan.to_json()}))
    """)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, **{tune.ENV_VAR: str(table)})
    outs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    first, second = outs
    assert not first["cached"] and first["sweeps"] > 0
    assert second["cached"] and second["sweeps"] == 0
    assert second["plan"] == first["plan"]
    assert (first["key"], first["key2"]) == (second["key"], second["key2"])
    assert first["key2"].startswith("cg_update|cpu|cuda|")


# -- the accuracy gate (tests/test_dtype.py) ----------------------------------------

def test_tuner_rejects_over_budget_policy_candidates(tune_env, cuda_on_cpu, rng, caplog):
    """A dtype-policy candidate over the gate is rejected, logged, recorded
    in info and the entry's meta, never timed and never the winner."""
    ins = _update_ins(rng)
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.tune"):
        plan, info = tune.autotune_graph(PCG.cg_update_graph(24), ins, config=CUDA_ON_CPU,
                                         iters=1, warmup=0, max_candidates=6,
                                         accuracy_gate=1e-12, **_UPD)
    assert info["rejected"] and any("rel_l2" in r for r in info["rejected"].values())
    assert not plan.dtypes
    assert any("accuracy gate" in r.message for r in caplog.records)
    entry = json.loads(tune_env.read_text())["entries"][info["key"]]
    assert entry["plan"].get("dtypes") is None and entry["meta"]["rejected"]
    assert all("dt=" not in d for d in info["timings_us"])


def test_tuner_passes_policy_candidate_within_gate(tune_env, cuda_on_cpu, rng):
    """Under its default gate the bf16 twin of an update chain passes the
    probe and is timed; so is the twin of each Ludwig flat chain."""
    plan, info = tune.autotune_graph(PCG.cg_update_graph(24), _update_ins(rng),
                                     config=CUDA_ON_CPU, iters=1, warmup=0, max_candidates=6,
                                     **_UPD)
    assert any("dt=bf16" in d for d in info["timings_us"]), info
    assert not info["rejected"]
    cfg = LudwigConfig(lattice=LAT, target=CUDA_ON_CPU)
    st = init_state(dataclasses.replace(cfg, target=TORCH), seed=1)
    q = st.q
    ins = {"q": q, "lapq": _field(rng, ncomp=5, name="lapq", lat=LAT),
           "dq": _field(rng, ncomp=15, name="dq", lat=LAT)}
    plan, info = tune.autotune_graph(PLD.chem_stress_graph(cfg), ins, config=CUDA_ON_CPU,
                                     outputs=("h", "sigma"), iters=1, warmup=0)
    assert any("dt=bf16" in d for d in info["timings_us"]) and not info["rejected"], info


def test_tuned_bf16_winner_drives_refined_solve(tune_env):
    """A recorded bf16-storage winner for the operator drives a MILC solve
    under plan_policy="tuned" (storage bf16: the refined solve) to the
    working tolerance, within 1e-3 of |M x - b| / |b|."""
    cfg = MilcConfig(lattice=(4, 4, 4, 4), kappa=0.08, tol=1e-10, max_iter=200,
                     storage="bfloat16", target=TORCH)
    u, b = init_problem(cfg, seed=0)
    g = PCG.wilson_normal_graph(float(cfg.kappa))
    key = g.plan_key({"p": b, "u": u}, config=TORCH, outputs=("ap", "pap"))
    tune.record(key, LoweringPlan("torch", dtypes=BF16))
    tuned = dataclasses.replace(cfg, target=dataclasses.replace(TORCH, plan_policy="tuned"))
    tune.clear_table_cache()
    tune.reset_stats()
    res = solve(tuned, u, b)
    assert tune.stats()["hits"] > 0
    assert float(res.residual) <= cfg.tol
    assert PMD.residual_check(cfg, u, b, res.x) < 1e-3
    # bitwise the solve with the same policy set on the config
    want = solve(cfg, u, b)
    assert torch.equal(res.x.data, want.x.data) and res.iterations == want.iterations


# -- rsplit (tests/test_rsplit.py) -------------------------------------------------

def test_candidate_rsplit_twins_gated_on_reduce():
    cfg = TargetConfig("cuda", device="cpu", vvl=32)
    with_red = PP.candidate_plans(cfg, nsites=128, layouts=[SOA], reduce=True)
    without = PP.candidate_plans(cfg, nsites=128, layouts=[SOA], reduce=False)
    assert any(c.rsplit > 1 for c in with_red)
    assert all(c.rsplit == 1 for c in without)
    st_red = PP.candidate_plans(cfg, nsites=128, layouts=[SOA], stencil=True, lattice=LAT,
                                reduce=True)
    assert any(c.rsplit > 1 for c in st_red)
    for c in with_red:
        c.validate(nsites=128, layouts=[SOA])
    for c in st_red:
        c.validate(nsites=128, layouts=[SOA], lattice=LAT, stencil=True)


def test_tuned_rsplit_cg_converges_to_default_solution(tune_env, cuda_on_cpu):
    """A persisted rsplit winner for the operator drives the MILC solve under
    plan_policy="tuned" to the default plan's solution within tolerance,
    and the same bits on a second run."""
    tgt = TargetConfig("cuda", device="cpu", vvl=128)
    cfg = MilcConfig(lattice=(4, 4, 4, 4), kappa=0.10, tol=1e-8, max_iter=200, target=tgt)
    u, b = init_problem(dataclasses.replace(cfg, target=TORCH), seed=0)
    g = PCG.wilson_normal_graph(float(cfg.kappa))
    cands = tune.plan_candidates_for(g, {"p": b, "u": u}, config=tgt, outputs=("ap", "pap"))
    split = [c for c in cands if c.rsplit > 1]
    assert split, "a reduce graph's sweep offers rsplit twins"
    key = g.plan_key({"p": b, "u": u}, config=tgt, outputs=("ap", "pap"))
    tune.record(key, split[0])
    tune.clear_table_cache()
    assert tune.lookup(key) == split[0]
    res_default = solve(cfg, u, b)
    tuned_cfg = dataclasses.replace(cfg, target=dataclasses.replace(tgt, plan_policy="tuned"))
    tune.reset_stats()
    res_tuned = solve(tuned_cfg, u, b)
    assert tune.stats()["hits"] > 0
    x_def, x_tun = res_default.x.canonical(), res_tuned.x.canonical()
    assert float(torch.linalg.norm(x_tun - x_def) / torch.linalg.norm(x_def)) < 1e-4
    assert float(res_tuned.residual) <= cfg.tol
    again = solve(tuned_cfg, u, b)
    assert torch.equal(again.x.data, res_tuned.x.data)
    assert again.iterations == res_tuned.iterations


def test_persisted_rsplit_round_trips_through_table(tune_env, rng):
    fx = _field(rng)
    plan = LoweringPlan("cuda", vvl=32, rsplit=4)
    key = _graph().plan_key({"x": fx}, config=TargetConfig("cuda", device="cpu"))
    tune.record(key, plan)
    raw = json.loads(tune_env.read_text())
    assert raw["entries"][key]["plan"]["rsplit"] == 4
    tune.clear_table_cache()
    got = tune.lookup(key)
    assert got == plan and "rs4" in got.describe()


# -- the shared-memory budget (tests/test_tile.py) ----------------------------------

IN_VIEWS = ((3, 1, 4),)
OUT_VIEWS = ((3, 4),)


def _scale(v, *, a):
    return {"y": a * v["x"]}


def _lap(v, gather, *, c):
    return {"z": c * v["y"] + gather("y", (1, 0, 0)) + gather("y", (-1, 0, 0))}


def _budget_graph():
    return (LaunchGraph("budget_tune").add(_scale, {"x": "x"}, {"y": 3}, params=dict(a=2.0))
            .add_stencil(_lap, {"y": "y"}, {"z": 3}, width=1, params=dict(c=-2.0)))


def test_candidate_plans_skip_and_log_over_budget(monkeypatch, caplog):
    monkeypatch.setenv(PP.SMEM_ENV, str(64 * 1024))
    lat = (16, 32, 32)
    with caplog.at_level(logging.INFO, logger="repro_torch.core.plan"):
        cands = PP.candidate_plans(TargetConfig("cuda", device="cpu"), nsites=math.prod(lat),
                                   layouts=[SOA], stencil=True, lattice=lat,
                                   smem_views=(IN_VIEWS, OUT_VIEWS))
    assert cands
    for c in cands:
        assert c.tiled, f"an over-budget untiled candidate was kept: {c}"
    skips = [r for r in caplog.records if "exceeds budget" in r.message]
    assert skips and "KiB/block" in skips[0].getMessage()


def test_tune_candidates_carry_budget(monkeypatch, rng):
    """plan_candidates_for derives the footprint descriptor from the
    graph's ring analysis, so under a tight budget the set is tiled only."""
    monkeypatch.setenv(PP.SMEM_ENV, str(64 * 1024))
    lat = (16, 32, 32)
    cands = tune.plan_candidates_for(_budget_graph(), {"x": _field(rng, lat=lat)},
                                     config=TargetConfig("cuda", device="cpu"), outputs=("z",))
    assert cands and all(c.tiled for c in cands)


# -- the block view (tests/test_view.py) -------------------------------------------

def test_candidate_view_twins_only_for_aosoa_inputs():
    """view="block" twins iff an input layout is AoSoA; the default (first)
    candidate keeps the "auto" view, so the default policy is untouched."""
    lat = (8, 4, 8)
    n = math.prod(lat)
    cfg = TargetConfig("cuda", device="cpu")
    with_a = PP.candidate_plans(cfg, nsites=n, layouts=[aosoa(4)], stencil=True, lattice=lat)
    assert any(c.view == PP.VIEW_BLOCK for c in with_a)
    assert with_a[0].view == PP.VIEW_AUTO
    without = PP.candidate_plans(cfg, nsites=n, layouts=[SOA], stencil=True, lattice=lat)
    assert not any(c.view == PP.VIEW_BLOCK for c in without)
    gated = PP.candidate_plans(cfg, nsites=n, layouts=[aosoa(4)], stencil=True, lattice=lat,
                               block_view=False)
    assert not any(c.view == PP.VIEW_BLOCK for c in gated)


def test_plan_candidates_for_skips_misaligned_block(rng):
    """An AoSoA input whose SAL cannot tile the halo'd planes gets no block
    twins."""
    lat = (6, 4, 8)
    g = _budget_graph()
    cfg = TargetConfig("cuda", device="cpu")
    aligned = {"x": _field(rng, aosoa(4), lat=lat)}
    assert any(c.view == PP.VIEW_BLOCK
               for c in tune.plan_candidates_for(g, aligned, config=cfg, outputs=("z",)))
    misaligned = {"x": _field(rng, aosoa(8), lat=lat)}   # 8 does not divide 6 x 10
    assert not any(c.view == PP.VIEW_BLOCK
                   for c in tune.plan_candidates_for(g, misaligned, config=cfg, outputs=("z",)))


def _lb_ins(rng, lat, lay):
    f0 = (1.0 + 0.1 * rng.normal(size=(19, *lat))).astype(np.float32)
    frc = (0.01 * rng.normal(size=(3, *lat))).astype(np.float32)
    return {"dist": Field.from_numpy("dist", f0, lat, lay),
            "force": Field.from_numpy("force", frc, lat, lay)}


def test_tuned_block_winner_degrades_on_misfit(tune_env, cuda_on_cpu, rng, caplog):
    """A persisted block-view winner meeting an output layout whose SAL
    cannot tile the interior degrades to the default plan (logged), and
    gives its bits; the same plan given explicitly raises."""
    lat = (6, 4, 8)
    ins = _lb_ins(rng, lat, aosoa(4))
    g = PLD.lb_step_graph(LudwigConfig(lattice=lat))
    cfg = TargetConfig("cuda", device="cpu", vvl=96)
    block = LoweringPlan("cuda", vvl=96, bx=2, view=PP.VIEW_BLOCK)
    key = g.plan_key(ins, config=cfg, outputs=("dist2", "u"))
    tune.record(key, block)
    bad_out = {"dist2": aosoa(3)}   # 3 does not divide the interior inner 32
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.fuse"):
        got = g.launch(ins, config=dataclasses.replace(cfg, plan_policy="tuned"),
                       outputs=("dist2", "u"), out_layouts=bad_out)
    assert any("using the default plan" in r.message for r in caplog.records)
    want = g.launch(ins, config=cfg, outputs=("dist2", "u"), out_layouts=bad_out)
    assert torch.equal(got["dist2"].data, want["dist2"].data)
    with pytest.raises(ValueError, match="interior inner-plane"):
        g.launch(ins, config=cfg, outputs=("dist2", "u"), out_layouts=bad_out, plan=block)


def test_tuned_policy_applies_block_winner(tune_env, cuda_on_cpu, monkeypatch, rng):
    """plan_policy="tuned" with a persisted block-view winner runs the block
    view (its alignment check is made) and gives the default policy's
    bits."""
    lat = (6, 4, 8)
    ins = _lb_ins(rng, lat, aosoa(4))
    g = PLD.lb_step_graph(LudwigConfig(lattice=lat))
    cfg = TargetConfig("cuda", device="cpu", vvl=64)
    block = LoweringPlan("cuda", vvl=64, bx=2, view=PP.VIEW_BLOCK)
    tune.record(g.plan_key(ins, config=cfg, outputs=("dist2", "u")), block)
    checked = []
    real = PFU._block_geometry
    monkeypatch.setattr(PFU, "_block_geometry", lambda *a, **k: checked.append(1) or real(*a, **k))
    tuned = g.launch(ins, config=dataclasses.replace(cfg, plan_policy="tuned"),
                     outputs=("dist2", "u"))
    assert checked and tune.stats()["hits"] == 1
    want = g.launch(ins, config=cfg, outputs=("dist2", "u"))
    for o in ("dist2", "u"):
        assert torch.equal(tuned[o].data, want[o].data)


# -- candidate validity (tests/test_plan.py, tests/test_property.py) -----------------

def _valid_or_raises(cfg, kw, check):
    """Every candidate valid (``check``), or, where the cuda engine has no
    block size for the lattice (no whole number of warps divides it), the
    default plan and the candidate set raise alike."""
    try:
        PP.default_plan(cfg, **{k: v for k, v in kw.items() if k != "reduce"})
    except ValueError:
        with pytest.raises(ValueError):
            PP.candidate_plans(cfg, **kw)
        return
    cands = PP.candidate_plans(cfg, **kw)
    assert cands
    for c in cands:
        check(c)


@pytest.mark.parametrize("sal", [1, 2, 4, 8])
@pytest.mark.parametrize("nblk", [1, 3, 16, 63])
@pytest.mark.parametrize("preferred", [1, 32, 1024])
@pytest.mark.parametrize("warps", [1, 32])
def test_site_local_candidates_valid(sal, nblk, preferred, warps):
    """Every site-local candidate is a whole number of warps dividing nsites
    and a multiple of the SAL; the default comes first.  nsites = warps x
    sal x nblk: warps 1 is the reference's grid, where most lattices take
    no block size on the card and raise; warps 32 the launchable one."""
    nsites = warps * sal * nblk
    layouts = [aosoa(sal), SOA]
    cfg = TargetConfig("cuda", device="cpu", vvl=preferred)

    def check(c):
        assert c.engine == "cuda" and c.bx == 0
        assert nsites % c.vvl == 0 and c.vvl % sal == 0 and c.vvl % PP.WARP == 0
        c.validate(nsites=nsites, layouts=layouts)

    _valid_or_raises(cfg, dict(nsites=nsites, layouts=layouts), check)


@pytest.mark.parametrize("x_dim", [1, 4, 7, 12, 64])
@pytest.mark.parametrize("inner", [(1, 1), (4, 8), (7, 3)])
@pytest.mark.parametrize("preferred", [1, 128, 1024])
def test_stencil_candidates_valid(x_dim, inner, preferred):
    """Every stencil candidate's x-slab divides the leading dim, on the
    default's block size; the default's slab is the reference's."""
    lattice = (x_dim, *inner)
    nsites = math.prod(lattice)
    cfg = TargetConfig("cuda", device="cpu", vvl=preferred)

    def check(c):
        assert c.bx >= 1 and x_dim % c.bx == 0
        c.validate(nsites=nsites, lattice=lattice, layouts=[SOA], stencil=True)

    kw = dict(nsites=nsites, layouts=[SOA], stencil=True, lattice=lattice)
    _valid_or_raises(cfg, kw, check)
    if nsites % PP.WARP == 0:
        assert PP.candidate_plans(cfg, **kw)[0].bx == PP.choose_slab(x_dim, math.prod(inner),
                                                                     preferred)


@pytest.mark.parametrize("sal", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("nblk", [1, 7, 64, 200])
@pytest.mark.parametrize("preferred", [1, 96, 257, 1024])
def test_candidate_plans_site_local_valid_property(sal, nblk, preferred):
    """tests/test_property.py's site-local property as a grid: for every
    (nsites, sal, preferred vvl) the card can launch, every candidate has
    vvl | nsites and sal | vvl."""
    nsites = PP.WARP * sal * nblk
    layouts = [aosoa(sal)]
    cfg = TargetConfig("cuda", device="cpu", vvl=preferred)
    for c in PP.candidate_plans(cfg, nsites=nsites, layouts=layouts):
        assert nsites % c.vvl == 0 and c.vvl % sal == 0
        c.validate(nsites=nsites, layouts=layouts)


@pytest.mark.parametrize("x_dim", [1, 2, 3, 8, 31, 128])
@pytest.mark.parametrize("ny,nz", [(1, 32), (4, 8), (12, 8), (2, 16)])
@pytest.mark.parametrize("preferred", [1, 200, 1024])
def test_candidate_plans_stencil_valid_property(x_dim, ny, nz, preferred):
    """tests/test_property.py's stencil property as a grid: every stencil
    candidate's x-slab divides the leading dim."""
    lattice = (x_dim, ny, nz)
    n = math.prod(lattice)
    for c in PP.candidate_plans(TargetConfig("cuda", device="cpu", vvl=preferred), nsites=n,
                                layouts=[SOA], stencil=True, lattice=lattice):
        assert x_dim % c.bx == 0
        c.validate(nsites=n, lattice=lattice, layouts=[SOA], stencil=True)


@pytest.mark.parametrize("lay", [SOA, AOS, aosoa(32)], ids=lambda l: l.name)
def test_all_candidate_plans_match_default_lb_step(cuda_on_cpu, lay, rng):
    """Every geometry candidate of the fused LB step gives the default
    plan's field bits (plan choice is a performance knob); the dtype twin
    stays within its accuracy gate."""
    ins = _lb_ins(rng, LAT, lay)
    g = PLD.lb_step_graph(LudwigConfig(lattice=LAT))
    cfg = TargetConfig("cuda", device="cpu", vvl=128)
    cands = tune.plan_candidates_for(g, ins, config=cfg, outputs=("dist2", "u"))
    assert len(cands) > 1 and any(c.tiled for c in cands) and any(c.dtypes for c in cands)
    base = g.launch(ins, config=cfg, outputs=("dist2", "u"), plan=cands[0])
    for cand in cands[1:]:
        got = g.launch(ins, config=cfg, outputs=("dist2", "u"), plan=cand)
        if cand.dtypes:
            assert tune._rel_l2(got, base) <= tune._accuracy_gate_for(cand.dtypes), cand
        else:
            for o in ("dist2", "u"):
                assert torch.equal(got[o].data, base[o].data), cand.describe()


def test_all_candidate_plans_match_default_wilson_normal(cuda_on_cpu):
    """Candidates of the fused MILC operator: ap bitwise across geometry
    plans, <p, Ap> within the fp tolerance of a reordered sum; the dtype
    twin within its gate."""
    cfg = MilcConfig(lattice=(4, 4, 4, 4), kappa=0.1, target=TORCH)
    u, b = init_problem(cfg, seed=0)
    tgt = TargetConfig("cuda", device="cpu", vvl=256)
    g = PCG.wilson_normal_graph(cfg.kappa)
    ins = {"p": b, "u": u}
    cands = tune.plan_candidates_for(g, ins, config=tgt, outputs=("ap", "pap"),
                                     max_candidates=3)
    assert len(cands) > 1
    out0 = g.launch(ins, config=tgt, outputs=("ap", "pap"), plan=cands[0])
    for cand in cands[1:]:
        out = g.launch(ins, config=tgt, outputs=("ap", "pap"), plan=cand)
        if cand.dtypes:
            assert tune._rel_l2(out, out0) <= tune._accuracy_gate_for(cand.dtypes)
            continue
        assert torch.equal(out["ap"].data, out0["ap"].data), cand.describe()
        terms = (b.canonical() * out0["ap"].canonical()).abs().sum()
        assert abs(float(out["pap"].sum() - out0["pap"].sum())) <= 1e-5 * float(terms)


# -- parity with the JAX package's candidate sets -----------------------------------

def _to_port(ref, vvl, stencil):
    """A reference candidate as the port's: engine mapped (pallas -> cuda),
    the port's block size on stencil plans (the reference's have none), the
    default views "staged-nd"/"block" as "auto" (both resolve per launch)."""
    p = convert.to_plan(ref.to_json())
    view = p.view if (stencil and p.view == PP.VIEW_BLOCK) else PP.VIEW_AUTO
    return dataclasses.replace(p, vvl=vvl if stencil else p.vvl, view=view)


_LAYS = {"soa": (SOA, J_SOA), "aos": (AOS, J_AOS), "aosoa4": (aosoa(4), j_aosoa(4)),
         "aosoa32": (aosoa(32), j_aosoa(32)), "aosoa64": (aosoa(64), j_aosoa(64))}
_VIEWS = (((24, 1, 4), (72, 1, 4)), ((24, 4),))


@pytest.mark.parametrize("lat", [(8, 8, 8, 8), (4, 4, 4, 4), (16, 8, 8), (6, 4, 8),
                                 (12, 8, 16), (64, 64, 64, 32)], ids=str)
@pytest.mark.parametrize("stencil,spec", [(False, "soa"), (False, "aosoa32"),
                                          (False, "aosoa64"), (True, "soa"), (True, "aos"),
                                          (True, "aosoa4"), (True, "aosoa32")])
def test_candidate_plans_match_the_reference(lat, stencil, spec):
    """The port's candidate_plans against the reference's on the same
    config, lattice, layouts and budget, with and without split, dtype and
    block twins, engine names mapped.  Site-local block sizes are whole
    warps on the card, so the port on SoA is held to the reference with the
    warp as the alignment (an AoSoA(32) layout)."""
    nsites = math.prod(lat)
    pl, jl = _LAYS[spec]
    if not stencil and spec == "soa":
        jl = j_aosoa(32)
    n = 0
    for vvl in (32, 128):
        for reduce in (False, True):
            for in_dtype in (None, "float32"):
                for budget in (None, 64 * 1024):
                    for mc in (3, 8):
                        kw = dict(nsites=nsites, stencil=stencil, lattice=lat, reduce=reduce,
                                  in_dtype=in_dtype, max_candidates=mc)
                        views = _VIEWS if stencil else None
                        got = PP.candidate_plans(
                            TargetConfig("cuda", device="cpu", vvl=vvl, smem_bytes=budget),
                            layouts=[pl], smem_views=views, **kw)
                        ref = JP.candidate_plans(JTC("pallas", vvl=vvl, vmem_bytes=budget),
                                                 layouts=[jl], vmem_views=views, devices=1,
                                                 **kw)
                        assert got == tuple(_to_port(r, got[0].vvl, stencil) for r in ref), kw
                        n += 1
    assert n == 32


@pytest.mark.parametrize("spec", ["soa", "aosoa4", "aosoa32"])
@pytest.mark.parametrize("budget", [None, 256 * 1024])
def test_plan_candidates_for_matches_the_reference(spec, budget, rng):
    """plan_candidates_for on the MILC operator, the update chain and the
    Ludwig LB step against the reference's on the same fields: the same
    footprint, block-view verdict, split and dtype twins."""
    pl, jl = _LAYS[spec]
    lat4, lat3 = (4, 4, 8, 8), (8, 8, 16)
    pcfg = TargetConfig("cuda", device="cpu", vvl=128, smem_bytes=budget)
    jcfg = JTC("pallas", vvl=128, vmem_bytes=budget)

    def both(graph, jgraph, arrays, lat, outputs):
        ins = {n: Field.from_numpy(n, a, lat, pl) for n, a in arrays.items()}
        jins = {n: JField.from_numpy(n, a, lat, jl) for n, a in arrays.items()}
        got = tune.plan_candidates_for(graph, ins, config=pcfg, outputs=outputs)
        ref = JT.plan_candidates_for(jgraph, jins, config=jcfg, outputs=outputs)
        want = tuple(_to_port(r, got[0].vvl, graph.has_stencil) for r in ref)
        assert got == want, (graph.name, [c.describe() for c in got],
                             [c.describe() for c in want])

    mk = {n: rng.normal(size=(nc, *lat4)).astype(np.float32) for n, nc in (("p", 24), ("u", 72))}
    both(PCG.wilson_normal_graph(0.1), JCG.wilson_normal_graph(0.1), mk, lat4, ("ap", "pap"))
    upd = {n: rng.normal(size=(24, *lat4)).astype(np.float32) for n in ("x", "r", "p", "ap")}
    if spec == "aosoa32":   # site-local: the reference's SAL is a warp multiple
        both(PCG.cg_update_graph(24), JCG.cg_update_graph(24), upd, lat4,
             ("x_new", "r_new", "rr"))
    lb = {"dist": rng.normal(size=(19, *lat3)).astype(np.float32),
          "force": rng.normal(size=(3, *lat3)).astype(np.float32)}
    both(PLD.lb_step_graph(LudwigConfig(lattice=lat3)),
         JLD.lb_step_graph(JLudwigConfig(lattice=lat3)), lb, lat3, ("dist2", "u"))


# -- the drivers' tuners --------------------------------------------------------------

def test_tune_solve_graphs_writes_caches_and_solves_as_default(tune_env):
    """tune_solve_graphs at (4,4,4,4) on the torch engine: both graphs in the
    table, a second call cached with no sweep launch, and the tuned solve
    bitwise the default one."""
    cfg = MilcConfig(lattice=(4, 4, 4, 4), kappa=0.1, tol=1e-8, max_iter=100, target=TORCH)
    u, b = init_problem(cfg, seed=0)
    res = PMD.tune_solve_graphs(cfg, u, b, convergence_cost=True, iters=1, warmup=0)
    assert set(res) == {"wilson_normal", "cg_update"}
    assert not any(info["cached"] for _, info in res.values())
    raw = json.loads(tune_env.read_text())
    assert {e["meta"]["graph"] for e in raw["entries"].values()} == set(res)
    sweeps = tune.stats()["sweep_launches"]
    again = PMD.tune_solve_graphs(cfg, u, b, convergence_cost=True, iters=1, warmup=0)
    assert all(info["cached"] for _, info in again.values())
    assert tune.stats()["sweep_launches"] == sweeps
    want = solve(cfg, u, b)
    tune.reset_stats()
    got = solve(dataclasses.replace(cfg, target=dataclasses.replace(TORCH, plan_policy="tuned")),
                u, b)
    assert tune.stats()["hits"] == 2 * got.iterations
    assert torch.equal(got.x.data, want.x.data) and got.iterations == want.iterations


def test_tune_step_graphs_writes_caches_and_steps_as_default(tune_env):
    """tune_step_graphs at (8,8,8) on the torch engine: the three graphs in
    the table, a second call cached, and tuned steps bitwise default ones."""
    cfg = LudwigConfig(lattice=(8, 8, 8), target=TORCH)
    state = init_state(cfg, seed=0)
    res = PLD.tune_step_graphs(cfg, state, iters=1, warmup=0)
    assert set(res) == {"ludwig_chem_stress", "ludwig_lb_step", "ludwig_lc_update"}
    sweeps = tune.stats()["sweep_launches"]
    assert all(info["cached"] for _, info in PLD.tune_step_graphs(cfg, state).values())
    assert tune.stats()["sweep_launches"] == sweeps
    tuned_cfg = dataclasses.replace(cfg, target=dataclasses.replace(TORCH, plan_policy="tuned"))
    a, b = state, state
    tune.reset_stats()
    for _ in range(3):
        a, b = step(a, cfg), step(b, tuned_cfg)
    assert tune.stats()["hits"] == 9
    for f in ("dist", "q"):
        assert torch.equal(getattr(a, f).data, getattr(b, f).data)


def test_tuned_bf16_flat_winners_keep_the_carried_state(tune_env):
    """Recorded bf16 winners for the flat chains: their bf16 fields are
    widened where they leave the launch, so the carried state keeps its
    dtype and every later launch its table key (each step hits all three
    entries); the step stays within the bf16 gate of the default one.  A
    tuned MILC solve with a bf16 update-chain winner keeps x and r fp32 and
    hits the table every iteration."""
    cfg = LudwigConfig(lattice=(8, 8, 8), target=TORCH)
    state = init_state(cfg, seed=0)
    PLD.tune_step_graphs(cfg, state, iters=1, warmup=0)
    for key in list(tune.load_table()):
        if not key.startswith("ludwig_lb_step|"):
            tune.record(key, LoweringPlan("torch", dtypes=BF16))
    tuned_cfg = dataclasses.replace(cfg, target=dataclasses.replace(TORCH, plan_policy="tuned"))
    tune.reset_stats()
    got, want = step(state, tuned_cfg), step(state, cfg)
    assert tune.stats()["hits"] == 3
    assert got.q.dtype == torch.float32 and got.dist.dtype == torch.float32
    q, w = got.q.canonical().double(), want.q.canonical().double()
    assert float(torch.linalg.norm(q - w) / torch.linalg.norm(w)) < 1e-2
    mcfg = MilcConfig(lattice=(4, 4, 4, 4), kappa=0.1, tol=1e-8, max_iter=30, target=TORCH)
    u, b = init_problem(mcfg, seed=0)
    PMD.tune_solve_graphs(mcfg, u, b, iters=1, warmup=0)
    for key in list(tune.load_table()):
        if key.startswith("cg_update|"):
            tune.record(key, LoweringPlan("torch", dtypes=BF16))
    tune.reset_stats()
    res = solve(dataclasses.replace(mcfg, target=dataclasses.replace(TORCH, plan_policy="tuned")),
                u, b)
    assert res.x.dtype == torch.float32 and tune.stats()["hits"] == 2 * res.iterations
    assert np.isfinite(float(res.residual))


def test_tuned_bf16_lb_winner_drifts_the_mass_as_bf16_storage(tune_env):
    """A bf16 winner of the LB half-step (the accuracy gate passes it: its
    dist2 is a bf16 rounding, rel-L2 ~2e-3 < 1e-2) makes the tuned step the
    bf16-storage step, bitwise, whose mass drifts: after 10 steps at
    (8,8,8) beyond chip_smoke's 1e-4 limit, as the JAX package's bf16
    storage steps do (ROADMAP queue 3); the fp32 steps hold it to 1e-6."""
    from repro.apps.ludwig import driver as JLDRV

    cfg = LudwigConfig(lattice=(8, 8, 8), target=TORCH)
    s0 = init_state(cfg, seed=0)
    PLD.tune_step_graphs(cfg, s0, iters=1, warmup=0)
    for key in list(tune.load_table()):
        if key.startswith("ludwig_lb_step|"):
            tune.record(key, LoweringPlan("torch", dtypes=BF16))
    tuned = dataclasses.replace(cfg, target=dataclasses.replace(TORCH, plan_policy="tuned"))
    a, b, c = s0, s0, s0
    for _ in range(10):
        a, b = step(a, tuned), step(b, dataclasses.replace(cfg, storage="bfloat16"))
        c = step(c, cfg)
    assert torch.equal(a.dist.data, b.dist.data) and torch.equal(a.q.data, b.q.data)
    m0 = float(PLD.diagnostics(s0, cfg)["mass"])

    def drift(st):
        return abs(float(PLD.diagnostics(st, cfg)["mass"]) - m0) / m0

    assert drift(a) > 1e-4 > 1e-6 > drift(c)
    jcfg = JLudwigConfig(lattice=(8, 8, 8), storage="bfloat16")
    js = JLDRV.init_state(jcfg, seed=0)
    jm0 = float(JLDRV.diagnostics(js, jcfg)["mass"])
    for _ in range(10):
        js = JLDRV.step(js, jcfg)
    jdrift = abs(float(JLDRV.diagnostics(js, jcfg)["mass"]) - jm0) / jm0
    assert jdrift > 1e-4
    np.testing.assert_array_equal(a.dist.canonical_nd().numpy(), np.asarray(js.dist.to_numpy()))

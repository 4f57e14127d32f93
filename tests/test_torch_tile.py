"""Port parity for the tiled stencil lowering under a shared-memory budget.

The planner (tile_extents, choose_slab, choose_tiles, the footprint model
and default_plan) against the JAX package's VMEM planner on the same
inputs; the JAX package's tests/test_tile.py plan tests on the port;
``tiled_plain`` against the JAX package's interpret-mode tiled launch and
against the port's own untiled torch engine (fields bitwise, sums to a
tolerance, max exact), also under the block view, with a batch and split;
the plain versions of K9 (in every layout and bf16) and of K5T (the tiled
wilson_normal: single, batched; its walk), against the reference's tiled
launches; a budgeted MILC solve on K5T's plain version against the
reference's tiled solve; and the cuda engine's checks of tiled plans,
which come before any device check and so need no card.
"""

import dataclasses
import itertools
import logging
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.apps.milc import cg as JCG  # noqa: E402
from repro.apps.milc import fields as JF  # noqa: E402
from repro.apps.ludwig import LudwigConfig as JLudwigConfig  # noqa: E402
from repro.apps.ludwig import driver as JD  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import LaunchGraph as JLaunchGraph  # noqa: E402
from repro.core import LoweringPlan as JPlan  # noqa: E402
from repro.core import SOA as J_SOA  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.stencil import tile_boxes as j_tile_boxes  # noqa: E402
from repro.kernels.lb_propagation.ops import collide_propagate_graph as j_cp_graph  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._cuda import CSRC  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig, init_state, step  # noqa: E402
from repro_torch.apps.ludwig import driver as PD  # noqa: E402
from repro_torch.apps.milc import cg as PCG  # noqa: E402
from repro_torch.core import Field, LaunchGraph, LoweringPlan, SOA, TargetConfig  # noqa: E402
from repro_torch.core import plan as pplan  # noqa: E402
from repro_torch.core.fuse import tiled_plain  # noqa: E402
from repro_torch.core.stencil import tile_boxes  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as K8  # noqa: E402
from repro_torch.maths.d3q19 import CV as D3Q19_CV  # noqa: E402
from repro_torch.kernels.lb_propagation.ops import collide_propagate, collide_propagate_graph  # noqa: E402

TORCH = TargetConfig("torch", device="cpu")
CUDA_ON_CPU = TargetConfig("cuda", device="cpu")
PCFG = JTC("pallas", vvl=128)
LAT = (6, 4, 8)
# fp32 site-local arithmetic on both sides; sums fold per-tile partials in
# tile order (the reference's rsplit contract): tolerance, never bitwise
FIELD_RTOL, SUM_RTOL = 1e-6, 1e-6
H100_BUDGET = 227 * 1024   # 232,448 B: the H100's opt-in shared memory a block

# footprint descriptors: (ncomp, ring, itemsize) per input, (ncomp, itemsize)
# per field output
LB_VIEWS = (((19, 1, 4), (3, 1, 4)), ((19, 4), (3, 4)))   # ludwig_lb_step
MILC_VIEWS = (((24, 2, 4), (72, 2, 4)), ((24, 4),))        # wilson_normal
IN_VIEWS, OUT_VIEWS = ((3, 1, 4),), ((3, 4),)              # tile_g


@pytest.fixture(autouse=True)
def _no_budget_variables(monkeypatch):
    monkeypatch.delenv(pplan.SMEM_ENV, raising=False)
    monkeypatch.delenv(jplan.VMEM_ENV, raising=False)


def _scale(v, *, a):
    return {"y": a * v["x"]}


def _lap(v, gather, *, c):
    return {"z": (c * v["y"] + gather("y", (1, 0, 0)) + gather("y", (0, -1, 0))) ** 2}


def _tile_g(cls):
    """tests/test_tile.py's graph, built in either package."""
    return (cls("tile_g")
            .add(_scale, {"x": "x"}, {"y": 3}, params=dict(a=2.0))
            .add_stencil(_lap, {"y": "y"}, {"z": 3}, width=1, params=dict(c=-2.0))
            .add_reduce("z", op="sum", name="zt")
            .add_reduce("z", op="max", name="zm"))


# -- the planner against the JAX package's ------------------------------------------

@pytest.mark.parametrize("budget", [16, 4096, 64 * 1024, H100_BUDGET, 10 ** 9, 0])
@pytest.mark.parametrize("views", [LB_VIEWS, MILC_VIEWS], ids=["lb", "milc"])
@pytest.mark.parametrize("lat", [(16, 32, 32), (256, 256, 256), (64, 64, 64, 32)], ids=str)
def test_planner_matches_reference(lat, views, budget):
    ins, outs = views
    inner = math.prod(lat[1:])
    bx = pplan.choose_slab(lat[0], inner, 128, pplan._site_bytes(views), budget or None)
    assert bx == jplan.choose_slab(lat[0], inner, 128, jplan._site_bytes(views), budget or None)
    if budget:
        tiles = pplan.choose_tiles(lat, bx, in_views=ins, out_views=outs, smem_bytes=budget)
        assert tiles == jplan.choose_tiles(lat, bx, in_views=ins, out_views=outs,
                                           vmem_bytes=budget)
    else:
        tiles = (0, 0)
    assert pplan.tile_extents(lat, bx, *tiles) == jplan.tile_extents(lat, bx, *tiles)
    fp = pplan.estimate_smem_bytes(LoweringPlan("cuda", bx=bx, by=tiles[0], bz=tiles[1]),
                                   lattice=lat, in_views=ins, out_views=outs)
    assert fp == jplan.estimate_vmem_bytes(JPlan("pallas", bx=bx, by=tiles[0], bz=tiles[1]),
                                           lattice=lat, in_views=ins, out_views=outs)

    kw = dict(nsites=math.prod(lat), stencil=True, lattice=lat)
    got = pplan.default_plan(TargetConfig("cuda", device="cpu", smem_bytes=budget),
                             layouts=[SOA], smem_views=views, **kw)
    want = convert.to_plan(jplan.default_plan(
        dataclasses.replace(PCFG, vmem_bytes=budget), layouts=[J_SOA], vmem_views=views,
        **kw).to_json())
    assert (got.engine, got.by, got.bz) == (want.engine, want.by, want.bz) == (
        "cuda",) + tiles
    if budget:
        assert got.bx == want.bx == bx
    else:  # no budget: the untiled plan of the slices before tiling
        assert got == LoweringPlan("cuda", vvl=128)
    if lat == (256, 256, 256) and views is LB_VIEWS and budget == H100_BUDGET:
        assert (bx, *tiles) == (1, 4, 64) and fp == 231616
    if lat == (64, 64, 64, 32) and views is MILC_VIEWS and budget == H100_BUDGET:
        assert (bx, *tiles) == (1, 1, 1) and fp == 3459072


def test_collide_propagate_plan_at_the_h100_budget():
    """lb_collide_propagate (no u output) gets the lb_step's tile."""
    lat = (256, 256, 256)
    views = (LB_VIEWS[0], ((19, 4),))
    got = pplan.default_plan(TargetConfig("cuda", device="cpu", smem_bytes=H100_BUDGET),
                             nsites=math.prod(lat), layouts=[SOA], stencil=True,
                             lattice=lat, smem_views=views)
    assert (got.bx, got.by, got.bz) == (1, 4, 64)
    assert pplan.estimate_smem_bytes(got, lattice=lat, in_views=views[0],
                                     out_views=views[1]) == 228544
    # the planner's model of the two window slots (the reference's VMEM
    # model, unchanged), and K9's own figure: it pushes from the tile's own
    # sites straight from registers, with no window, so it declares no
    # shared memory whatever the tile
    assert pplan.estimate_smem_bytes(got, lattice=lat, in_views=views[0]) == 209088
    assert "__shared__" not in (CSRC / "lb_tiled.cu").read_text()


def test_no_budget_keeps_every_plan_untiled():
    """Without a budget the MILC and Ludwig launches plan as before tiling."""
    cuda = TargetConfig("cuda", device="cpu")
    for lat, views in (((64, 64, 64, 32), MILC_VIEWS), ((256, 256, 256), LB_VIEWS)):
        n = math.prod(lat)
        assert pplan.default_plan(cuda, nsites=n, layouts=[SOA], stencil=True, lattice=lat,
                                  smem_views=views) == LoweringPlan("cuda", 128)
        assert pplan.plan_for_launch(cuda, n, [SOA]) == LoweringPlan("cuda", 128)
    assert cuda.resolved_smem_bytes() is None


# -- tests/test_tile.py's plan tests, on the port ----------------------------------

def test_smem_budget_precedence(monkeypatch, caplog):
    cfg = TargetConfig("cuda", device="cpu")
    assert pplan.resolved_smem_bytes(cfg) is None
    monkeypatch.setenv(pplan.SMEM_ENV, str(1 << 20))
    assert pplan.resolved_smem_bytes(cfg) == 1 << 20
    assert cfg.resolved_smem_bytes() == 1 << 20
    assert dataclasses.replace(cfg, smem_bytes=1 << 16).resolved_smem_bytes() == 1 << 16
    assert dataclasses.replace(cfg, smem_bytes=0).resolved_smem_bytes() is None
    # the reference's variable is not the port's
    monkeypatch.delenv(pplan.SMEM_ENV)
    monkeypatch.setenv(jplan.VMEM_ENV, str(1 << 20))
    assert pplan.resolved_smem_bytes(cfg) is None
    monkeypatch.setenv(pplan.SMEM_ENV, "not-a-number")
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.plan"):
        assert pplan.resolved_smem_bytes(cfg) is None
    assert "not-a-number" in caplog.text
    monkeypatch.setenv(pplan.SMEM_ENV, "0")
    assert pplan.resolved_smem_bytes(cfg) is None


def test_estimate_smem_bytes_model():
    lat = (16, 32, 32)
    untiled = pplan.estimate_smem_bytes(LoweringPlan("cuda", bx=1), lattice=lat,
                                        in_views=IN_VIEWS, out_views=OUT_VIEWS)
    assert untiled == 3 * 18 * 34 * 34 * 4 + 3 * 32 * 32 * 4
    tiled = pplan.estimate_smem_bytes(LoweringPlan("cuda", bx=1, by=4, bz=4), lattice=lat,
                                      in_views=IN_VIEWS, out_views=OUT_VIEWS)
    assert tiled == 2 * 3 * 3 * 6 * 6 * 4 + 3 * 4 * 4 * 4
    assert pplan.choose_tiles(lat, 1, in_views=IN_VIEWS, out_views=OUT_VIEWS,
                              smem_bytes=10 ** 9) == (0, 0)
    assert pplan.choose_tiles(lat, 1, in_views=IN_VIEWS, out_views=OUT_VIEWS,
                              smem_bytes=16) == (1, 1)


def test_validate_rejects_bad_tiles():
    n = math.prod(LAT)
    with pytest.raises(ValueError, match="by=3 must divide"):
        LoweringPlan("cuda", bx=2, by=3).validate(nsites=n, lattice=LAT, stencil=True)
    with pytest.raises(ValueError, match="bz=5 must divide"):
        LoweringPlan("cuda", bx=2, bz=5).validate(nsites=n, lattice=LAT, stencil=True)
    with pytest.raises(ValueError, match="bx=4 must divide"):
        LoweringPlan("cuda", bx=4, by=2).validate(nsites=n, lattice=LAT, stencil=True)
    with pytest.raises(ValueError, match="no z axis"):
        LoweringPlan("cuda", bx=2, bz=2).validate(lattice=(6, 4), stencil=True)
    with pytest.raises(ValueError, match="no y axis"):
        LoweringPlan("cuda", bx=2, by=2).validate(lattice=(6,), stencil=True)
    with pytest.raises(ValueError, match="x-slab bx >= 1"):
        LoweringPlan("cuda", by=2).validate(nsites=n, lattice=LAT, stencil=True)
    with pytest.raises(ValueError, match="torch engine"):
        LoweringPlan("torch", by=2).validate(nsites=n, lattice=LAT, stencil=True)
    with pytest.raises(ValueError, match="no y/z tiles"):
        LoweringPlan("cuda", 32, by=2).validate(nsites=n)
    with pytest.raises(ValueError, match="no x-slab"):
        LoweringPlan("cuda", 32, bx=2).validate(nsites=n)
    with pytest.raises(ValueError, match=">= 0"):
        LoweringPlan("cuda", bx=2, by=-1).validate(lattice=LAT, stencil=True)
    # dividing tiles pass; a tiled plan needs no vvl, an untiled one does
    LoweringPlan("cuda", bx=2, by=2, bz=4).validate(nsites=n, lattice=LAT, stencil=True)
    with pytest.raises(ValueError, match="vvl"):
        LoweringPlan("cuda", bx=2).validate(nsites=n, lattice=LAT, stencil=True)


def test_describe_and_json():
    p = LoweringPlan("cuda", bx=2, by=2, bz=4)
    d = p.describe()
    assert "/ty2" in d and "/tz4" in d and "KiB" not in d
    assert "KiB/block" in p.describe(footprint=48 * 1024)
    assert "/ty" not in LoweringPlan("cuda", 128).describe()
    assert LoweringPlan.from_json(p.to_json()) == p
    # a plan written before the tile axes loads untiled
    q = LoweringPlan.from_json({"engine": "cuda", "vvl": 64, "bx": 2})
    assert (q.by, q.bz) == (0, 0) and not q.tiled


def test_tile_boxes_cover_and_errors():
    for lat, tile in ((LAT, (2, 2, 4)), ((4, 14, 16), (2, 7, 4)), ((4, 4, 4, 8), (2, 2, 0)),
                      ((3, 5), (1, 0, 0))):
        boxes = tile_boxes(lat, *tile)
        assert boxes == j_tile_boxes(lat, *tile)
        sites = [pt for box in boxes
                 for pt in itertools.product(*[range(s, s + e) for s, e in box])]
        assert len(sites) == len(set(sites)) == math.prod(lat)
    with pytest.raises(ValueError, match="divide"):
        tile_boxes(LAT, 2, 3, 0)
    with pytest.raises(ValueError, match="divide"):
        tile_boxes(LAT, 0, 2, 0)


def test_to_plan_maps_and_refuses():
    got = convert.to_plan(JPlan("pallas", bx=1, by=4, bz=64, interpret=True).to_json())
    assert got == LoweringPlan("cuda", bx=1, by=4, bz=64)
    assert convert.to_plan(JPlan("jnp").to_json()) == LoweringPlan("torch")
    assert convert.to_plan(JPlan("pallas", vvl=128, view="block").to_json()) == \
        LoweringPlan("cuda", 128, view="block")
    # a dtype policy carries across (mixed precision is ported)
    pol = jplan.DtypePolicy(storage="bfloat16", compute="float32", accumulate="float64")
    got = convert.to_plan(JPlan("pallas", vvl=128, dtypes=pol).to_json())
    assert got == LoweringPlan("cuda", 128, dtypes=pplan.DtypePolicy(*dataclasses.astuple(pol)))
    assert got.describe() == "cuda/vvl=128/dt=bf16:f32:f64"
    # the split factor and the block view carry across (both are ported)
    got = convert.to_plan(JPlan("pallas", bx=2, rsplit=2, view="block").to_json())
    assert got == LoweringPlan("cuda", bx=2, rsplit=2, view="block")
    assert got.describe() == "cuda/bx=2/block/rs2"
    # the halo strategy carries across ("overlap" is ported), and an
    # unknown one is refused by the plan's validation
    assert convert.to_plan(JPlan("pallas", bx=2, halo="pre").to_json()) == \
        LoweringPlan("cuda", bx=2, halo="pre")
    got = convert.to_plan(JPlan("pallas", bx=2, halo="overlap").to_json())
    assert got == LoweringPlan("cuda", bx=2, halo="overlap")
    assert got.describe() == "cuda/bx=2/overlap"
    with pytest.raises(ValueError, match="halo"):
        convert.to_plan({"engine": "pallas", "bx": 2, "halo": "ring"}).validate(stencil=True)


def test_plan_policy(monkeypatch, tmp_path):
    from repro_torch.core import tune

    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune.json"))
    tune.clear_table_cache()
    x = Field.from_numpy("x", np.ones((3,) + LAT, np.float32), LAT)
    g = _tile_g(LaunchGraph)
    # "tuned" (core.tune) runs: a table miss plans by default, on the torch
    # engine bitwise the default policy, on the cuda engine refused as the
    # default plan is (this graph has no kernel)
    tuned = g.launch({"x": x}, config=dataclasses.replace(TORCH, plan_policy="tuned"),
                     outputs=("z",))
    assert torch.equal(tuned["z"].data, g.launch({"x": x}, config=TORCH, outputs=("z",))["z"].data)
    with pytest.raises(ValueError, match="no hand-written CUDA kernel"):
        g.launch({"x": x}, config=TargetConfig("cuda", device="cpu", plan_policy="tuned"))
    with pytest.raises(ValueError, match="unknown plan_policy"):
        pplan.plan_for_launch(TargetConfig(plan_policy="fast"), 128, [SOA])
    # an explicit plan wins over the config's engine, for graphs and single launches
    explicit = TargetConfig("cuda", device="cpu", plan_policy=LoweringPlan("torch"))
    out = g.launch({"x": x}, config=explicit, outputs=("z",))
    want = g.launch({"x": x}, config=TORCH, outputs=("z",))
    assert torch.equal(out["z"].data, want["z"].data)
    assert pplan.plan_for_launch(explicit, 128, [SOA]) == LoweringPlan("torch")
    with pytest.raises(ValueError, match="no x-slab"):
        pplan.plan_for_launch(TargetConfig(plan_policy=LoweringPlan("cuda", 32, bx=1, by=2)),
                              128, [SOA])
    # launch(plan=) and bind(plan=) override the policy
    bound = g.bind(config=CUDA_ON_CPU, outputs=("z",), plan=LoweringPlan("torch"))
    assert torch.equal(bound({"x": x})["z"].data, want["z"].data)


# -- tiled_plain against the reference and against the untiled torch engine ---------

def _lb_arrays(rng, lat):
    f0 = (1.0 + 0.1 * rng.normal(size=(19,) + lat)).astype(np.float32)
    frc = (0.01 * rng.normal(size=(3,) + lat)).astype(np.float32)
    return {"dist": f0, "force": frc}


def _milc_arrays(rng, lat):
    return {"p": rng.normal(size=(24,) + lat).astype(np.float32),
            "u": JF.random_su3_gauge(lat, seed=2, hot=0.6)}


# name -> (port graph, reference graph, lattice, inputs, outputs, (bx, by, bz))
CASES = {
    **{f"tile_g-{by}-{bz}": (lambda: _tile_g(LaunchGraph), lambda: _tile_g(JLaunchGraph),
                             LAT, lambda rng: {"x": rng.normal(size=(3,) + LAT).astype(
                                 np.float32)}, ("z", "zt", "zm"), (2, by, bz))
       for by, bz in [(2, 0), (0, 4), (2, 4), (1, 2), (4, 8)]},
    "collide_propagate": (lambda: collide_propagate_graph(0.8), lambda: j_cp_graph(0.8),
                          (4, 14, 16), lambda rng: _lb_arrays(rng, (4, 14, 16)),
                          ("dist2",), (2, 7, 4)),
    "lb_step": (lambda: PD.lb_step_graph(LudwigConfig()),
                lambda: JD.lb_step_graph(JLudwigConfig()), (4, 14, 16),
                lambda rng: _lb_arrays(rng, (4, 14, 16)), ("dist2", "u"), (1, 2, 8)),
    "wilson_normal": (lambda: PCG.wilson_normal_graph(0.12),
                      lambda: JCG.wilson_normal_graph(0.12), (4, 4, 4, 8),
                      lambda rng: _milc_arrays(rng, (4, 4, 4, 8)), ("ap", "pap"), (2, 2, 2)),
}


def _check(got, want, graph, exact_fields):
    red = graph.reduce_specs()
    for o, w in want.items():
        g = np.asarray(got[o])
        w = np.asarray(w)
        if o in red and red[o].op == "sum":
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL, atol=SUM_RTOL * np.abs(w).max())
        elif o in red or exact_fields:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=FIELD_RTOL, atol=FIELD_RTOL * np.abs(w).max())


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_plain_matches_reference_tiled_launch(case, rng):
    """The reference's interpret-mode tiled launch (its windowed fallback of
    dma_kernel) and tiled_plain, on the same inputs and tiles."""
    pg, jg, lat, mk, outs, (bx, by, bz) = CASES[case]
    arrs = mk(rng)
    jg = jg()
    jout = jg.launch({n: JField.from_numpy(n, a, lat) for n, a in arrs.items()}, config=PCFG,
                     outputs=outs, plan=JPlan("pallas", bx=bx, by=by, bz=bz, interpret=True))
    red = jg.reduce_specs()
    want = {o: np.asarray(v).reshape(-1) if o in red else
            np.asarray(v.to_numpy()).reshape((-1,) + lat) for o, v in jout.items()}
    got = tiled_plain(pg(), {n: torch.from_numpy(a) for n, a in arrs.items()}, lat,
                      bx, by, bz, outputs=outs)
    _check({o: v.numpy().reshape(want[o].shape) for o, v in got.items()}, want, jg, False)


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_plain_matches_untiled_torch_engine(case, rng):
    """The port's own contract: fields bitwise equal to the untiled
    torch engine, sums to a tolerance, max exact."""
    pg, _, lat, mk, outs, tile = CASES[case]
    arrs = mk(rng)
    pg = pg()
    want = pg.launch({n: Field.from_numpy(n, a, lat) for n, a in arrs.items()}, config=TORCH,
                     outputs=outs)
    want = {o: (v if o in pg.reduce_specs() else v.canonical_nd()).numpy()
            for o, v in want.items()}
    got = tiled_plain(pg, {n: torch.from_numpy(a) for n, a in arrs.items()}, lat, *tile,
                      outputs=outs)
    _check({o: v.numpy() for o, v in got.items()}, want, pg, True)


@pytest.mark.parametrize("lat,tile", [((4, 14, 16), (2, 7, 4)), ((3, 5, 7), (1, 1, 7)),
                                      ((8, 8, 8), (1, 1, 2)), ((2, 1, 3), (2, 0, 0))],
                         ids=str)
def test_k9_wrapper_on_cpu_is_tiled_plain(lat, tile, rng):
    arrs = _lb_arrays(rng, lat)
    f, g = (torch.from_numpy(arrs[n].reshape(arrs[n].shape[0], -1)) for n in ("dist", "force"))
    before = K8.LB_STEP_TILED.launches
    dist2, u = K8.lb_step_tiled_cuda(f, g, 0.8, lat, tile)
    want2, want_u = K8.lb_step_tiled_plain(f, g, 0.8, lat, tile)
    assert torch.equal(dist2, want2) and torch.equal(u, want_u)
    # the tiled fields are K5L's (its plain version) bit for bit
    k5, k5u = K8.lb_step_cuda(f, g, 0.8, lat)
    assert torch.equal(dist2, k5) and torch.equal(u, k5u)
    assert K8.lb_step_tiled_cuda(f, g, 0.8, lat, tile, with_u=False)[1] is None
    assert K8.LB_STEP_TILED.launches == before
    with pytest.raises(ValueError, match="does not divide"):
        K8.lb_step_tiled_cuda(f, g, 0.8, lat, (lat[0] + 1, 0, 0))


# the card tests' K9_CASES (tests/test_torch_cuda.py) and T3's tile at T3's
# lattice (chip_smoke.py)
K9_WALK_CASES = [((8, 8, 8), (1, 1, 2)), ((8, 8, 8), (4, 4, 8)), ((8, 8, 8), (8, 8, 8)),
                 ((4, 14, 16), (2, 7, 4)), ((4, 14, 16), (1, 14, 16)), ((4, 14, 16), (4, 2, 1)),
                 ((16, 16, 32), (4, 4, 8)), ((16, 16, 32), (1, 4, 32)), ((16, 16, 32), (16, 1, 2)),
                 ((32, 32, 32), (1, 1, 2))]


@pytest.mark.parametrize("lat,tile", K9_WALK_CASES, ids=str)
def test_k9_walk_writes_every_output_once(lat, tile):
    """K9's walk mirrored (lb_tiled.cu: rt_tile_site and the grid of
    ceil(V / block) blocks, thread j of block n at position n * block + j):
    every site is taken once, the tiles in the reference's grid order, and
    the pushes dist2_i(s + c_i) write every output site of every velocity
    exactly once."""
    V = math.prod(lat)
    bx, by, bz = tile
    X, Y, Z = lat
    site = K8.tiled_walk(lat, tile)
    block = K8.K9_BLOCK
    nunits = -(-V // block)
    # block n, thread j takes position n * block + j; threads past V return
    taken = torch.cat([torch.arange(n * block, min(V, (n + 1) * block)) for n in range(nunits)])
    assert torch.equal(taken.sort().values, torch.arange(V))
    assert torch.equal(site.sort().values, torch.arange(V))
    # tile order: position g lies in tile g // (bx by bz), z-tile fastest
    x, y, z = site // (Y * Z), (site // Z) % Y, site % Z
    t = ((x // bx) * (Y // by) + y // by) * (Z // bz) + z // bz
    assert torch.equal(t, torch.arange(V) // (bx * by * bz))
    cv = torch.from_numpy(D3Q19_CV)
    for i in range(19):
        dst = (((x + cv[i, 0]) % X) * Y + (y + cv[i, 1]) % Y) * Z + (z + cv[i, 2]) % Z
        assert torch.equal(torch.bincount(dst, minlength=V), torch.ones(V, dtype=torch.int64))


def test_budgeted_step_on_torch_engine_matches_reference_tiled_step():
    """The slice as a whole on the CPU: the reference's Ludwig step with a
    VMEM budget that tiles its LB half-step, against the port's step (the
    torch engine, which ignores the budget), and the same tiles planned by
    both packages for that half-step."""
    import jax

    lat, budget = (4, 8, 8), 8 * 1024
    cfg = LudwigConfig(lattice=lat, target=TargetConfig("torch", device="cpu",
                                                        smem_bytes=budget))
    jcfg = JLudwigConfig(lattice=lat, target=dataclasses.replace(PCFG, vmem_bytes=budget))
    views = (LB_VIEWS[0], LB_VIEWS[1])
    want = convert.to_plan(jplan.default_plan(
        jcfg.target, nsites=math.prod(lat), layouts=[J_SOA], stencil=True, lattice=lat,
        vmem_views=views).to_json())
    got = pplan.default_plan(dataclasses.replace(cfg.target, engine="cuda"),
                             nsites=math.prod(lat), layouts=[SOA], stencil=True,
                             lattice=lat, smem_views=views)
    assert want.tiled and (got.bx, got.by, got.bz) == (want.bx, want.by, want.bz)
    s, js = init_state(cfg, seed=0), JD.init_state(jcfg, seed=0)
    jstep = jax.jit(JD.step, static_argnums=1)
    for _ in range(2):
        s, js = step(s, cfg), jstep(js, jcfg)
    for a, b in ((s.q, js.q), (s.dist, js.dist)):
        np.testing.assert_allclose(a.to_numpy(), np.asarray(b.to_numpy()), rtol=3e-5,
                                   atol=1e-7)


# -- tests/test_tile.py's other launches: the block view, a batch, rsplit ------------

def _ref_tile_g(x, lat, plan, jlay=J_SOA, batched=False):
    """tests/test_tile.py's graph launched by the reference (interpret) on x
    ((3,) + lat canonical, or (batch, 3) + lat): canonical z, zt, zm."""
    from repro.core.field import BatchedField as JBatchedField

    f = (JBatchedField.from_canonical("x", x, lat, jlay) if batched
         else JField.from_numpy("x", x, lat, jlay))
    out = _tile_g(JLaunchGraph).launch({"x": f}, config=PCFG, outputs=("z", "zt", "zm"),
                                       plan=plan)
    z = out["z"]
    zc = (np.stack([np.asarray(z.element(b).to_numpy()) for b in range(x.shape[0])])
          if batched else np.asarray(z.to_numpy()))
    return {"z": zc, "zt": np.asarray(out["zt"]), "zm": np.asarray(out["zm"])}


def _plain_tile_g(x, tile):
    out = tiled_plain(_tile_g(LaunchGraph), {"x": torch.from_numpy(x)}, LAT, *tile,
                      outputs=("z", "zt", "zm"))
    return {o: v.numpy() for o, v in out.items()}


def _untiled_tile_g(x, lay=SOA):
    out = _tile_g(LaunchGraph).launch({"x": Field.from_numpy("x", x, LAT, lay)}, config=TORCH,
                                      outputs=("z", "zt", "zm"))
    return {"z": out["z"].canonical_nd().numpy(), "zt": out["zt"].numpy(),
            "zm": out["zm"].numpy()}


def test_tiled_block_view_matches_reference_and_untiled(rng):
    """tests/test_tile.py's block-view case: the reference's tiled launch on
    aosoa4 under view='block' (interpret) against tiled_plain (fields
    bitwise on the port's own untiled aosoa4 launch); the cuda engine takes
    the same tiled block plan on aosoa4 to its device check."""
    from repro.core import aosoa as j_aosoa
    from repro_torch.core import parse_layout

    x = rng.normal(size=(3,) + LAT).astype(np.float32)
    plan = JPlan("pallas", bx=2, by=2, bz=4, interpret=True, view="block")
    want = _ref_tile_g(x, LAT, plan, j_aosoa(4))
    got = _plain_tile_g(x, (2, 2, 4))
    g = _tile_g(LaunchGraph)
    _check(got, want, g, False)
    _check(got, _untiled_tile_g(x, parse_layout("aosoa4")), g, True)
    with pytest.raises(ValueError, match="no hand-written tiled kernel"):
        g.launch({"x": Field.from_numpy("x", x, LAT, parse_layout("aosoa4"))},
                 config=CUDA_ON_CPU, plan=convert.to_plan(plan.to_json()))


def test_tiled_batched_matches_reference_and_untiled(rng):
    """tests/test_tile.py's batched case: the reference's batched tiled
    launch against tiled_plain slot by slot, and the port's untiled
    batched launch on the torch engine (fields bitwise)."""
    xs = rng.normal(size=(4, 3) + LAT).astype(np.float32)
    want = _ref_tile_g(xs, LAT, JPlan("pallas", bx=2, by=2, bz=4, interpret=True), batched=True)
    per = [_plain_tile_g(x, (2, 2, 4)) for x in xs]
    got = {o: np.stack([r[o] for r in per]) for o in ("z", "zt", "zm")}
    g = _tile_g(LaunchGraph)
    _check(got, want, g, False)
    from repro_torch.core import BatchedField

    out = g.launch({"x": BatchedField.from_canonical("x", torch.from_numpy(xs), LAT, SOA)},
                   config=TORCH, outputs=("z", "zt", "zm"))
    untiled = {"z": np.stack([out["z"].element(b).canonical_nd().numpy() for b in range(4)]),
               "zt": out["zt"].numpy(), "zm": out["zm"].numpy()}
    _check(got, untiled, g, True)


def test_tiled_composes_with_rsplit(rng):
    """tests/test_tile.py's rsplit case: the reference's tiled launch split
    in 2 against tiled_plain at bx 1 (sums to the tolerance)."""
    x = rng.normal(size=(3,) + LAT).astype(np.float32)
    want = _ref_tile_g(x, LAT, JPlan("pallas", bx=1, by=2, bz=4, rsplit=2, interpret=True))
    got = _plain_tile_g(x, (1, 2, 4))
    g = _tile_g(LaunchGraph)
    _check(got, want, g, False)
    _check(got, _untiled_tile_g(x), g, True)


# -- K5T, the tiled wilson_normal, and K9 off SoA: their plain versions ------------

MILC_LAT = (4, 4, 4, 8)
K5T_TILES = [(1, 1, 1), (2, 2, 2), (4, 2, 0), (1, 0, 2), (2, 4, 4)]


@pytest.mark.parametrize("tile", K5T_TILES, ids=str)
def test_k5t_plain_matches_tiled_plain_and_reference(tile, rng):
    """K5T's plain version (wilson_normal_tiled_plain) against tiled_plain
    on the wilson_normal graph (fields bitwise, pap to the tolerance) and
    the reference's tiled launch (interpret); its fields bitwise K5's plain
    version; two slots each bitwise the single launch.  The CPU wrapper is
    the plain version, launching nothing."""
    from repro_torch.kernels.wilson_dslash import kernel as WK

    arrs = _milc_arrays(rng, MILC_LAT)
    p, u = (torch.from_numpy(arrs[n].reshape(arrs[n].shape[0], -1)) for n in ("p", "u"))
    before = WK.WILSON_NORMAL_AP_TILED.launches
    ap, pap = WK.wilson_normal_tiled_cuda(p, u, 0.12, MILC_LAT, tile)
    assert WK.WILSON_NORMAL_AP_TILED.launches == before
    g = PCG.wilson_normal_graph(0.12)
    ext = pplan.tile_extents(MILC_LAT, *tile)[:3]
    tp = tiled_plain(g, {n: torch.from_numpy(a) for n, a in arrs.items()}, MILC_LAT, *ext,
                     outputs=("ap", "pap"))
    _check({"ap": ap.numpy(), "pap": pap.numpy()},
           {"ap": tp["ap"].reshape(24, -1).numpy(), "pap": tp["pap"].numpy()}, g, True)
    k5_ap, _ = WK.wilson_normal_plain(p, u, 0.12, MILC_LAT)
    assert torch.equal(ap, k5_ap)
    jout = JCG.wilson_normal_graph(0.12).launch(
        {n: JField.from_numpy(n, a, MILC_LAT) for n, a in arrs.items()}, config=PCFG,
        outputs=("ap", "pap"), plan=JPlan("pallas", bx=ext[0], by=tile[1], bz=tile[2],
                                          interpret=True))
    _check({"ap": ap.numpy(), "pap": pap.numpy()},
           {"ap": np.asarray(jout["ap"].to_numpy()).reshape(24, -1),
            "pap": np.asarray(jout["pap"])}, g, False)
    p2 = torch.stack([p, torch.flip(p, dims=(1,))])
    ap2, pap2 = WK.wilson_normal_tiled_cuda(p2, u, 0.12, MILC_LAT, tile, batched=True)
    for b in range(2):
        one = WK.wilson_normal_tiled_cuda(p2[b], u, 0.12, MILC_LAT, tile)
        assert torch.equal(ap2[b], one[0]) and torch.equal(pap2[b], one[1])
    with pytest.raises(ValueError, match="does not divide"):
        WK.wilson_normal_tiled_cuda(p, u, 0.12, MILC_LAT, (3, 1, 1))


@pytest.mark.parametrize("tile", K5T_TILES + [(4, 4, 4)], ids=str)
def test_k5t_walk_and_partial_rows(tile, rng):
    """K5T's walk mirrored (normal_walk, rt_walk_site of
    csrc/wilson_normal.cuh): every site once, the tiles in the reference's
    grid order with t whole inside a tile; at a tile whose walk is the
    linear order, the linear order.  pap folded as K5T folds it (a block's
    partial row over NORMAL_TILED_BLOCK consecutive walk positions, the
    rows in walk order) is the plain version's within the tolerance."""
    from repro_torch.kernels.wilson_dslash import kernel as WK

    X, Y, Z, T = MILC_LAT
    V = X * Y * Z * T
    site = WK.normal_walk(MILC_LAT, tile)
    assert torch.equal(site.sort().values, torch.arange(V))
    bx, by, bz = pplan.tile_extents(MILC_LAT, *tile)[:3]
    x, y, z = site // (Y * Z * T), (site // (Z * T)) % Y, (site // T) % Z
    t = ((x // bx) * (Y // by) + y // by) * (Z // bz) + z // bz
    assert torch.equal(t, torch.arange(V) // (bx * by * bz * T))
    if by * bz == 1 or (bx == 1 and bz == Z):
        assert torch.equal(site, torch.arange(V))
    arrs = _milc_arrays(rng, MILC_LAT)
    p, u = (torch.from_numpy(arrs[n].reshape(arrs[n].shape[0], -1)) for n in ("p", "u"))
    ap, pap = WK.wilson_normal_tiled_plain(p, u, 0.12, MILC_LAT, tile)
    prod = (p * ap)[:, site]
    rows = prod.reshape(24, -1, WK.NORMAL_TILED_BLOCK).sum(dim=2)
    np.testing.assert_allclose(rows.sum(dim=1).numpy(), pap.numpy(), rtol=SUM_RTOL,
                               atol=SUM_RTOL * (p * ap).abs().sum(dim=1).max().item())


@pytest.mark.parametrize("spec", ["aos", "aosoa4", "aosoa16"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_k9_plain_in_every_layout_and_bf16(spec, bf16, rng):
    """K9's plain version in a layout and under bf16 storage: bitwise the
    untiled plain LB step in that layout and policy, and the SoA instance
    repacked; against the reference's tiled launch on those fields
    (interpret; under the bf16 policy in fp32 within one bf16 ulp)."""
    from repro.core import DtypePolicy as JDtypePolicy
    from repro.core import parse_layout as j_parse_layout
    from repro_torch.core import parse_layout

    lat, tile = (4, 14, 16), (2, 7, 4)
    lay, jlay = parse_layout(spec), j_parse_layout(spec)
    arrs = _lb_arrays(rng, lat)
    d, f = (lay.pack(torch.from_numpy(arrs[n].reshape(arrs[n].shape[0], -1)))
            for n in ("dist", "force"))
    L = {"dist": lay, "force": lay, "dist2": lay, "u": lay}
    got = K8.lb_step_tiled_cuda(d, f, 0.8, lat, tile, layouts=L, bf16=bf16)
    want = K8.lb_step_plain(d, f, 0.8, lat, layouts=L, bf16=bf16)
    soa = K8.lb_step_tiled_cuda(lay.unpack(d), lay.unpack(f), 0.8, lat, tile, bf16=bf16)
    for gt, w, s in zip(got, want, soa):
        assert gt.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert torch.equal(gt, w) and torch.equal(gt, lay.pack(s))
    pol = (JDtypePolicy(storage="bfloat16", compute="float32", accumulate="float64") if bf16
           else None)
    jg = JD.lb_step_graph(JLudwigConfig())
    jout = jg.launch({n: JField.from_numpy(n, a, lat, jlay) for n, a in arrs.items()},
                     config=dataclasses.replace(PCFG, dtypes=pol), outputs=("dist2", "u"),
                     plan=JPlan("pallas", bx=2, by=7, bz=4, interpret=True, dtypes=pol))
    for o, gt in zip(("dist2", "u"), got):
        w = np.asarray(jout[o].to_numpy()).astype(np.float32)
        g_ = lay.unpack(gt).float().numpy().reshape(w.shape)
        if bf16:
            ulp = np.abs(w).astype(np.float32).view(np.int32) & 0x7F800000
            ulp = ulp.view(np.float32) * 2.0 ** -7
            assert (np.abs(g_ - w) <= ulp + 1e-30).all(), o
        else:
            np.testing.assert_allclose(g_, w, rtol=FIELD_RTOL, atol=FIELD_RTOL * np.abs(w).max())


def test_budgeted_solve_on_k5t_plain_matches_reference_tiled_solve():
    """The MILC slice on the CPU: the reference's solve under a VMEM budget
    (its wilson_normal launches tiled, interpret) against the port's solve
    whose operator is K5T's plain version on the tile the port's planner
    picks from the same budget: the same plan (describe()), iterations
    within 1, x within rel-L2 1e-5; and the port's untiled solve likewise."""
    from repro.apps.milc import MilcConfig as JMilcConfig
    from repro.apps.milc import init_problem as j_init
    from repro.apps.milc import solve as j_solve
    from repro_torch.apps.milc import MilcConfig, init_problem, solve
    from repro_torch.core.reduce import fold_components
    from repro_torch.kernels.wilson_dslash import kernel as WK

    lat, budget = MILC_LAT, H100_BUDGET
    kw = dict(lattice=lat, kappa=0.12, tol=1e-10, max_iter=500)
    jcfg = JMilcConfig(target=dataclasses.replace(PCFG, vmem_bytes=budget), **kw)
    cfg = MilcConfig(target=TORCH, **kw)
    n = math.prod(lat)
    jplan_ = jplan.default_plan(jcfg.target, nsites=n, layouts=[J_SOA], stencil=True,
                                lattice=lat, vmem_views=MILC_VIEWS)
    plan = pplan.default_plan(TargetConfig("cuda", device="cpu", smem_bytes=budget), nsites=n,
                              layouts=[SOA], stencil=True, lattice=lat, smem_views=MILC_VIEWS)
    assert plan.tiled
    assert plan.describe() == convert.to_plan(jplan_.to_json()).describe() == \
        jplan_.describe().replace("pallas/", "cuda/").replace("/interpret", "")
    ju, jb = j_init(jcfg, seed=0)
    jres = j_solve(jcfg, ju, jb)
    u, b = init_problem(cfg, seed=0)
    _, apply_mdag, apply_normal = PCG.make_wilson_op(u, cfg.kappa, cfg.target)
    tile = (plan.bx, plan.by, plan.bz)
    ud = u.data

    def k5t(pf):
        ap, pap = WK.wilson_normal_tiled_cuda(pf.data, ud, cfg.kappa, lat, tile)
        return pf.with_data(ap), fold_components(pap)

    res = PCG.cg(apply_normal, apply_mdag(b), config=TORCH, tol=cfg.tol, max_iter=cfg.max_iter,
                 apply_a_dot=k5t)
    untiled = solve(cfg, u, b)
    jx = np.asarray(jres.x.to_numpy()).reshape(24, -1)
    for r in (res, untiled):
        assert abs(r.iterations - int(jres.iterations)) <= 1
        x = r.x.canonical().numpy()
        assert np.linalg.norm(x - jx) / np.linalg.norm(jx) <= 1e-5
    assert abs(res.iterations - untiled.iterations) <= 1


# -- the cuda engine's refusals of tiled plans (no card needed) ---------------------

def test_cuda_engine_refuses_unregistered_tiled_graphs(rng):
    x = Field.from_numpy("x", rng.normal(size=(3,) + LAT).astype(np.float32), LAT)
    plan = LoweringPlan("cuda", bx=2, by=2, bz=4)
    with pytest.raises(ValueError, match=r"no hand-written tiled kernel.*cuda/bx=2/ty2/tz4.*"
                                         r"ROADMAP"):
        _tile_g(LaunchGraph).launch({"x": x}, config=CUDA_ON_CPU, plan=plan)
    lat = (4, 4, 4, 8)
    arrs = _milc_arrays(rng, lat)
    p, u = (Field.from_numpy(n, arrs[n], lat) for n in ("p", "u"))
    # wilson_normal's tiled kernel (K5T) stages no window: its launch passes
    # the plan checks and then refuses the CPU tensors
    with pytest.raises(ValueError, match="CUDA device"):
        PCG.wilson_normal_graph(0.12).launch({"p": p, "u": u}, config=CUDA_ON_CPU,
                                             outputs=("ap", "pap"), plan=plan)
    # a registered graph under a tiled plan passes both checks and then
    # refuses the CPU tensors: it never runs the plain version instead
    d, f = (Field.from_numpy(n, a, LAT) for n, a in _lb_arrays(rng, LAT).items())
    with pytest.raises(ValueError, match="CUDA device"):
        collide_propagate(d, f, tau=0.8, config=CUDA_ON_CPU, plan=plan)


def test_cuda_engine_refuses_windows_over_the_block_limit():
    """The MILC instance at (64, 64, 64, 32): the H100 budget's finest tile,
    whose reference window is 15x the shared memory a block may hold, runs
    K5T, which stages none; so does an LB tile whose window is over the
    limit (K9).  Meta tensors: the plan checks need shapes only."""
    lat = (64, 64, 64, 32)
    n = math.prod(lat)
    p, u = (Field(name, nc, lat, SOA, torch.empty((nc, n), device="meta"))
            for name, nc in (("p", 24), ("u", 72)))
    budget = TargetConfig("cuda", device="cpu", smem_bytes=H100_BUDGET)
    with pytest.raises(ValueError, match="CUDA device"):
        PCG.make_fused_normal(u, 0.12, budget)(p)
    assert pplan.estimate_smem_bytes(LoweringPlan("cuda", bx=1, by=1, bz=1), lattice=lat,
                                     in_views=MILC_VIEWS[0]) == 3456000
    lat = (4, 64, 64)
    d, f = (Field(name, nc, lat, SOA, torch.empty((nc, math.prod(lat)), device="meta"))
            for name, nc in (("dist", 19), ("force", 3)))
    for plan in (LoweringPlan("cuda", bx=4, by=32, bz=0), None):
        with pytest.raises(ValueError, match="CUDA device"):
            collide_propagate(d, f, tau=0.8, config=budget if plan is None else CUDA_ON_CPU,
                              plan=plan)

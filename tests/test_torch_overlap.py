"""Port parity for the comms/compute overlap schedule (``core.overlap``),
case for case the JAX package's tests/test_overlap.py on the torch engine:
the interior/boundary decomposition, the split launch bitwise the single
``halo="pre"`` launch and against the reference's jnp and pallas
(interpret) split launches, the per-box reductions, the empty
decomposition, the refusals, the thin-interior fallback, the tuner's
overlap twins, ``adapt_plan``'s interchange, the tuned upgrade, the default
policy keeping "pre", and the exchange helpers; beside them
``sub_lattice_plan`` against the reference's, and the plain versions of
K5HO and K5LHO on each box of a split held to the reference's "pre"
sub-launch on the same window.  The sharded solve and step under
"overlap" on 2 and 4 ranks are in tests/test_torch_distributed.py.

Tolerances: field outputs of the port's own lowerings bitwise; the
reduction of a split within rtol 1e-5 of the single launch's (the box
partials reassociate the sum, the reference's bound); the port against
the reference's launches at rtol 1e-6 (atol 1e-6 x the output's largest
magnitude), as tests/test_torch_halo.py holds the "pre" launches.
"""

import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.apps.ludwig import driver as JLD  # noqa: E402
from repro.apps.milc import cg as JCG  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import LaunchGraph as JLaunchGraph  # noqa: E402
from repro.core import LoweringPlan as JPlan  # noqa: E402
from repro.core import SOA as J_SOA  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import overlap as joverlap  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.stencil import halo_pad as jhalo_pad  # noqa: E402
from repro.kernels.lb_propagation.ops import collide_propagate_graph as jcp_graph  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig  # noqa: E402
from repro_torch.apps.ludwig import driver as PLD  # noqa: E402
from repro_torch.apps.milc import cg as PCG  # noqa: E402
from repro_torch.core import SOA, Field, LaunchGraph, LoweringPlan, TargetConfig  # noqa: E402
from repro_torch.core import halo, overlap, tune  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core.stencil import halo_pad  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as lbk  # noqa: E402
from repro_torch.kernels.lb_propagation.ops import collide_propagate_graph  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as wk  # noqa: E402

LAT = (8, 6, 4)
SITE_DIMS = (1, 2, 3)
TORCH = TargetConfig("torch", device="cpu")
CUDA_ON_CPU = TargetConfig("cuda", device="cpu", vvl=64)
RED_RTOL = 1e-5
LAUNCH_RTOL = LAUNCH_ATOL = 1e-6


def _close(got, want, rtol=LAUNCH_RTOL, atol=LAUNCH_ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


def _lap_body(v, gather):
    return {"z": gather("y", (1, 0, 0)) + gather("y", (-1, 0, 0)) + v["y"]}


def _sq_body(v):
    return {"out": v["x"] * v["x"]}


def _stencil_graph(G=LaunchGraph):
    return G("ov_stencil").add_stencil(_lap_body, {"y": "x"}, {"z": 3}, width=1)


def _reduce_graph(G=LaunchGraph):
    return (G("ov_reduce")
            .add_stencil(_lap_body, {"y": "x"}, {"z": 3}, width=1)
            .add(_sq_body, {"x": "z"}, {"out": 3}, rename={"out": "zz"})
            .add_reduce("zz", op="sum", name="nrm"))


def _padded(arr, width=1, name="x", site_dims=SITE_DIMS):
    """(port Field, reference Field) of ``arr`` wrap-padded by ``width``."""
    h = halo_pad(torch.from_numpy(arr), width, site_dims)
    jh = jhalo_pad(jnp.asarray(arr), width, site_dims)
    return (Field.from_canonical(name, h, tuple(h.shape[1:]), SOA),
            JField.from_canonical(name, jh, tuple(jh.shape[1:])))


def _padded_field(rng, lat=LAT, ncomp=3, width=1, name="x"):
    return _padded(rng.normal(size=(ncomp, *lat)).astype(np.float32), width, name)[0]


@pytest.fixture(autouse=True, scope="module")
def _cold_reference_caches():
    """Drop JAX's compiled kernels when this file is done: the JAX package's
    tests/test_overlap.py counts the pallas_calls its split constructs,
    which the reference launches here would otherwise leave compiled for a
    later file in the same process."""
    yield
    jax.clear_caches()


@pytest.fixture
def pre_launches(monkeypatch):
    """The graph names of the "pre" launches made, in order."""
    calls = []
    launch = LaunchGraph.launch

    def spy(self, ins, **kw):
        if kw.get("halo") == "pre":
            calls.append(self.name)
        return launch(self, ins, **kw)

    monkeypatch.setattr(LaunchGraph, "launch", spy)
    return calls


# -- split_boxes ----------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(0,), (0, 1), (0, 1, 2), (1,), ()])
def test_split_boxes_disjoint_cover(dims):
    """Interior and boundary slabs partition the lattice exactly (every
    site computed once), as the reference's do, box for box."""
    interior, boundary = overlap.split_boxes(LAT, 1, dims)
    seen = np.zeros(LAT, np.int32)
    for box in ([interior] if interior else []) + list(boundary):
        seen[tuple(slice(s, e) for (s, e) in box)] += 1
    assert (seen == 1).all(), (dims, seen.min(), seen.max())
    assert len(boundary) == 2 * len(dims)
    assert (interior, boundary) == joverlap.split_boxes(LAT, 1, dims)


def test_split_boxes_thin_interior_is_none():
    assert overlap.split_boxes((2, 8), 1, (0,)) == (None, [])
    assert overlap.split_boxes((4, 8), 2, (0,)) == (None, [])
    interior, boundary = overlap.split_boxes((3, 8), 1, (0,))
    assert interior == ((1, 2), (0, 8)) and len(boundary) == 2


def test_split_boxes_bad_dim_raises():
    with pytest.raises(ValueError, match="out of range"):
        overlap.split_boxes(LAT, 1, (5,))


# -- the split == the single "pre" launch -----------------------------------------------

@pytest.mark.parametrize("ref_engine", ["jnp", "pallas"])
def test_overlap_launch_matches_pre_bitwise(ref_engine, rng, pre_launches):
    """halo="overlap" on pre-exchanged inputs: the interior and boundary
    sub-launches (one "pre" launch a box: 7 for 3 dims) assemble to the
    single "pre" launch's dist2, bitwise, within rtol 1e-6 of the
    reference's split launch on its ``ref_engine``."""
    f0 = (1.0 + 0.1 * rng.normal(size=(19, *LAT))).astype(np.float32)
    frc = (0.01 * rng.normal(size=(3, *LAT))).astype(np.float32)
    (dF, jdF), (fF, jfF) = _padded(f0, name="dist"), _padded(frc, name="force")
    g = collide_propagate_graph(0.8)
    ins = {"dist": dF, "force": fF}
    pre = g.launch(ins, config=TORCH, outputs=("dist2",), halo="pre")["dist2"]
    pre_launches.clear()
    ov = g.launch(ins, config=TORCH, outputs=("dist2",), halo="overlap")["dist2"]
    assert ov.lattice == LAT and pre_launches.count(g.name) == 7
    assert torch.equal(pre.data, ov.data)
    want = jcp_graph(0.8).launch({"dist": jdF, "force": jfF}, config=JTC(ref_engine, vvl=64),
                                 outputs=("dist2",), halo="overlap")["dist2"]
    _close(ov.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("engine", ["jnp", "pallas"])
def test_overlap_reductions_combine_per_slab(engine, rng):
    """A terminal reduction under the split: the field output stays
    bitwise, the reduction folds the box partials in box order (rtol 1e-5
    of the single launch's fold), and both are held to the reference's
    split on ``engine``."""
    arr = rng.normal(size=(3, *LAT)).astype(np.float32)
    fx, jfx = _padded(arr)
    g = _reduce_graph()
    pre = g.launch({"x": fx}, config=TORCH, outputs=("z", "nrm"), halo="pre")
    ov = g.launch({"x": fx}, config=TORCH, outputs=("z", "nrm"), halo="overlap")
    assert torch.equal(pre["z"].data, ov["z"].data)
    np.testing.assert_allclose(ov["nrm"].numpy(), pre["nrm"].numpy(), rtol=RED_RTOL)
    want = _reduce_graph(JLaunchGraph).launch({"x": jfx}, config=JTC(engine, vvl=64),
                                              outputs=("z", "nrm"), halo="overlap")
    _close(ov["z"].to_numpy(), want["z"].to_numpy())
    np.testing.assert_allclose(ov["nrm"].numpy(), np.asarray(want["nrm"]), rtol=RED_RTOL)


def test_overlap_launch_entry_with_no_decomposition(rng):
    """overlap_launch with no decomposed dim (one rank, nothing to
    exchange) is the plain "pre" launch."""
    g = _stencil_graph()
    fx = _padded_field(rng)
    want = g.launch({"x": fx}, config=TORCH, halo="pre")["z"]
    got = overlap.overlap_launch(g, {"x": fx}, decomposed=(), config=TORCH,
                                 halo="overlap")["z"]
    assert torch.equal(want.data, got.data)


def test_no_stencil_graph_rejects_overlap(rng):
    g = LaunchGraph("site_only").add(_sq_body, {"x": "x"}, {"out": 3})
    fx = Field.from_numpy("x", rng.normal(size=(3, *LAT)).astype(np.float32), LAT, SOA)
    with pytest.raises(ValueError, match="stencil"):
        g.launch({"x": fx}, config=TORCH, halo="overlap")
    with pytest.raises(ValueError, match="stencil"):
        overlap.overlap_launch(g, {"x": fx}, decomposed=(), config=TORCH)
    with pytest.raises(ValueError, match="overlap"):
        LoweringPlan("cuda", vvl=64, halo="overlap").validate(nsites=192, layouts=[SOA],
                                                              stencil=False)


def test_thin_interior_falls_back_to_pre_logged(rng, caplog):
    """An interior thinner than one site falls back to "pre", logged on
    ``repro_torch.core.overlap``, not fatal, and bitwise."""
    arr = rng.normal(size=(3, 2, 2, 2)).astype(np.float32)
    fx = _padded(arr)[0]
    g = _stencil_graph()
    want = g.launch({"x": fx}, config=TORCH, halo="pre")["z"]
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.overlap"):
        got = g.launch({"x": fx}, config=TORCH, halo="overlap")["z"]
    assert any("falling back" in r.message for r in caplog.records)
    assert torch.equal(want.data, got.data)


# -- the tuner's overlap twins ------------------------------------------------------------

def _to_port(ref, vvl):
    """A reference stencil candidate as the port's (tests/test_torch_tune.py's
    mapping): engine mapped, the port's block size, the default view
    "auto"."""
    p = convert.to_plan(ref.to_json())
    view = p.view if p.view == plan_mod.VIEW_BLOCK else plan_mod.VIEW_AUTO
    return dataclasses.replace(p, vvl=vvl, view=view)


@pytest.mark.parametrize("halo_,devices,batch", [("pre", 1, 0), ("pre", 8, 0), ("pre", 8, 2),
                                                 ("periodic", 8, 0)])
def test_overlap_twins_match_the_reference(halo_, devices, batch):
    """candidate_plans' overlap twins: two (the default slab and the widest
    swept one) only for a "pre" launch on more than one rank with no
    batch, the reference's set plan for plan."""
    kw = dict(nsites=192, stencil=True, lattice=LAT, halo=halo_, devices=devices, batch=batch)
    got = plan_mod.candidate_plans(CUDA_ON_CPU, layouts=[SOA], **kw)
    ref = jplan.candidate_plans(JTC("pallas", vvl=64), layouts=[J_SOA], **kw)
    assert got == tuple(_to_port(r, got[0].vvl) for r in ref)
    n_ov = sum(c.halo == "overlap" for c in got)
    assert n_ov == (2 if (halo_ == "pre" and devices > 1 and not batch) else 0)


def test_single_device_sweeps_skip_overlap_candidates(rng, tmp_path, monkeypatch):
    """One rank proposes no overlap candidate; more ranks add the capped,
    distinctly labelled twins; a periodic launch never has them; without a
    process group the world is one rank; an autotune of a "pre" stencil
    launch runs clean end to end and keeps "pre"."""
    kw = dict(nsites=192, layouts=[SOA], stencil=True, lattice=LAT)
    one = plan_mod.candidate_plans(CUDA_ON_CPU, halo="pre", devices=1, **kw)
    assert all(c.halo == "pre" for c in one)
    assert plan_mod.candidate_plans(CUDA_ON_CPU, halo="pre", **kw) == one
    many = plan_mod.candidate_plans(CUDA_ON_CPU, halo="pre", devices=8, **kw)
    assert {c.halo for c in many} == {"pre", "overlap"}
    assert many[0].halo == "pre"
    assert sum(c.halo == "overlap" for c in many) <= 2
    assert sum(c.halo == "pre" for c in many) >= len(one) - 2
    labels = [c.describe() for c in many]
    assert len(labels) == len(set(labels))
    per = plan_mod.candidate_plans(CUDA_ON_CPU, halo="periodic", devices=8, **kw)
    assert all(c.halo == "periodic" for c in per)
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "t.json"))
    tune.clear_table_cache()
    g = _stencil_graph()
    fx = _padded_field(rng)
    plan, info = tune.autotune_graph(g, {"x": fx}, config=TORCH, halo="pre", iters=1, warmup=0,
                                     max_candidates=3)
    assert plan.halo == "pre" and not info["failed"]
    assert info["key"] == g.plan_key({"x": fx}, config=TORCH, halo="pre", lattice=LAT)
    tune.clear_table_cache()


def test_interior_lattice_matches_the_reference(rng):
    """tune._interior_lattice: the ring off under "pre" and "overlap", the
    input's lattice otherwise, as the reference's."""
    from repro.core import tune as jtune

    arr = rng.normal(size=(3, *LAT)).astype(np.float32)
    fx, jfx = _padded(arr)
    for halo_ in ("periodic", "pre", "overlap"):
        got = tune._interior_lattice(_stencil_graph(), {"x": fx}, None, halo_)
        assert got == jtune._interior_lattice(_stencil_graph(JLaunchGraph), {"x": jfx}, None,
                                              halo_)
    assert got == LAT


# -- the planning layer ----------------------------------------------------------------

def test_adapt_plan_pre_overlap_interchange():
    """A plan that chose "overlap" upgrades a "pre" call site; a periodic
    call site is authoritative; a "pre" plan follows an "overlap" call
    site; each as the reference's adapt_plan."""
    cases = (("overlap", "pre", "overlap"), ("overlap", "periodic", "periodic"),
             ("pre", "overlap", "overlap"))
    for plan_halo, site, want in cases:
        got = plan_mod.adapt_plan(LoweringPlan("cuda", vvl=64, bx=2, halo=plan_halo,
                                               view="staged-nd"), stencil=True, halo=site)
        ref = jplan.adapt_plan(JPlan("pallas", bx=2, halo=plan_halo, view="staged-nd"),
                               stencil=True, halo=site)
        assert got.halo == ref.halo == want
    with pytest.raises(ValueError, match="halo must be"):
        plan_mod.adapt_plan(LoweringPlan("cuda", vvl=64), stencil=True, halo="ring")


@pytest.mark.parametrize("box_lat", [(8, 6, 4), (1, 6, 4), (6, 1, 4), (2, 3, 4), (3, 6, 4, 5)])
@pytest.mark.parametrize("outer", [dict(bx=2), dict(bx=4, by=3, bz=2), dict(bx=3, rsplit=2,
                                                                            view="block"),
                                   dict(bx=1, by=2)])
def test_sub_lattice_plan_matches_the_reference(box_lat, outer):
    """sub_lattice_plan: bx kept where it divides, else the largest slab
    chosen again; rsplit to 1, the view to staged-nd, tiles kept where they
    divide; torch plans only rebased; each as the reference's."""
    cfg = TargetConfig("cuda", device="cpu", vvl=64)
    got = plan_mod.sub_lattice_plan(LoweringPlan("cuda", vvl=64, halo="overlap", **outer), cfg,
                                    box_lat)
    ref = jplan.sub_lattice_plan(JPlan("pallas", halo="overlap", **outer),
                                 JTC("pallas", vvl=64), box_lat)
    assert got == dataclasses.replace(convert.to_plan(ref.to_json()), vvl=64)
    assert got.halo == "pre" and got.rsplit == 1
    t = plan_mod.sub_lattice_plan(LoweringPlan("torch", halo="overlap"), cfg, box_lat)
    assert t == LoweringPlan("torch", halo="pre")


def test_tuned_overlap_plan_upgrades_pre_launch(rng, tmp_path, monkeypatch, pre_launches):
    """A persisted "overlap" winner makes a tuned "pre" launch run the
    split (one "pre" sub-launch a box), bitwise; "pre" and "overlap" share
    the table key."""
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "t.json"))
    tune.clear_table_cache()
    g = _stencil_graph()
    fx = _padded_field(rng)
    want = g.launch({"x": fx}, config=TORCH, halo="pre")["z"]
    key = g.plan_key({"x": fx}, config=TORCH, halo="pre", lattice=LAT)
    assert g.plan_key({"x": fx}, config=TORCH, halo="overlap", lattice=LAT) == key
    tune.record(key, LoweringPlan("torch", halo="overlap"))
    tune.clear_table_cache()
    assert tune.lookup(key) == LoweringPlan("torch", halo="overlap")
    pre_launches.clear()
    got = g.launch({"x": fx}, config=dataclasses.replace(TORCH, plan_policy="tuned"),
                   halo="pre")["z"]
    assert torch.equal(want.data, got.data)
    assert pre_launches.count(g.name) == 1 + 7   # the call and the split's boxes
    tune.clear_table_cache()


def test_default_policy_keeps_pre_schedule(rng, pre_launches):
    """The default policy never upgrades a "pre" call site: one launch."""
    g = _stencil_graph()
    g.launch({"x": _padded_field(rng)}, config=TORCH, halo="pre")
    assert pre_launches == [g.name]


def test_planned_strategy_follows_the_plan(rng):
    """overlap_launch(halo=None): the default policy keeps "pre"; an
    explicit "overlap" plan policy picks the split; both bitwise."""
    g = _stencil_graph()
    fx = _padded_field(rng, lat=(6, 6, 6))
    dec = ((1, "a", 1), (2, "b", 1))
    want = g.launch({"x": fx}, config=TORCH, halo="pre")["z"]
    assert overlap._resolve_strategy(g, {"x": fx}, config=TORCH, outputs=("z",), plan=None,
                                     lattice=(6, 6, 6))[0] == "pre"
    pol = dataclasses.replace(TORCH, plan_policy=LoweringPlan("torch", halo="overlap"))
    assert overlap._resolve_strategy(g, {"x": fx}, config=pol, outputs=("z",), plan=None,
                                     lattice=(6, 6, 6))[0] == "overlap"
    for cfg in (TORCH, pol):
        got = overlap.overlap_launch(g, {"x": fx}, decomposed=dec, config=cfg)["z"]
        assert torch.equal(want.data, got.data)


# -- the halo helpers ---------------------------------------------------------------------

def test_exchange_dim_thin_extent_raises():
    x = torch.zeros((3, 5, 8))
    with pytest.raises(ValueError, match=r"dim 1.*extent 5.*width 2"):
        halo.exchange_dim(x, axis_name="ax", axis_size=2, dim=1, width=2)
    with pytest.raises(ValueError, match="too thin"):
        halo.exchange(x, [(1, "ax", 2)], width=2)


def test_exchange_boundary_dim_subset(monkeypatch):
    calls = []

    def fake_exchange_dim(x, *, axis_name, axis_size, dim, width, mesh=None):
        calls.append(dim)
        return x

    monkeypatch.setattr(halo, "exchange_dim", fake_exchange_dim)
    x = torch.zeros((3, 8, 8, 8))
    dec = [(1, "a", 2), (2, "b", 2), (3, "c", 2)]
    halo.exchange_boundary(x, dec, width=1, dims=(2,))
    assert calls == [2]
    calls.clear()
    halo.exchange_boundary(x, dec, width=1)
    assert calls == [1, 2, 3]


def test_start_finish_exchange_roundtrip(monkeypatch):
    """start_exchange and finish_exchange bracket the dimension-ordered
    exchange; on the CPU the handle holds no event."""
    monkeypatch.setattr(halo, "exchange", lambda x, dec, width, mesh=None: x + 1.0)
    x = torch.ones((3, 4))
    pending = halo.start_exchange(x, [(1, "a", 2)], width=1)
    assert isinstance(pending, halo.PendingExchange) and pending.event is None
    assert torch.equal(halo.finish_exchange(pending), x + 1.0)


def test_fill_event_is_none_on_the_cpu_and_start_runs_after_it(monkeypatch):
    """On the CPU there is no fill event to wait for, and a start given
    one (None) exchanges at once, as without it."""
    monkeypatch.setattr(halo, "exchange", lambda x, dec, width, mesh=None: x + 1.0)
    x = torch.ones((3, 4))
    ready = halo.fill_event(x)
    assert ready is None
    pending = halo.start_exchange(x, [(1, "a", 2)], width=1, after=ready)
    assert pending.event is None and torch.equal(halo.finish_exchange(pending), x + 1.0)


@pytest.mark.parametrize("dec", [((1, "a", 1),), ((2, "a", 1), (3, "b", 1)), ()])
@pytest.mark.parametrize("width", [1, 2])
def test_fill_then_exchange_is_exchange_padded(dec, width, rng):
    """fill_padded (the block and the wrap of the undecomposed dims) then
    the exchange of the decomposed ones: exchange_padded's array, bitwise,
    edges and corners; exchange_field returns the Field exchanged in
    place."""
    x = torch.from_numpy(rng.normal(size=(2, 5, 4, 6)).astype(np.float32))
    want = halo.exchange_padded(x, dec, width=width)
    got = halo.finish_exchange(halo.start_exchange(halo.fill_padded(x, dec, width=width), dec,
                                                   width=width))
    assert torch.equal(got, want) and torch.equal(want, halo_pad(x, width, (1, 2, 3)))
    f = Field.from_canonical("x", halo.fill_padded(x, dec, width=width),
                             tuple(s + 2 * width for s in (5, 4, 6)))
    assert torch.equal(halo.exchange_field(f, dec, width=width).canonical_nd(), want)


# -- K5HO's and K5LHO's plain versions on each box -----------------------------------------

def _boxes(lat, ring, dims):
    interior, boundary = overlap.split_boxes(lat, ring, dims)
    return [interior] + boundary


@pytest.mark.parametrize("lat,dims", [((8, 6, 4), (0, 1, 2)), ((8, 6, 4), (1,)),
                                      ((5, 4, 6), (0, 2))])
def test_lb_step_box_plain_on_each_box(lat, dims, rng):
    """K5LHO's plain version on each box of the split: bitwise the port's
    "pre" sub-launch on the box's window and the whole "pre" launch's box,
    within rtol 1e-6 of the reference's "pre" sub-launch on that window;
    the CPU wrapper, writing box by box, assembles the whole launch."""
    f0 = (1.0 + 0.1 * rng.normal(size=(19, *lat))).astype(np.float32)
    frc = (0.01 * rng.normal(size=(3, *lat))).astype(np.float32)
    (dF, jdF), (fF, jfF) = _padded(f0, name="dist"), _padded(frc, name="force")
    cfg = LudwigConfig()
    tau = cfg.tau
    g, jg = PLD.lb_step_graph(cfg), JLD.lb_step_graph(JLD.LudwigConfig())
    dh, fh = dF.canonical(), fF.canonical()
    whole = lbk.lb_step_pre_plain(dh, fh, tau, lat)
    V = int(np.prod(lat))
    d2, u = torch.full((19, V), float("nan")), torch.full((3, V), float("nan"))
    for box in _boxes(lat, 1, dims):
        o, e = [s for s, _ in box], [b - a for a, b in box]
        bd, bu = lbk.lb_step_box_plain(dh, fh, tau, lat, o, e)
        win = {n: overlap._window(f, box, 1) for n, f in (("dist", dF), ("force", fF))}
        sub = g.launch(win, config=TORCH, outputs=("dist2", "u"), halo="pre")
        sl = (slice(None),) + tuple(slice(a, b) for a, b in box)
        for got, ref, full in ((bd, sub["dist2"], whole[0]), (bu, sub["u"], whole[1])):
            assert torch.equal(got, ref.canonical())
            assert torch.equal(got.reshape(ref.canonical_nd().shape),
                               full.reshape((full.shape[0],) + lat)[sl])
        jwin = {n: joverlap._window(f, box, 1) for n, f in (("dist", jdF), ("force", jfF))}
        jsub = jg.launch(jwin, config=JTC("jnp"), outputs=("dist2", "u"), halo="pre")
        _close(bd.numpy(), np.asarray(jsub["dist2"].canonical()))
        _close(bu.numpy(), np.asarray(jsub["u"].canonical()))
        lbk.lb_step_box_cuda(dh, fh, tau, lat, o, e, d2, u)
    assert torch.equal(d2, whole[0]) and torch.equal(u, whole[1])


@pytest.mark.parametrize("lat,dims", [((6, 5, 5, 5), (0, 1, 2, 3)), ((6, 4, 5, 2), (0, 2))])
def test_wilson_normal_box_plain_on_each_box(lat, dims, rng):
    """K5HO's plain version on each box of a 4-D split: bitwise the port's
    "pre" sub-launch on the box's window and the whole "pre" launch's box,
    within rtol 1e-6 of the reference's "pre" sub-launch on that window;
    the CPU wrapper, writing box by box, assembles the whole launch."""
    p = rng.normal(size=(24, *lat)).astype(np.float32)
    u = rng.normal(size=(72, *lat)).astype(np.float32)
    sd = (1, 2, 3, 4)
    (pF, jpF), (uF, juF) = _padded(p, 2, "p", sd), _padded(u, 2, "u", sd)
    kappa = 0.12
    g, jg = PCG.wilson_normal_graph(kappa), JCG.wilson_normal_graph(kappa)
    ph, uh = pF.canonical(), uF.canonical()
    whole = wk.wilson_normal_pre_plain(ph, uh, kappa, lat)
    for box in _boxes(lat, 2, dims):
        o, e = [s for s, _ in box], [b - a for a, b in box]
        got = wk.wilson_normal_box_plain(ph, uh, kappa, lat, o, e)
        win = {n: overlap._window(f, box, 2) for n, f in (("p", pF), ("u", uF))}
        sub = g.launch(win, config=TORCH, outputs=("ap",), halo="pre")["ap"]
        assert torch.equal(got, sub.canonical())
        sl = (slice(None),) + tuple(slice(a, b) for a, b in box)
        assert torch.equal(got.reshape((24,) + tuple(e)), whole.reshape((24,) + lat)[sl])
        jwin = {n: joverlap._window(f, box, 2) for n, f in (("p", jpF), ("u", juF))}
        jsub = jg.launch(jwin, config=JTC("jnp"), outputs=("ap",), halo="pre")["ap"]
        _close(got.numpy(), np.asarray(jsub.canonical()))
    interior, boundary = overlap.split_boxes(lat, 2, dims)
    oe = [([a for a, _ in bx], [b - a for a, b in bx]) for bx in [interior] + boundary]
    t = torch.full((24, int(np.prod([s + 2 for s in lat]))), float("nan"))
    ap = torch.full(whole.shape, float("nan"))
    wk.wilson_normal_interior_cuda(ph, uh, kappa, lat, oe[0], t, ap)
    wk.wilson_normal_boundary_cuda(ph, uh, kappa, lat, oe[0], oe[1:], t, ap)
    assert torch.equal(ap, whole)


def test_box_wrappers_refuse_boxes_outside_the_lattice():
    ph, uh = torch.zeros(24, 8 ** 4), torch.zeros(72, 8 ** 4)
    with pytest.raises(ValueError, match="does not lie"):
        wk.wilson_normal_box_plain(ph, uh, 0.1, (4, 4, 4, 4), (2, 0, 0, 0), (3, 4, 4, 4))
    with pytest.raises(ValueError, match="does not lie"):
        lbk.lb_step_box_plain(torch.zeros(19, 216), torch.zeros(3, 216), 0.8, (4, 4, 4),
                              (0, 0, 0), (4, 4, 0))

"""Port parity for the data layouts on the cuda engine's path: each kernel
wrapper's plain version (its CPU branch) on physical tensors in SoA, AoS
and AoSoA, and in mixed input/output layouts, against the JAX package's
pallas engine in interpret mode; the planner's accept/refuse grid against
the JAX package's pallas plans; and the drivers in AoS and AoSoA against
the JAX package's jnp engine.

Pure data movement (g5, propagate) is held bitwise; fp32 site-local
arithmetic to rtol 1e-6 with an atol of 1e-6 x the output's largest
magnitude (XLA and torch may contract a multiply-add differently); sums
to rtol 1e-5 of the sum of the terms' magnitudes; the stencil chains to
the tolerances their own parity tests state (test_torch_lb.py,
test_torch_dslash.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.apps.ludwig import LudwigConfig as JLudwigConfig  # noqa: E402
from repro.apps.ludwig import driver as JD  # noqa: E402
from repro.apps.milc import MilcConfig as JMilcConfig  # noqa: E402
from repro.apps.milc import cg as JCG  # noqa: E402
from repro.apps.milc import fields as JF  # noqa: E402
from repro.apps.milc import init_problem as j_init  # noqa: E402
from repro.apps.milc import solve as j_solve  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import LaunchGraph as JLaunchGraph  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import launch as j_launch  # noqa: E402
from repro.core import layout as JL  # noqa: E402
from repro.core import plan as JP  # noqa: E402
from repro.core import target_max as j_max  # noqa: E402
from repro.core import target_sum as j_sum  # noqa: E402
from repro.kernels.lb_collision import collide as j_collide  # noqa: E402
from repro.kernels.lb_propagation import propagate as j_propagate  # noqa: E402
from repro.kernels.wilson_dslash import dslash as j_dslash  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig, init_state, step  # noqa: E402
from repro_torch.apps.ludwig import kernel as LK  # noqa: E402
from repro_torch.apps.milc import MilcConfig, init_problem, solve  # noqa: E402
from repro_torch.core import SOA, Field, TargetConfig, fuse, parse_layout, reduce, target  # noqa: E402
from repro_torch.core import plan as PP  # noqa: E402
from repro_torch.kernels.lb_collision import kernel as K7  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as K8  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as PK  # noqa: E402

SPECS = ["soa", "aos", "aosoa4", "aosoa8", "aosoa16"]
# (input layout, output layout) of the mixed launches
MIXED = [("aos", "aosoa8"), ("aosoa4", "soa"), ("soa", "aosoa16")]
PALLAS = JTC("pallas", vvl=128)   # interpret mode off the TPU
TORCH = TargetConfig("torch", device="cpu")
MILC_LAT, LB_LAT = (4, 4, 2, 8), (4, 4, 8)     # 256 and 128 sites
FIELD_RTOL, FIELD_ATOL = 1e-6, 1e-6
SUM_RTOL = 1e-5
# test_torch_lb.py (collision) and test_torch_dslash.py (the hopping term)
COLLIDE_RTOL, COLLIDE_ATOL = 2e-5, 2e-6
DSLASH_RTOL, DSLASH_ATOL = 1e-5, 1e-6


def _lays(spec):
    return parse_layout(spec), JL.parse_layout(spec)


def _jf(name, arr, lat, spec):
    return JField.from_numpy(name, arr, lat, JL.parse_layout(spec))


def _phys(arr, spec):
    """A canonical (ncomp, *lattice) numpy array packed into ``spec``."""
    return parse_layout(spec).pack(torch.from_numpy(arr).reshape(arr.shape[0], -1))


def _close(got, want, rtol=FIELD_RTOL, atol=FIELD_ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol * np.abs(want).max())


def _j_g5_body(v):
    """The reference's g5 body (cg.g5 defines it inline)."""
    x = v["psi"]
    return {"out": jnp.concatenate([x[:12], -x[12:]], axis=0)}


def _spinors(rng, n=2, lat=MILC_LAT):
    return [rng.normal(size=(24,) + lat).astype(np.float32) for _ in range(n)]


# -- K1: _run_pallas ----------------------------------------------------------------

@pytest.mark.parametrize("spec_in,spec_out", [(s, s) for s in SPECS] + MIXED)
def test_site_local_plain_versions_match_pallas(spec_in, spec_out, rng):
    x, y = _spinors(rng)
    lay_out = JL.parse_layout(spec_out)
    jx, jy = _jf("x", x, MILC_LAT, spec_in), _jf("y", y, MILC_LAT, spec_in)
    L = {"x": parse_layout(spec_in), "y": parse_layout(spec_in), "out": parse_layout(spec_out)}
    px, py = _phys(x, spec_in), _phys(y, spec_in)

    want = j_launch(_j_g5_body, {"psi": jx}, {"out": 24}, config=PALLAS,
                    out_layouts={"out": lay_out})["out"]
    got = target.site_g5(px, 12, layouts={"x": L["x"], "out": L["out"]})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))
    want = j_launch(JCG._mul_body, {"x": jx, "y": jy}, {"out": 24}, config=PALLAS,
                    out_layouts={"out": lay_out})["out"]
    np.testing.assert_array_equal(target.site_mul(px, py, layouts=L).numpy(),
                                  np.asarray(want.data))
    want = j_launch(JCG._axpy_body, {"x": jx, "y": jy}, {"out": 24}, config=PALLAS,
                    params=dict(a=0.75), out_layouts={"out": lay_out})["out"]
    _close(target.site_axpy(0.75, px, py, layouts=L), want.data)


# -- K2: _reduce ---------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_reduction_plain_versions_match_pallas(spec, rng):
    (x,) = _spinors(rng, 1)
    jx, px = _jf("x", x, MILC_LAT, spec), _phys(x, spec)
    lay = {"x": parse_layout(spec)}
    got = reduce.reduce_sites(px, "sum", layouts=lay)
    lim = SUM_RTOL * np.abs(x.reshape(24, -1)).sum(axis=1)
    assert (np.abs(got.numpy() - np.asarray(j_sum(jx, PALLAS))) <= lim).all()
    np.testing.assert_array_equal(reduce.reduce_sites(px, "max", layouts=lay).numpy(),
                                  np.asarray(j_max(jx, PALLAS)))


# -- K3: _build_flat ------------------------------------------------------------------

CG_MIXED = {"x": "aos", "r": "aosoa8", "p": "soa", "ap": "aosoa4", "x_new": "aosoa16",
            "r_new": "aos"}


@pytest.mark.parametrize("specs", [{n: s for n in CG_MIXED} for s in SPECS] + [CG_MIXED],
                         ids=SPECS + ["mixed"])
def test_flat_graph_plain_versions_match_pallas(specs, rng):
    arrs = dict(zip(("x", "r", "p", "ap"), _spinors(rng, 4)))
    jins = {n: _jf(n, a, MILC_LAT, specs[n]) for n, a in arrs.items()}
    pins = {n: _phys(a, specs[n]) for n, a in arrs.items()}
    L = {n: parse_layout(s) for n, s in specs.items()}
    alpha = 0.37
    want = JCG.cg_update_graph(24).launch(
        jins, scalars={"alpha": alpha, "neg_alpha": -alpha}, config=PALLAS,
        outputs=("x_new", "r_new", "rr"),
        out_layouts={o: JL.parse_layout(specs[o]) for o in ("x_new", "r_new")})
    a = torch.tensor(alpha)
    x_new, r_new, rr = fuse.cg_update(*(pins[n] for n in ("x", "r", "p", "ap")), a, -a,
                                      layouts=L)
    _close(x_new, want["x_new"].data)
    _close(r_new, want["r_new"].data)
    terms = (L["r_new"].unpack(r_new) ** 2).sum(dim=1).numpy()
    assert (np.abs(rr.numpy() - np.asarray(want["rr"])) <= SUM_RTOL * terms).all()
    xpay = JLaunchGraph("cg_xpay").add(JCG._fma_body, {"x": "x", "y": "y", "a": "a"},
                                       {"out": 24})
    want = xpay.launch(
        {"x": jins["x"], "y": jins["r"]}, scalars={"a": alpha}, config=PALLAS,
        out_layouts={"out": JL.parse_layout(specs["x_new"])})["out"]
    got = fuse.cg_xpay(pins["x"], pins["r"], a,
                       layouts={"x": L["x"], "y": L["r"], "out": L["x_new"]})
    _close(got, want.data)


# -- K4: dslash_site_pallas ------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_dslash_plain_version_matches_pallas(spec, rng):
    (psi,) = _spinors(rng, 1)
    u = JF.random_su3_gauge(MILC_LAT, seed=4, hot=0.6)
    want = j_dslash(_jf("psi", psi, MILC_LAT, spec), _jf("u", u, MILC_LAT, spec), config=PALLAS)
    lay = parse_layout(spec)
    got = PK.dslash_cuda(_phys(psi, spec), _phys(u, spec), MILC_LAT,
                         layouts={"psi": lay, "u": lay})
    _close(got, want.data, DSLASH_RTOL, DSLASH_ATOL)


def test_dslash_plain_version_takes_mixed_layouts(rng):
    (psi,) = _spinors(rng, 1)
    u = JF.random_su3_gauge(MILC_LAT, seed=4, hot=0.6)
    want = PK.dslash_plain(_phys(psi, "soa"), _phys(u, "soa"), MILC_LAT)
    L = {"psi": parse_layout("aos"), "u": parse_layout("aosoa8"), "out": parse_layout("aosoa4")}
    got = PK.dslash_cuda(_phys(psi, "aos"), _phys(u, "aosoa8"), MILC_LAT, layouts=L)
    assert torch.equal(L["out"].unpack(got), want)


# -- K7: collide_pallas, dist and force in their own layouts --------------------------

def _lb_arrays(rng, lat=LB_LAT):
    f0 = (1.0 + 0.1 * rng.normal(size=(19,) + lat)).astype(np.float32)
    return f0, (0.01 * rng.normal(size=(3,) + lat)).astype(np.float32)


@pytest.mark.parametrize("spec_d,spec_f", [(s, s) for s in SPECS] + [("aosoa8", "soa"),
                                                                      ("aos", "aosoa16")])
def test_collide_plain_version_matches_pallas(spec_d, spec_f, rng):
    f0, frc = _lb_arrays(rng)
    want = j_collide(_jf("dist", f0, LB_LAT, spec_d), _jf("force", frc, LB_LAT, spec_f),
                     tau=0.8, config=PALLAS)
    L = {"dist": parse_layout(spec_d), "force": parse_layout(spec_f)}
    got = K7.collide_cuda(_phys(f0, spec_d), _phys(frc, spec_f), 0.8, layouts=L)
    _close(got, want.data, COLLIDE_RTOL, COLLIDE_ATOL)


# -- K8: propagate_pallas ----------------------------------------------------------------

@pytest.mark.parametrize("spec_in,spec_out", [(s, s) for s in SPECS] + MIXED)
def test_propagate_plain_version_matches_pallas(spec_in, spec_out, rng):
    f0, _ = _lb_arrays(rng)
    want = j_propagate(_jf("dist", f0, LB_LAT, spec_in), config=PALLAS)
    L = {"dist": parse_layout(spec_in), "out": parse_layout(spec_out)}
    got = K8.propagate_cuda(_phys(f0, spec_in), LB_LAT, layouts=L)
    np.testing.assert_array_equal(L["out"].unpack(got).numpy(),
                                  np.asarray(want.canonical()))
    if spec_in == spec_out:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))


# -- K5L, K5: _build_nd (the lb_step and wilson_normal graphs) --------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_lb_step_plain_version_matches_pallas(spec, rng):
    f0, frc = _lb_arrays(rng)
    want = JD.lb_step_graph(JLudwigConfig()).launch(
        {"dist": _jf("dist", f0, LB_LAT, spec), "force": _jf("force", frc, LB_LAT, spec)},
        config=PALLAS, outputs=("dist2", "u"))
    lay = parse_layout(spec)
    d2, u = K8.lb_step_cuda(_phys(f0, spec), _phys(frc, spec), 0.8, LB_LAT,
                            layouts={"dist": lay, "force": lay})
    _close(d2, want["dist2"].data, COLLIDE_RTOL, COLLIDE_ATOL)
    _close(u, want["u"].data, COLLIDE_RTOL, COLLIDE_ATOL)


@pytest.mark.parametrize("spec", SPECS)
def test_wilson_normal_plain_version_matches_pallas(spec, rng):
    (p,) = _spinors(rng, 1)
    u = JF.random_su3_gauge(MILC_LAT, seed=5, hot=0.6)
    want = JCG.wilson_normal_graph(0.12).launch(
        {"p": _jf("p", p, MILC_LAT, spec), "u": _jf("u", u, MILC_LAT, spec)}, config=PALLAS,
        outputs=("ap", "pap"))
    lay = parse_layout(spec)
    ap, pap = PK.wilson_normal_cuda(_phys(p, spec), _phys(u, spec), 0.12, MILC_LAT,
                                    layouts={"p": lay, "u": lay})
    _close(ap, want["ap"].data, DSLASH_RTOL, DSLASH_ATOL)
    terms = np.abs(p.reshape(24, -1) * lay.unpack(ap).numpy()).sum(axis=1)
    assert (np.abs(pap.numpy() - np.asarray(want["pap"])) <= SUM_RTOL * terms).all()


# -- K3L, K1L: the Ludwig flat kernels' plain versions in mixed layouts ----------------

def test_ludwig_flat_plain_versions_take_mixed_layouts(rng):
    V = int(np.prod(LB_LAT))
    q, lapq, h, adv = (rng.normal(size=(5, V)).astype(np.float32) * 0.05 for _ in range(4))
    dq, w = (rng.normal(size=(n, V)).astype(np.float32) * 0.02 for n in (15, 9))
    t = {n: torch.from_numpy(a) for n, a in dict(q=q, lapq=lapq, h=h, adv=adv, dq=dq,
                                                w=w).items()}
    aos, a8 = parse_layout("aos"), parse_layout("aosoa8")
    kw = dict(a0=0.01, gamma=3.0, kappa_m=0.01, kappa_s=0.01, xi=0.7)
    want = LK.chem_stress_plain(t["q"], t["lapq"], t["dq"], **kw)
    L = {"q": aos, "lapq": SOA, "dq": a8, "h": a8, "sigma": aos}
    got = LK.chem_stress_cuda(aos.pack(t["q"]), t["lapq"], a8.pack(t["dq"]), layouts=L, **kw)
    assert torch.equal(a8.unpack(got[0]), want[0]) and torch.equal(aos.unpack(got[1]), want[1])
    kw = dict(gamma_rot=0.3, xi=0.7, dt=1.0)
    L = {"q": a8, "h": aos, "w": SOA, "adv": aos, "q_new": SOA}
    got = LK.lc_update_cuda(a8.pack(t["q"]), aos.pack(t["h"]), t["w"], aos.pack(t["adv"]),
                            layouts=L, **kw)
    assert torch.equal(got, LK.lc_update_plain(t["q"], t["h"], t["w"], t["adv"], **kw))
    kw = dict(a0=0.01, gamma=3.0, kappa=0.01)
    got = LK.fed_cuda(aos.pack(t["q"]), a8.pack(t["dq"]), layouts={"q": aos, "dq": a8}, **kw)
    assert torch.equal(aos.unpack(got), LK.fed_plain(t["q"], t["dq"], **kw))


# -- the planner ----------------------------------------------------------------------------

PLAN_SPECS = ["soa", "aos", "aosoa4", "aosoa8", "aosoa16", "aosoa64", "aosoa128", "aosoa256"]


@pytest.mark.parametrize("spec", PLAN_SPECS)
def test_planner_accepts_and_refuses_the_reference_grid(spec):
    """Explicit plans: the same (layout, vvl, nsites) accepted and refused
    as on the JAX package's pallas engine, over whole-warp vvls (the port's
    own rule); default plans: the reference's block wherever that is a
    whole number of warps, else a conforming one."""
    lay, jlay = _lays(spec)
    for nsites in (128, 384, 512, 1536, 4096, 6144):
        for vvl in (32, 64, 96, 128, 256, 512, 1024):
            try:
                JP.LoweringPlan("pallas", vvl=vvl).validate(nsites=nsites, layouts=[jlay])
                ok = True
            except ValueError:
                ok = False
            if ok:
                PP.LoweringPlan("cuda", vvl).validate(nsites=nsites, layouts=[lay])
            else:
                with pytest.raises(ValueError):
                    PP.LoweringPlan("cuda", vvl).validate(nsites=nsites, layouts=[lay])
        for cvvl in (32, 128, 256):
            try:
                jv = JP.default_plan(JTC("pallas", vvl=cvvl), nsites=nsites, layouts=[jlay]).vvl
            except ValueError:
                with pytest.raises(ValueError):
                    PP.default_plan(TargetConfig("cuda", device="cpu", vvl=cvvl),
                                    nsites=nsites, layouts=[lay])
                continue
            pv = PP.default_plan(TargetConfig("cuda", device="cpu", vvl=cvvl),
                                 nsites=nsites, layouts=[lay]).vvl
            if jv % PP.WARP == 0:
                assert pv == jv, (spec, nsites, cvvl)
            else:
                assert pv % PP.WARP == 0 and nsites % pv == 0 and pv % lay.sal == 0


@pytest.mark.parametrize("spec", SPECS)
def test_tiled_plans_take_soa_only(spec):
    """A shared-memory budget tiles the LB half-step in every layout (K9
    addresses each field through INDEX): the same tiled plan as SoA's."""
    lat = (32, 32, 32)
    cfg = TargetConfig("cuda", device="cpu", smem_bytes=6512)
    views = (((19, 1, 4), (3, 1, 4)), ((19, 4), (3, 4)))
    lay = parse_layout(spec)
    kw = dict(nsites=int(np.prod(lat)), stencil=True, lattice=lat, smem_views=views)
    got = PP.default_plan(cfg, layouts=[lay, lay], **kw)
    soa = PP.default_plan(cfg, layouts=[SOA, SOA], **kw)
    assert got.tiled and (got.bx, got.by, got.bz) == (soa.bx, soa.by, soa.bz) == (1, 1, 2)
    assert not PP.default_plan(TargetConfig("cuda", device="cpu"), layouts=[lay, lay],
                               **kw).tiled


# -- the drivers --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["aos", "aosoa8"])
def test_solve_in_a_layout_matches_reference(spec):
    lay, jlay = _lays(spec)
    kw = dict(lattice=(4, 4, 4, 8), kappa=0.10, tol=1e-10, max_iter=2000)
    cfg = MilcConfig(layout=lay, target=TORCH, **kw)
    u, b = init_problem(cfg, seed=0)
    assert u.layout == lay and b.layout == lay
    res = solve(cfg, u, b)
    jcfg = JMilcConfig(layout=jlay, **kw)
    jres = j_solve(jcfg, *j_init(jcfg, seed=0))
    assert res.x.layout == lay
    assert abs(res.iterations - int(jres.iterations)) <= 1
    x, jx = res.x.to_numpy(), np.asarray(jres.x.to_numpy())
    assert np.linalg.norm(x - jx) / np.linalg.norm(jx) < 1e-5


def test_step_in_aos_matches_reference():
    lay, jlay = _lays("aos")
    lat = (8, 8, 8)
    cfg = LudwigConfig(lattice=lat, layout=lay, target=TORCH)
    jcfg = JLudwigConfig(lattice=lat, layout=jlay, target=JTC("jnp"))
    s, js = init_state(cfg, seed=5), JD.init_state(jcfg, seed=5)
    np.testing.assert_array_equal(s.dist.data.numpy(), np.asarray(js.dist.data))
    s, js = step(s, cfg), JD.step(js, jcfg)
    assert s.dist.layout == lay and s.q.layout == lay
    # the reference's own C1 tolerance for one step (tests/test_ludwig.py)
    for got, want in ((s.q, js.q), (s.dist, js.dist)):
        np.testing.assert_allclose(got.to_numpy(), np.asarray(want.to_numpy()),
                                   rtol=3e-5, atol=1e-7)


@pytest.mark.parametrize("spec", ["aos", "aosoa16"])
def test_torch_engine_step_is_layout_free(spec):
    """The step's torch layer and plain bodies give every layout SoA's bits,
    the property the cuda engine is held to on the card."""
    lay = parse_layout(spec)
    lat = (8, 8, 8)
    cfg, lcfg = (LudwigConfig(lattice=lat, layout=layout, target=TORCH) for layout in (SOA, lay))
    s = init_state(cfg, seed=0)
    t = type(s)(dist=s.dist.as_layout(lay), q=s.q.as_layout(lay))
    for _ in range(2):
        s, t = step(s, cfg), step(t, lcfg)
    assert torch.equal(t.dist.canonical(), s.dist.data)
    assert torch.equal(t.q.canonical(), s.q.data)


def test_field_as_layout_round_trips(rng):
    arr = rng.normal(size=(5, 4, 4, 8)).astype(np.float32)
    f = Field.from_numpy("q", arr, (4, 4, 8))
    for spec in SPECS:
        g = f.as_layout(parse_layout(spec))
        assert g.layout.name == spec and g.data.is_contiguous()
        np.testing.assert_array_equal(g.to_numpy(), arr)
        assert g.as_layout(SOA).data.equal(f.data)
    assert f.as_layout(SOA) is f

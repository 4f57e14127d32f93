"""The native AoSoA stencil view (``LoweringPlan.view``) on the port,
against the JAX package (``tests/test_view.py``'s contracts).

The plan axis (describe, JSON, validate, ``adapt_plan``,
``block_view_ok``) mirrors the reference's; the layouts' block helpers and
``halo_pad_physical`` are bitwise the reference's and raise where it
raises.  ``tests/test_view.py``'s launches run on the torch engine, which
ignores the view as the jnp engine does: block and staged plans are bitwise
each other, fields within rtol/atol 1e-5 of the reference's pallas
block-view launch (interpret mode), and the fused sum ``zt`` within 1e-5
x the sum of its terms' magnitudes of the reference's staged ``zt`` (its
block ``zt`` differs from its
staged one by ~1e-5, a deviation of the reference: ROADMAP queue 3).  On
the cuda engine a misaligned or AoSoA-less explicit block view raises with
the reference's keywords before any device is touched (these fields lie
on the CPU)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.apps.milc import MilcConfig as JMilcConfig  # noqa: E402
from repro.apps.milc import cg as JCG  # noqa: E402
from repro.apps.milc import init_problem as j_init  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import LaunchGraph as JLaunchGraph  # noqa: E402
from repro.core import LoweringPlan as JPlan  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import layout as JL  # noqa: E402
from repro.core import plan as JP  # noqa: E402
from repro.core import stencil as JS  # noqa: E402
from repro.kernels.lb_propagation.ops import collide_propagate_graph as j_cp_graph  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps.milc import cg as PCG  # noqa: E402
from repro_torch.core import SOA, Field, LaunchGraph, TargetConfig, parse_layout  # noqa: E402
from repro_torch.core import plan as PP  # noqa: E402
from repro_torch.core import stencil as PS  # noqa: E402
from repro_torch.kernels.lb_propagation.ops import collide_propagate_graph  # noqa: E402

PCFG = JTC("pallas", vvl=128)   # interpret mode off the TPU
TORCH = TargetConfig("torch", device="cpu")
CUDA_ON_CPU = TargetConfig("cuda", device="cpu")
LAT = (6, 4, 8)       # halo'd inner plane 6 x 10 = 60: SAL 2 and 4 divide it, 8 does not
RTOL = ATOL = 1e-5
SPECS = ["soa", "aos", "aosoa2", "aosoa4", "aosoa16"]


def _scale_body(v, *, a):
    return {"y": a * v["x"]}


def _lap_body(v, gather, *, c):
    return {"z": c * v["y"] + gather("y", (1, 0, 0)) + gather("y", (-1, 0, 0))}


def _graph(cls):
    return (cls("view_g")
            .add(_scale_body, {"x": "x"}, {"y": 3}, params=dict(a=2.0))
            .add_stencil(_lap_body, {"y": "y"}, {"z": 3}, width=1, params=dict(c=-2.0))
            .add_reduce("z", op="sum", name="zt"))


def _jplans(bx):
    return (JPlan("pallas", bx=bx, interpret=True, view="staged-nd"),
            JPlan("pallas", bx=bx, interpret=True, view="block"))


def _pplans(bx):
    return (PP.LoweringPlan("torch", bx=bx, view="staged-nd"),
            PP.LoweringPlan("torch", bx=bx, view="block"))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- the plan axis -----------------------------------------------------------------

def test_block_view_ok_matches_the_reference():
    """block_view_ok over a grid of layouts, halo'd and interior counts."""
    specs = ["soa", "aos", "aosoa2", "aosoa3", "aosoa4", "aosoa8", "aosoa16"]
    counts = [12, 32, 60, 66, 100, 288]
    for a in specs:
        for b in specs:
            for hi in counts:
                for inner in counts:
                    ins = [(parse_layout(a), hi), (parse_layout(b), hi + 4)]
                    jins = [(JL.parse_layout(a), hi), (JL.parse_layout(b), hi + 4)]
                    for out in ("soa", a, b):
                        got = PP.block_view_ok(ins, [parse_layout(out)], inner)
                        want = JP.block_view_ok(jins, [JL.parse_layout(out)], inner)
                        assert got == want, (a, b, hi, inner, out)


def test_describe_json_validate_and_adapt_mirror_the_reference():
    """describe() names /block on stencil plans and /rsN; to_json and
    from_json round-trip view and rsplit; validate raises with the
    reference's keywords; adapt_plan resolves the view as the reference's."""
    pairs = [(JPlan("pallas", bx=4, view="block"), PP.LoweringPlan("cuda", bx=4, view="block")),
             (JPlan("pallas", bx=4, view="staged-nd"),
              PP.LoweringPlan("cuda", bx=4, view="staged-nd")),
             (JPlan("pallas", vvl=64, view="block"), PP.LoweringPlan("cuda", vvl=64, view="block")),
             (JPlan("pallas", bx=2, rsplit=4, view="block"),
              PP.LoweringPlan("cuda", bx=2, rsplit=4, view="block"))]
    for jp, pp in pairs:
        assert convert.to_plan(jp.to_json()) == pp
        assert pp.describe().replace("cuda", "pallas") == jp.describe()
        assert PP.LoweringPlan.from_json(pp.to_json()) == pp
        assert PP.LoweringPlan.from_json(jp.to_json()) == dataclasses.replace(pp, engine="pallas")
    assert "block" in pairs[0][1].describe() and "block" not in pairs[1][1].describe()
    # validate: the reference's rules and keywords
    for jp, pp, kw in (
            (JPlan("pallas", bx=2, view="bogus"), PP.LoweringPlan("cuda", bx=2, view="bogus"),
             dict(stencil=True)),
            (JPlan("pallas", bx=2, view="block"), PP.LoweringPlan("cuda", bx=2, view="block"),
             dict(stencil=True, lattice=LAT, layouts=[JL.SOA])),
            (JPlan("pallas", vvl=64, view="staged-nd"),
             PP.LoweringPlan("cuda", vvl=64, view="staged-nd"), dict(nsites=192))):
        with pytest.raises(ValueError) as je:
            jp.validate(**kw)
        kw = {k: ([SOA] if k == "layouts" else v) for k, v in kw.items()}
        with pytest.raises(ValueError) as pe:
            pp.validate(**kw)
        for word in ("AoSoA", "canonical-view", "per-block"):
            assert (word in str(je.value)) == (word in str(pe.value)), (word, je.value, pe.value)
    # aligned AoSoA passes both
    JPlan("pallas", bx=2, view="block").validate(stencil=True, lattice=LAT,
                                                 layouts=[JL.aosoa(4)])
    PP.LoweringPlan("cuda", vvl=32, bx=2, view="block").validate(
        stencil=True, lattice=LAT, layouts=[parse_layout("aosoa4")])
    # a tiled block plan passes the plan checks as the reference's does; its
    # launch on AoSoA fields then refuses CPU tensors, and one with no AoSoA
    # input is refused as the reference refuses it
    tiled = PP.LoweringPlan("cuda", bx=2, by=2, view="block")
    tiled.validate(stencil=True, lattice=LAT, layouts=[parse_layout("aosoa4")])
    JPlan("pallas", bx=2, by=2, view="block").validate(stencil=True, lattice=LAT,
                                                       layouts=[JL.aosoa(4)])
    rng = np.random.default_rng(0)
    cuda = TargetConfig("cuda", device="cpu")
    for spec, match in (("aosoa4", "CUDA device"), ("soa", "no input layout of this launch")):
        ins = {n: Field.from_numpy(n, rng.normal(size=(nc,) + LAT).astype(np.float32), LAT,
                                   parse_layout(spec))
               for n, nc in (("dist", 19), ("force", 3))}
        with pytest.raises(ValueError, match=match):
            collide_propagate_graph(0.8).launch(
                ins, config=cuda, outputs=("dist2",), plan=tiled,
                out_layouts={"dist2": parse_layout("aosoa4")})
    # adapt_plan's view resolution
    for view in ("auto", "block", "staged-nd"):
        for stencil in (False, True):
            for je, pe in (("pallas", "cuda"), ("jnp", "torch")):
                jv = JP.adapt_plan(JPlan(je, bx=2, view=view), stencil=stencil,
                                   halo="periodic").view
                pv = PP.adapt_plan(PP.LoweringPlan(pe, bx=2, view=view), stencil=stencil).view
                assert pv == jv, (view, stencil, je)
    # the port's one difference: an untiled plan's bx is dropped for a
    # site-local launch (the reference keeps it and its validation raises)
    assert PP.adapt_plan(PP.LoweringPlan("cuda", vvl=32, bx=2), stencil=False).bx == 0
    assert PP.adapt_plan(PP.LoweringPlan("cuda", vvl=32, bx=2, by=2), stencil=False).bx == 2
    assert PP.adapt_plan(PP.LoweringPlan("cuda", vvl=32, bx=2), stencil=True).bx == 2


# -- layouts and halos --------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_block_helpers_and_halo_pad_physical_bitwise(spec, rng):
    """block_shape, block_index_map, block_to_canonical, canonical_to_block
    and halo_pad_physical bitwise the reference's; both raise where the
    reference raises."""
    lay, jlay = parse_layout(spec), JL.parse_layout(spec)
    ncomp, vvl = 3, 16
    x = rng.normal(size=(ncomp, 64)).astype(np.float32)
    assert lay.block_shape(ncomp, vvl) == jlay.block_shape(ncomp, vvl)
    assert lay.block_index_map()(3) == jlay.block_index_map()(3)
    phys = lay.pack(torch.from_numpy(x))
    jphys = np.asarray(jlay.pack(jnp.asarray(x)))
    np.testing.assert_array_equal(phys.numpy(), jphys)
    idx = lay.block_index_map()(1)
    shp = lay.block_shape(ncomp, vvl)
    sl = tuple(slice(i * s, (i + 1) * s) for i, s in zip(idx, shp))
    blk, jblk = phys[sl], jnp.asarray(jphys[sl])
    can = lay.block_to_canonical(blk, ncomp, vvl)
    np.testing.assert_array_equal(can.numpy(), np.asarray(jlay.block_to_canonical(jblk, ncomp,
                                                                                  vvl)))
    np.testing.assert_array_equal(can.numpy(), x[:, vvl:2 * vvl])
    back = lay.canonical_to_block(can, ncomp, vvl)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jlay.canonical_to_block(
        jnp.asarray(can.numpy()), ncomp, vvl)))
    # (4, 4, 4) padded by 1 is 216 sites, which SAL 16 does not divide: both raise
    lat = (4, 4, 4)
    for width in (0, 1, 2):
        try:
            want = np.asarray(JS.halo_pad_physical(jnp.asarray(jphys), jlay, ncomp, lat, width))
        except ValueError:
            with pytest.raises(ValueError, match="sal"):
                PS.halo_pad_physical(phys, lay, ncomp, lat, width)
            assert spec == "aosoa16" and width == 1
            continue
        np.testing.assert_array_equal(PS.halo_pad_physical(phys, lay, ncomp, lat, width).numpy(),
                                      want)
    if lay.kind.value == "aosoa":
        with pytest.raises(ValueError, match="sal"):
            jlay.block_shape(ncomp, lay.sal + 1)
        with pytest.raises(ValueError, match="sal"):
            lay.block_shape(ncomp, lay.sal + 1)


# -- tests/test_view.py's launches on the torch engine -----------------------------

@pytest.mark.parametrize("sal", [2, 4])
@pytest.mark.parametrize("bx", [1, 2, 3])
def test_graph_block_equals_staged_and_the_reference(sal, bx, rng):
    """test_view.py's graph at (6, 4, 8): the port's block and staged
    launches bitwise each other (z and zt); z within 1e-5 of the reference's
    pallas block launch; zt within rtol 1e-5 of the reference's staged zt."""
    x = rng.normal(size=(3,) + LAT).astype(np.float32)
    lay = parse_layout(f"aosoa{sal}")
    fx = Field.from_numpy("x", x, LAT, lay)
    g = _graph(LaunchGraph)
    staged, block = (g.launch({"x": fx}, config=TORCH, outputs=("z", "zt"), plan=p)
                     for p in _pplans(bx))
    assert block["z"].layout == lay
    assert torch.equal(staged["z"].data, block["z"].data)
    assert torch.equal(staged["zt"], block["zt"])
    jfx = JField.from_numpy("x", x, LAT, JL.aosoa(sal))
    jg = _graph(JLaunchGraph)
    js, jb = (jg.launch({"x": jfx}, config=PCFG, outputs=("z", "zt"), plan=p)
              for p in _jplans(bx))
    np.testing.assert_array_equal(block["z"].data.shape, np.asarray(jb["z"].data).shape)
    _close(block["z"].data.numpy(), np.asarray(jb["z"].data))
    # zt telescopes to ~0 (a periodic Laplacian), so rtol is taken of the
    # sum of the terms' magnitudes, as every sum parity test of the port
    terms = np.abs(block["z"].canonical().numpy()).sum(axis=1)
    assert np.all(np.abs(block["zt"].numpy() - np.asarray(js["zt"])) <= RTOL * terms)


@pytest.mark.parametrize("sal", [4, 8, 16])
def test_lb_step_block_equals_staged_and_the_reference(sal, rng):
    """The fused LB half-step at (4, 14, 16) (halo'd inner 16 x 18 = 288):
    block and staged bitwise, dist2 within 1e-5 of the reference's pallas
    block launch."""
    lat = (4, 14, 16)
    f0 = (1.0 + 0.1 * rng.normal(size=(19,) + lat)).astype(np.float32)
    frc = (0.01 * rng.normal(size=(3,) + lat)).astype(np.float32)
    lay = parse_layout(f"aosoa{sal}")
    ins = {"dist": Field.from_numpy("dist", f0, lat, lay),
           "force": Field.from_numpy("force", frc, lat, lay)}
    g = collide_propagate_graph(0.8)
    a, b = (g.launch(ins, config=TORCH, outputs=("dist2",), plan=p)["dist2"]
            for p in _pplans(2))
    assert torch.equal(a.data, b.data) and b.layout == lay
    jins = {"dist": JField.from_numpy("dist", f0, lat, JL.aosoa(sal)),
            "force": JField.from_numpy("force", frc, lat, JL.aosoa(sal))}
    jb = j_cp_graph(0.8).launch(jins, config=PCFG, outputs=("dist2",), plan=_jplans(2)[1])
    _close(b.data.numpy(), np.asarray(jb["dist2"].data))


def test_wilson_normal_block_equals_staged_and_the_reference():
    """The fused normal operator at (4, 4, 4, 4) in aosoa8 (ring-2 halos,
    halo'd inner 512): ap and pap bitwise across views, ap within 1e-5 of
    the reference's pallas block launch, pap within rtol 1e-5."""
    jcfg = JMilcConfig(lattice=(4, 4, 4, 4), kappa=0.1, layout=JL.aosoa(8))
    ju, jb = j_init(jcfg, seed=0)
    lay = parse_layout("aosoa8")
    u = Field("u", 72, (4, 4, 4, 4), lay, torch.from_numpy(np.array(ju.data)))
    b = Field("b", 24, (4, 4, 4, 4), lay, torch.from_numpy(np.array(jb.data)))
    g = PCG.wilson_normal_graph(0.1)
    a, o = (g.launch({"p": b, "u": u}, config=TORCH, outputs=("ap", "pap"), plan=p)
            for p in _pplans(2))
    assert torch.equal(a["ap"].data, o["ap"].data) and torch.equal(a["pap"], o["pap"])
    jo = JCG.wilson_normal_graph(0.1).launch({"p": jb, "u": ju}, config=PCFG,
                                             outputs=("ap", "pap"), plan=_jplans(2)[1])
    _close(o["ap"].data.numpy(), np.asarray(jo["ap"].data))
    np.testing.assert_allclose(o["pap"].numpy(), np.asarray(jo["pap"]), rtol=RTOL)


def test_mixed_layouts_block_equals_staged_and_the_reference(rng):
    """AoSoA and SoA inputs in one block-view launch, outputs in SoA and in
    AoSoA: bitwise across views, within 1e-5 of the reference's."""
    x = rng.normal(size=(3,) + LAT).astype(np.float32)
    f = (0.1 * rng.normal(size=(3,) + LAT)).astype(np.float32)

    def build(cls):
        return (cls("mixed")
                .add(lambda v: {"y": v["x"] + v["f"]}, {"x": "x", "f": "f"}, {"y": 3})
                .add_stencil(_lap_body, {"y": "y"}, {"z": 3}, width=1, params=dict(c=0.5)))

    ins = {"x": Field.from_numpy("x", x, LAT, parse_layout("aosoa4")),
           "f": Field.from_numpy("f", f, LAT, SOA)}
    jins = {"x": JField.from_numpy("x", x, LAT, JL.aosoa(4)),
            "f": JField.from_numpy("f", f, LAT, JL.SOA)}
    for out, jout in ((SOA, JL.SOA), (parse_layout("aosoa4"), JL.aosoa(4))):
        a, b = (build(LaunchGraph).launch(ins, config=TORCH, outputs=("z",),
                                          out_layouts={"z": out}, plan=p)["z"]
                for p in _pplans(3))
        assert torch.equal(a.data, b.data) and b.layout == out
        jb = build(JLaunchGraph).launch(jins, config=PCFG, outputs=("z",),
                                        out_layouts={"z": jout}, plan=_jplans(3)[1])["z"]
        _close(b.data.numpy(), np.asarray(jb.data))


# -- the refusals on the cuda engine ------------------------------------------------

def test_misaligned_block_views_raise_before_any_device(rng):
    """The reference's three errors: an AoSoA input whose SAL does not
    divide its halo'd inner plane, no AoSoA in the launch, an AoSoA output
    whose SAL does not divide the interior inner plane; each raised by the
    cuda engine on CPU fields before the device check, as the reference
    raises them; an explicit staged view and the "auto" default launch past
    the view check (to the kernel dispatch, which has no kernel for this
    test graph)."""
    x = rng.normal(size=(3,) + LAT).astype(np.float32)
    block = PP.LoweringPlan("cuda", vvl=96, bx=2, view="block")   # 96: SAL 3, 4 and 8 divide it
    jblock = _jplans(2)[1]
    cases = [("aosoa8", None, "halo'd inner-plane"), ("soa", None, "AoSoA"),
             ("aosoa4", "aosoa3", "interior inner-plane")]
    for spec, out, word in cases:
        outs = {"z": parse_layout(out)} if out else None
        jouts = {"z": JL.parse_layout(out)} if out else None
        with pytest.raises(ValueError, match=word):
            _graph(JLaunchGraph).launch({"x": JField.from_numpy("x", x, LAT,
                                                                JL.parse_layout(spec))},
                                        config=PCFG, outputs=("z",), out_layouts=jouts,
                                        plan=jblock)
        fx = Field.from_numpy("x", x, LAT, parse_layout(spec))
        with pytest.raises(ValueError, match=word):
            _graph(LaunchGraph).launch({"x": fx}, config=CUDA_ON_CPU, outputs=("z",),
                                       out_layouts=outs, plan=block)
    fx = Field.from_numpy("x", x, LAT, parse_layout("aosoa8"))
    for plan in (dataclasses.replace(block, view="staged-nd"), dataclasses.replace(block,
                                                                                    view="auto")):
        with pytest.raises(ValueError, match="no hand-written CUDA kernel"):
            _graph(LaunchGraph).launch({"x": fx}, config=CUDA_ON_CPU, outputs=("z",), plan=plan)

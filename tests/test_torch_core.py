"""Port parity: site-local launches, reductions and fused launch graphs
against the JAX package (its jnp engine, and pallas in interpret mode),
plus the cuda engine's refusals and the kernel wrappers' CPU behaviour."""

import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.apps.milc import cg as JCG  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import target_max as j_max  # noqa: E402
from repro.core import target_sum as j_sum  # noqa: E402
from repro_torch import _cuda  # noqa: E402
from repro_torch.apps.milc import cg as PCG  # noqa: E402
from repro_torch.core import AOS, aosoa  # noqa: E402
from repro_torch.core import Field as PField  # noqa: E402
from repro_torch.core import LaunchGraph, LoweringPlan, TargetConfig, launch  # noqa: E402
from repro_torch.core import fuse, reduce, target  # noqa: E402
from repro_torch.core import target_max as p_max  # noqa: E402
from repro_torch.core import target_sum as p_sum  # noqa: E402

LAT = (4, 4, 2, 8)
TORCH = TargetConfig("torch", device="cpu")
CUDA_ON_CPU = TargetConfig("cuda", device="cpu")
JAX_ENGINES = [JTC("jnp"), JTC("pallas", vvl=128)]
JIDS = ["jnp", "pallas"]
FIELD_RTOL, SUM_RTOL = 1e-6, 1e-5


def _fields(rng, n=2, ncomp=24, lat=LAT):
    arrs = [rng.normal(size=(ncomp,) + lat).astype(np.float32) for _ in range(n)]
    return (arrs, [JField.from_numpy(f"f{i}", a, lat) for i, a in enumerate(arrs)],
            [PField.from_numpy(f"f{i}", a, lat) for i, a in enumerate(arrs)])


@pytest.mark.parametrize("jcfg", JAX_ENGINES, ids=JIDS)
def test_site_local_launches_match(jcfg, rng):
    _, (jx, jy), (px, py) = _fields(rng)
    np.testing.assert_allclose(PCG.g5(px, TORCH).to_numpy(),
                               np.asarray(JCG.g5(jx, jcfg).to_numpy()), rtol=FIELD_RTOL)
    np.testing.assert_allclose(PCG.axpy(0.75, px, py, TORCH).to_numpy(),
                               np.asarray(JCG.axpy(0.75, jx, jy, jcfg).to_numpy()),
                               rtol=FIELD_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(PCG.dot(px, py, TORCH)),
                               float(JCG.dot(jx, jy, jcfg)), rtol=SUM_RTOL)


@pytest.mark.parametrize("jcfg", JAX_ENGINES, ids=JIDS)
def test_reductions_match(jcfg, rng):
    _, (jx,), (px,) = _fields(rng, n=1, ncomp=5)
    np.testing.assert_allclose(p_sum(px, TORCH).numpy(), np.asarray(j_sum(jx, jcfg)),
                               rtol=SUM_RTOL, atol=1e-5)
    np.testing.assert_array_equal(p_max(px, TORCH).numpy(), np.asarray(j_max(jx, jcfg)))


def test_reduce_spec():
    parts = torch.tensor([[1.0, 5.0], [3.0, 2.0], [-1.0, 7.0]])
    assert fuse.ReduceSpec("max").fold(parts, 0).tolist() == [3.0, 7.0]
    assert fuse.ReduceSpec("sum").fold(parts, 0).tolist() == [3.0, 14.0]
    assert fuse.ReduceSpec("max").combine(parts[0], parts[1]).tolist() == [3.0, 5.0]
    specs = PCG.wilson_normal_graph(0.1).reduce_specs()
    assert specs == {"pap": fuse.ReduceSpec("sum", source="pap_prod", ncomp=24)}
    with pytest.raises(ValueError):
        fuse.ReduceSpec("prod")


@pytest.mark.parametrize("jcfg", JAX_ENGINES, ids=JIDS)
def test_cg_update_and_xpay_graphs_match(jcfg, rng):
    _, jf, pf = _fields(rng, n=4)
    ins = dict(zip(("x", "r", "p", "ap"), pf))
    jins = dict(zip(("x", "r", "p", "ap"), jf))
    pout = PCG.cg_update_graph(24).launch(
        ins, scalars={"alpha": 0.37, "neg_alpha": -0.37}, config=TORCH,
        outputs=("x_new", "r_new", "rr"))
    jout = JCG.cg_update_graph(24).launch(
        jins, scalars={"alpha": 0.37, "neg_alpha": -0.37}, config=jcfg,
        outputs=("x_new", "r_new", "rr"))
    for k in ("x_new", "r_new"):
        np.testing.assert_allclose(pout[k].to_numpy(), np.asarray(jout[k].to_numpy()),
                                   rtol=FIELD_RTOL, atol=1e-6)
    np.testing.assert_allclose(pout["rr"].numpy(), np.asarray(jout["rr"]).reshape(-1),
                               rtol=SUM_RTOL)
    px = PCG.fused_xpay(pf[0], torch.tensor(0.25), pf[1], TORCH)
    jx = JCG.fused_xpay(jf[0], 0.25, jf[1], jcfg)
    np.testing.assert_allclose(px.to_numpy(), np.asarray(jx.to_numpy()),
                               rtol=FIELD_RTOL, atol=1e-6)


def test_wilson_normal_graph_matches(rng):
    lat = (4, 4, 4, 4)
    arrs, jf, pf = _fields(rng, n=1, lat=lat)
    from repro.apps.milc import fields as JF

    u = JF.random_su3_gauge(lat, seed=2, hot=0.6)
    ju, pu = JField.from_numpy("u", u, lat), PField.from_numpy("u", u, lat)
    for jcfg in JAX_ENGINES:
        jap, jpap = JCG.make_fused_normal(ju, 0.12, jcfg)(jf[0])
        pap, ppap = PCG.make_fused_normal(pu, 0.12, TORCH)(pf[0])
        np.testing.assert_allclose(pap.to_numpy(), np.asarray(jap.to_numpy()),
                                   rtol=FIELD_RTOL, atol=1e-5)
        np.testing.assert_allclose(float(ppap), float(jpap), rtol=SUM_RTOL)


def test_graph_analysis_matches():
    jg, pg = JCG.wilson_normal_graph(0.1), PCG.wilson_normal_graph(0.1)
    assert pg.halo_widths(["ap", "pap"]) == jg.halo_widths(["ap", "pap"]) == {"p": 2, "u": 2}
    assert pg.external_inputs() == jg.external_inputs()
    ncomp = {"p": 24, "u": 72}
    assert pg.bytes_moved(ncomp, 4096, outputs=["ap"]) == jg.bytes_moved(
        ncomp, 4096, outputs=["ap"])
    cu = PCG.cg_update_graph(24)
    assert cu.bytes_moved({k: 24 for k in "x r p ap".split()}, 64) == JCG.cg_update_graph(
        24).bytes_moved({k: 24 for k in "x r p ap".split()}, 64)
    # the kernel registry keys on structure, not on param values
    assert PCG.wilson_normal_graph(0.1).structure() == PCG.wilson_normal_graph(0.2).structure()
    assert pg.stage_params()[1] == {"kappa": 0.1}


def test_bind_and_graph_errors(rng):
    _, _, (px, py) = _fields(rng)
    g = LaunchGraph("g").add(PCG._mul_body, {"x": "x", "y": "y"}, {"out": 24})
    bound = g.bind(config=TORCH)
    np.testing.assert_array_equal(bound({"x": px, "y": py})["out"].to_numpy(),
                                  px.to_numpy() * py.to_numpy())
    with pytest.raises(ValueError, match="not supplied"):
        g.launch({"x": px}, config=TORCH)
    with pytest.raises(ValueError, match="produced twice"):
        g.add(PCG._mul_body, {"x": "x", "y": "y"}, {"out": 24})
    with pytest.raises(ValueError, match="follow a reduction"):
        LaunchGraph().add_reduce("x").add(PCG._mul_body, {"x": "x", "y": "x"}, {"out": 1})
    # "pre" and "overlap" (tests/test_torch_halo.py, tests/test_torch_overlap.py)
    # apply to stencil graphs only
    with pytest.raises(ValueError, match="stencil"):
        g.launch({"x": px, "y": py}, config=TORCH, halo="overlap")


# -- the cuda engine's refusals (no card needed) --------------------------------

def test_cuda_engine_refuses_cpu_tensors(rng):
    _, _, (px, py) = _fields(rng)
    with pytest.raises(ValueError, match="CUDA device"):
        PCG.g5(px, CUDA_ON_CPU)
    with pytest.raises(ValueError, match="CUDA device"):
        p_sum(px, CUDA_ON_CPU)
    with pytest.raises(ValueError, match="CUDA device"):
        PCG.fused_xpay(px, 0.5, py, CUDA_ON_CPU)
    from repro_torch.kernels.wilson_dslash import dslash

    with pytest.raises(ValueError, match="CUDA device"):
        dslash(px, px, config=CUDA_ON_CPU)


def test_cuda_engine_refuses_unregistered_bodies_and_layouts(rng):
    _, _, (px, py) = _fields(rng)
    with pytest.raises(ValueError, match="no hand-written CUDA kernel"):
        launch(lambda v: {"o": v["x"] + 1}, {"x": px}, {"o": 24}, config=CUDA_ON_CPU)
    g = LaunchGraph("other").add(PCG._square_body, {"x": "x"}, {"out": 24})
    with pytest.raises(ValueError, match="no hand-written CUDA kernel"):
        g.launch({"x": px}, config=CUDA_ON_CPU)
    for lay in (AOS, aosoa(8)):
        f = PField.from_numpy("f", px.to_numpy(), LAT, lay)
        # the layout is accepted: what refuses is the CPU tensor
        with pytest.raises(ValueError, match="CUDA device"):
            PCG.g5(f, CUDA_ON_CPU)
    # the reference's rules refuse before any launch: SAL must divide vvl;
    # a tiled plan takes every layout (K9 in AoS: the CPU fields refuse)
    f = PField.from_numpy("f", px.to_numpy(), LAT, aosoa(64))
    with pytest.raises(ValueError, match="multiple of AoSoA sal=64"):
        PCG.g5(f, TargetConfig("cuda", device="cpu", plan_policy=LoweringPlan("cuda", 32)))
    from repro_torch.kernels.lb_propagation.ops import collide_propagate

    lat = (4, 4, 4)
    dist, force = (PField.from_numpy(n, rng.normal(size=(c,) + lat).astype(np.float32), lat,
                                     AOS) for n, c in (("dist", 19), ("force", 3)))
    with pytest.raises(ValueError, match="CUDA device"):
        collide_propagate(dist, force, tau=0.8,
                          config=TargetConfig("cuda", device="cpu", smem_bytes=6512))
    with pytest.raises(ValueError, match="produces"):
        PCG.cg_update_graph(24).launch(
            {"x": px, "r": px, "p": px, "ap": px}, scalars={"alpha": 1.0, "neg_alpha": -1.0},
            config=CUDA_ON_CPU, outputs=("rr_prod",))


def test_kernel_wrappers_on_cpu_are_the_plain_versions(rng):
    x = torch.from_numpy(rng.normal(size=(24, 256)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(24, 256)).astype(np.float32))
    a = torch.tensor(0.3)
    assert torch.equal(target.site_g5(x, 12), target.g5_plain(x, 12))
    assert torch.equal(target.site_mul(x, y), x * y)
    assert torch.equal(target.site_axpy(0.5, x, y), x * 0.5 + y)
    assert torch.equal(reduce.reduce_sites(x, "max"), x.amax(dim=1))
    assert torch.equal(reduce.fold_partials(x.T, "sum"), x.sum(dim=1))
    got = fuse.cg_update(x, y, y, x, a, -a)
    want = fuse.cg_update_plain(x, y, y, x, a, -a)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(fuse.cg_xpay(x, y, a), y + a * x)
    before = [k.launches for k in (target.G5, target.MUL, fuse.CG_UPDATE)]
    assert before == [k.launches for k in (target.G5, target.MUL, fuse.CG_UPDATE)]


def test_kernel_library_declares_every_entry_point():
    """Every C entry point the wrappers call is defined in csrc, and nothing
    was built on import (the CPU tests never need nvcc)."""
    src = "".join(p.read_text() for p in _cuda.CSRC.glob("*.cu"))
    for name, argtypes in _cuda.SIGNATURES.items():
        m = re.search(r"int %s\(([^)]*)\)" % name, src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
    assert _cuda.library.cache_info().currsize == 0
    for flag in ("arch=compute_90a,code=sm_90a", "-O3", "-shared"):
        assert flag in _cuda.NVCC_FLAGS

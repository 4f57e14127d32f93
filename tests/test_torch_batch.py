"""Port parity for the batch axis (multi-simulation serving): BatchedField,
batched launches and reductions, the fixed-order component fold, the
masked CG update chain and the batch instances' plain versions.

Ported from tests/test_batch.py (the periodic cases; the "pre"/"overlap"
halo cases wait for the sharded path): a batched launch is per slot
bitwise the single launch, and the port's batched launches and masked
chain are held against the JAX package's jnp engine on the same numpy
inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.apps.milc import cg as JCG  # noqa: E402
from repro.core import BatchedField as JBatchedField  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import LaunchGraph as JLaunchGraph  # noqa: E402
from repro.core import TargetConfig as JTargetConfig  # noqa: E402
from repro.core import parse_layout as j_parse_layout  # noqa: E402
from repro.core import target_sum as j_target_sum  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps.milc import cg as CG  # noqa: E402
from repro_torch.core import (AOS, SOA, BatchedField, Field, LaunchGraph, LoweringPlan,  # noqa: E402
                              TargetConfig, aosoa, fuse, parse_layout, reduce, target,
                              target_sum)
from repro_torch.kernels.wilson_dslash import kernel as K  # noqa: E402

LAT = (4, 4, 8)  # 128 sites
B = 3
LAYOUTS = [AOS, SOA, aosoa(32)]
TORCH = TargetConfig("torch", device="cpu", vvl=64)
JNP = JTargetConfig("jnp", vvl=64)
FIELD_RTOL = 1e-6  # fp32 site-local stages (ROADMAP "held against")
SUM_RTOL = 1e-5    # |port - reference| <= SUM_RTOL * sum|terms|


def _fma(v):
    return {"out": v["y"] + v["a"] * v["x"]}


def _sq(v):
    return {"p": v["out"] * v["out"]}


def _sten(v, gather):
    return {"s": v["x"] + 0.5 * gather("x", (1, 0, 0)) - gather("x", (0, -1, 0))}


def _arr(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _mkb(name, arr, lay, lat=LAT):
    return BatchedField.from_canonical(name, torch.from_numpy(arr), lat, lay)


def _mk1(name, arr, lay, lat=LAT):
    return Field.from_numpy(name, arr, lat, lay)


def _jb(name, arr, lay, lat=LAT):
    return JBatchedField.from_canonical(name, jnp.asarray(arr), lat, j_parse_layout(lay.name))


def _j1(name, arr, lay, lat=LAT):
    return JField.from_numpy(name, arr, lat, j_parse_layout(lay.name))


def _bits(a, b):
    """Bitwise equality (NaN included, which torch.equal calls unequal)."""
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _close(got, want, rtol=FIELD_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _flat_graph(G):
    return (G("bflat")
            .add(_fma, {"x": "x", "y": "y", "a": "a"}, {"out": 3})
            .add(_sq, {"out": "out"}, {"p": 3})
            .add_reduce("p", "sum", name="ps"))


@pytest.mark.parametrize("lay", LAYOUTS, ids=lambda l: l.name)
def test_batched_flat_chain_bitwise_vs_loop(lay, rng):
    """Site-local chain + fused reduce: batched x, SHARED y, per-request
    scalar a: every slot bitwise its single-Field launch; the whole batch
    within tolerance of the JAX package's batched launch."""
    xa, ya = _arr(rng, B, 3, *LAT), _arr(rng, 3, *LAT)
    a = np.asarray([0.5, -1.25, 2.0], np.float32)
    g = _flat_graph(LaunchGraph)
    bx, y = _mkb("x", xa, lay), _mk1("y", ya, lay)
    outb = g.launch({"x": bx, "y": y}, scalars={"a": torch.from_numpy(a)}, config=TORCH,
                    outputs=("out", "ps"))
    assert isinstance(outb["out"], BatchedField) and outb["out"].batch == B
    assert outb["out"].layout == lay and outb["ps"].shape == (B, 3)
    for b in range(B):
        o1 = g.launch({"x": bx.element(b), "y": y}, scalars={"a": float(a[b])}, config=TORCH,
                      outputs=("out", "ps"))
        assert torch.equal(outb["out"].element(b).data, o1["out"].data)
        assert torch.equal(outb["ps"][b], o1["ps"])
    jout = _flat_graph(JLaunchGraph).launch(
        {"x": _jb("x", xa, lay), "y": _j1("y", ya, lay)}, scalars={"a": jnp.asarray(a)},
        config=JNP, outputs=("out", "ps"))
    _close(outb["out"].to_numpy(), jout["out"].to_numpy())
    terms = (outb["out"].canonical() ** 2).abs().sum(dim=-1).numpy()
    assert np.all(np.abs(outb["ps"].numpy() - np.asarray(jout["ps"])) <= SUM_RTOL * terms)


@pytest.mark.parametrize("lay", LAYOUTS, ids=lambda l: l.name)
def test_batched_stencil_periodic_bitwise_vs_loop(lay, rng):
    xa = _arr(rng, B, 3, *LAT)
    g = LaunchGraph("bsten").add_stencil(_sten, {"x": "x"}, {"s": 3}, width=1)
    bx = _mkb("x", xa, lay)
    outb = g.launch({"x": bx}, config=TORCH)
    for b in range(B):
        o1 = g.launch({"x": bx.element(b)}, config=TORCH)
        assert torch.equal(outb["s"].element(b).data, o1["s"].data)
    jout = JLaunchGraph("bsten").add_stencil(_sten, {"x": "x"}, {"s": 3}, width=1).launch(
        {"x": _jb("x", xa, lay)}, config=JNP)
    _close(outb["s"].to_numpy(), jout["s"].to_numpy())


@pytest.mark.parametrize("lay", LAYOUTS, ids=lambda l: l.name)
def test_batched_target_sum_bitwise_vs_loop(lay, rng):
    xa = _arr(rng, B, 3, *LAT)
    bx = _mkb("x", xa, lay)
    ts = target_sum(bx, TORCH)
    assert ts.shape == (B, 3)
    for b in range(B):
        assert torch.equal(ts[b], target_sum(bx.element(b), TORCH))
    jts = np.asarray(j_target_sum(_jb("x", xa, lay), JNP))
    assert np.all(np.abs(ts.numpy() - jts) <= SUM_RTOL * np.abs(xa).reshape(B, 3, -1).sum(-1))


def test_batched_scalar_shape_rejected(rng):
    g = LaunchGraph("bs").add(_fma, {"x": "x", "y": "y", "a": "a"}, {"out": 3})
    bx, y = _mkb("x", _arr(rng, B, 3, *LAT), SOA), _mk1("y", _arr(rng, 3, *LAT), SOA)
    with pytest.raises(ValueError, match="scalar"):
        g.launch({"x": bx, "y": y}, scalars={"a": torch.zeros(B + 1)}, config=TORCH)
    # the cuda engine refuses the same shape before looking for a kernel
    with pytest.raises(ValueError, match="per-request vector"):
        g.launch({"x": bx, "y": y}, scalars={"a": torch.zeros((B, 1))},
                 config=TargetConfig("cuda", vvl=64))


def test_mismatched_batch_sizes_rejected(rng):
    g = LaunchGraph("bm").add(lambda v: {"out": v["x"] + v["y"]}, {"x": "x", "y": "y"},
                              {"out": 3})
    bx = _mkb("x", _arr(rng, 2, 3, *LAT), SOA)
    by = _mkb("y", _arr(rng, 3, 3, *LAT), SOA)
    with pytest.raises(ValueError, match="batch"):
        g.launch({"x": bx, "y": by}, config=TORCH)


def test_batched_field_roundtrip_and_slots(rng):
    bx = _mkb("x", _arr(rng, B, 3, *LAT), aosoa(32))
    fields = bx.unstack()
    assert len(fields) == B
    assert torch.equal(BatchedField.stack(fields, name="x").data, bx.data)
    # slot write: only the written slot's bits move, and bx itself is untouched
    before = bx.data.clone()
    f = _mk1("x", _arr(rng, 3, *LAT), SOA)
    up = bx.with_element(1, f)
    assert torch.equal(bx.data, before)
    assert torch.equal(up.element(0).data, bx.element(0).data)
    assert torch.equal(up.element(2).data, bx.element(2).data)
    assert torch.equal(up.element(1).canonical(), f.canonical())
    # canonical views, relayout and zeros
    assert torch.equal(bx.canonical()[2], bx.element(2).canonical())
    assert bx.canonical_nd().shape == (B, 3) + LAT
    assert torch.equal(bx.as_layout(AOS).as_layout(aosoa(32)).data, bx.data)
    z = BatchedField.zeros("z", 2, 3, LAT, AOS)
    assert z.data.shape == (2, 128, 3) and not z.data.any()
    with pytest.raises(ValueError, match="cannot stack"):
        BatchedField.stack([fields[0], fields[1].as_layout(SOA)])
    with pytest.raises(ValueError, match="physical shape"):
        bx.with_data(bx.data[:2])


@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa8"])
def test_convert_batched_field_bitwise(spec, rng):
    arr = _arr(rng, B, 24, *LAT)
    jb = _jb("psi", arr, parse_layout(spec))
    pb = convert.to_batched_field("psi", np.asarray(jb.data), jb.lattice, jb.layout.name,
                                  jb.ncomp)
    assert (pb.batch, pb.layout.name, pb.lattice) == (B, spec, LAT)
    np.testing.assert_array_equal(pb.to_numpy(), arr)
    phys, lat, name, ncomp = convert.from_batched_field(pb)
    np.testing.assert_array_equal(phys, np.asarray(jb.data))
    assert (lat, name, ncomp) == (LAT, spec, 24)


def test_fold_components_rows_do_not_depend_on_the_shape(rng):
    """The fixed-order component fold: each row of a (B, 24) fold is bitwise
    the fold of that row alone, and equals the sum to a tolerance."""
    v = torch.from_numpy(_arr(rng, 5, 24) * 1e3)
    rows = reduce.fold_components(v)
    for b in range(5):
        assert torch.equal(rows[b], reduce.fold_components(v[b]))
        assert torch.equal(rows[b], reduce.fold_components(v[b:b + 1])[0])
    np.testing.assert_allclose(rows.numpy(), v.double().sum(-1).numpy(), rtol=1e-5)
    for n in (1, 2, 3, 7):
        w = torch.from_numpy(_arr(rng, n))
        assert abs(float(reduce.fold_components(w)) - float(w.double().sum())) < 1e-5


def _masked_inputs(rng, lat=(2, 2, 2, 4), batch=4):
    """x, r, p, ap (batch, 24, *lat), alpha and m (batch,): slot 1 frozen
    with a NaN in its p and ap; slot 3 frozen with -0.0 and a NaN in its x
    and r (the y inputs the select passes through)."""
    x, r, p, ap = (_arr(rng, batch, 24, *lat) for _ in range(4))
    alpha = np.asarray([0.37, -1.5, 0.25, 2.0], np.float32)[:batch]
    m = np.asarray([1, 0, 1, 0], np.float32)[:batch]
    p[1, 3, 0, 0, 0, 1] = ap[1, 5, 1, 0, 0, 0] = np.nan
    x[3, 0, 0, 0, 0, 0] = r[3, 2, 1, 1, 1, 3] = -0.0
    x[3, 7, 0, 1, 0, 2] = r[3, 9, 1, 0, 1, 0] = np.nan
    return (x, r, p, ap), alpha, m


@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa8"])
def test_masked_update_chain_against_reference(spec, rng):
    """The masked CG update chain (one launch over the batch) with the same
    (B,) alpha and mask in both packages: live slots within rtol 1e-6,
    frozen slots bitwise their inputs, -0.0 and NaN preserved; the masked
    xpay likewise."""
    lat = (2, 2, 2, 4)
    (x, r, p, ap), alpha, m = _masked_inputs(rng, lat)
    lay = parse_layout(spec)
    pf = [_mkb(n, a, lay, lat) for n, a in zip("xrpa", (x, r, p, ap))]
    jf = [_jb(n, a, lay, lat) for n, a in zip("xrpa", (x, r, p, ap))]
    xn, rn, rr = CG.fused_masked_cg_update(*pf, torch.from_numpy(alpha), torch.from_numpy(m),
                                           TORCH)
    jx, jr, jrr = JCG.fused_masked_cg_update(*jf, jnp.asarray(alpha), jnp.asarray(m),
                                             JTargetConfig("jnp"))
    assert isinstance(xn, BatchedField) and xn.layout == lay and rr.shape == (4, 24)
    got_x, got_r = xn.to_numpy(), rn.to_numpy()
    for b in (1, 3):  # frozen: the y inputs' bits, NaN and -0.0 included
        assert got_x[b].tobytes() == x[b].tobytes() and got_r[b].tobytes() == r[b].tobytes()
    assert np.signbit(got_x[3, 0, 0, 0, 0, 0]) and np.signbit(got_r[3, 2, 1, 1, 1, 3])
    for b in (0, 2):
        _close(got_x[b], np.asarray(jx.to_numpy())[b])
        _close(got_r[b], np.asarray(jr.to_numpy())[b])
        terms = (got_r[b].reshape(24, -1) ** 2).sum(-1)
        assert np.all(np.abs(rr[b].numpy() - np.asarray(jrr)[b]) <= SUM_RTOL * terms)
    # the kernel wrapper's plain version is the same select
    px, pr, prr = fuse.cg_update_masked(*(f.data for f in pf), torch.from_numpy(alpha),
                                        torch.from_numpy(-alpha), torch.from_numpy(m),
                                        layouts={n: lay for n in ("x", "r", "p", "ap")})
    assert _bits(px, xn.data) and _bits(pr, rn.data)
    np.testing.assert_allclose(prr.numpy(), rr.numpy(), rtol=1e-6)
    # the masked xpay: r + beta p where live, r's bits where frozen
    beta = torch.from_numpy(alpha[::-1].copy())
    pn = CG.fused_masked_xpay(pf[1], beta, pf[2], torch.from_numpy(m), TORCH)
    jpn = JCG.fused_masked_xpay(jf[1], jnp.asarray(beta.numpy()), jf[2], jnp.asarray(m),
                                JTargetConfig("jnp"))
    got_p = pn.to_numpy()
    for b in (1, 3):
        assert got_p[b].tobytes() == r[b].tobytes()
    for b in (0, 2):
        _close(got_p[b], np.asarray(jpn.to_numpy())[b])
    assert _bits(fuse.cg_xpay_masked(pf[2].data, pf[1].data, beta, torch.from_numpy(m),
                                     layouts={"x": lay, "y": lay}), pn.data)


@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa8"])
def test_batch_kernels_plain_versions_equal_single_ones_per_slot(spec, rng):
    """K3B, K5B and K2B's plain versions on stacked tensors: each slot
    bitwise the single wrapper's plain version on that slot (fields), the
    live masked slot the unmasked update's."""
    lat = (2, 2, 2, 4)
    lay = parse_layout(spec)
    lays = {n: lay for n in ("x", "r", "p", "ap")}
    (x, r, p, ap), alpha, m = _masked_inputs(rng, lat)
    x, r, p, ap = (_mkb(n, a, lay, lat).data for n, a in zip("xrpa", (x, r, p, ap)))
    al, ml = torch.from_numpy(alpha), torch.from_numpy(m)
    bx, br, _ = fuse.cg_update_masked(x, r, p, ap, al, -al, ml, layouts=lays)
    for b in (0, 2):
        sx, sr, _ = fuse.cg_update(x[b], r[b], p[b], ap[b], al[b], -al[b], layouts=lays)
        assert torch.equal(bx[b], sx) and torch.equal(br[b], sr)
        assert torch.equal(fuse.cg_xpay_masked(p, r, al, ml, layouts={"x": lay, "y": lay})[b],
                           fuse.cg_xpay(p[b], r[b], al[b], layouts={"x": lay, "y": lay}))
    shared = fuse.cg_xpay_masked(p, r[0], al, ml, layouts={"x": lay, "y": lay})
    for b in range(4):  # a shared y: every slot reads r[0]
        want = (fuse.cg_xpay(p[b], r[0], al[b], layouts={"x": lay, "y": lay}) if b in (0, 2)
                else r[0])
        assert _bits(shared[b], want)
    prod = target.site_mul(x, r, layouts={"x": lay, "y": lay}, batch=4)
    u = Field.from_numpy("u", _arr(rng, 72, *lat), lat, lay).data
    q = _mkb("q", _arr(rng, 2, 24, *lat), lay, lat).data
    ap_b, pap_b = K.wilson_normal_cuda(q, u, 0.12, lat, layouts={"p": lay, "u": lay},
                                       batched=True)
    assert pap_b.shape == (2, 24)
    for b in range(2):
        ap1, pap1 = K.wilson_normal_cuda(q[b], u, 0.12, lat, layouts={"p": lay, "u": lay})
        assert torch.equal(ap_b[b], ap1) and torch.equal(pap_b[b], pap1)
    sums = reduce.reduce_sites_batched(prod[[0, 2]], "sum", layouts={"x": lay})
    for k, b in enumerate((0, 2)):
        assert torch.equal(prod[b], torch.mul(x[b], r[b]))
        assert torch.equal(sums[k], reduce.reduce_sites(prod[b], "sum", layouts={"x": lay}))
    parts = torch.from_numpy(_arr(rng, 3, 5, 24))
    folded = reduce.fold_partials_batched(parts, "max")
    for b in range(3):
        assert torch.equal(folded[b], reduce.fold_partials(parts[b], "max"))


def test_batched_launches_refused_where_the_port_refuses_them(rng):
    """A tiled plan with a batch runs a graph's tiled batch instance (K5T's
    for wilson_normal: the launch passes the plan checks and refuses CPU
    fields) and raises for a graph without one (a stencil test graph, the
    Ludwig LB step); a batched cuda launch of a graph with no batch
    instance, and a cuda launch of CPU fields, raise."""
    bx = _mkb("x", _arr(rng, 2, 3, *LAT), SOA)
    sten = LaunchGraph("bsten").add_stencil(_sten, {"x": "x"}, {"s": 3}, width=1)
    tiled = LoweringPlan("cuda", vvl=32, bx=1, by=2)
    with pytest.raises(ValueError, match="no hand-written tiled batched kernel"):
        sten.launch({"x": bx}, plan=tiled)
    from repro_torch.apps.ludwig import LudwigConfig
    from repro_torch.apps.ludwig import driver as LD

    lb = {n: _mkb(n, _arr(rng, 2, nc, *LAT), SOA) for n, nc in (("dist", 19), ("force", 3))}
    with pytest.raises(ValueError, match="no hand-written tiled batched kernel.*ludwig_lb_step"):
        LD.lb_step_graph(LudwigConfig()).launch(lb, plan=tiled, outputs=("dist2", "u"))
    lat4 = (2, 2, 4, 4)
    u = Field.from_numpy("u", _arr(rng, 72, *lat4), lat4)
    p = _mkb("p", _arr(rng, 2, 24, *lat4), SOA, lat4)
    with pytest.raises(ValueError, match="CUDA device"):
        CG.make_fused_normal(u, 0.12, TargetConfig("cuda", device="cpu", plan_policy=tiled))(p)
    with pytest.raises(ValueError, match="no hand-written batched CUDA kernel"):
        sten.launch({"x": bx}, config=TargetConfig("cuda", vvl=64))
    # the masked graphs have only a batch instance
    with pytest.raises(ValueError, match="no hand-written CUDA kernel"):
        CG.masked_xpay_graph(24).launch(
            {"x": Field.from_numpy("x", _arr(rng, 24, *LAT), LAT),
             "y": Field.from_numpy("y", _arr(rng, 24, *LAT), LAT)},
            scalars={"a": 1.0, "m": 1.0}, config=TargetConfig("cuda", vvl=64))
    by = _mkb("y", _arr(rng, 2, 24, *LAT), SOA)
    with pytest.raises(ValueError, match="CUDA device"):
        CG.batched_dot(by, by, TargetConfig("cuda", vvl=64))


@pytest.mark.parametrize("spec", ["soa", "aos"])
def test_k5t_batched_plain_against_reference_batched_tiled_launch(spec, rng):
    """K5T's batch instance, plain: 2 stacked spinors against one u under a
    tile, against the reference's batched tiled wilson_normal launch
    (pallas, interpret) and each slot bitwise the single K5T and K5B plain
    versions' fields."""
    from repro.core import LoweringPlan as JPlan

    lat, tile = (4, 4, 4, 8), (2, 2, 2)
    lay = parse_layout(spec)
    from repro_torch.apps.milc import fields as PF

    u_np = PF.random_su3_gauge(lat, seed=3, hot=0.6)
    ps = _arr(rng, 2, 24, *lat)
    u = lay.pack(torch.from_numpy(u_np).reshape(72, -1))
    q = torch.stack([lay.pack(torch.from_numpy(p).reshape(24, -1)) for p in ps])
    L = {"p": lay, "u": lay, "ap": lay}
    ap, pap = K.wilson_normal_tiled_cuda(q, u, 0.12, lat, tile, layouts=L, batched=True)
    k5b_ap, _ = K.wilson_normal_cuda(q, u, 0.12, lat, layouts=L, batched=True)
    assert torch.equal(ap, k5b_ap)
    for b in range(2):
        one = K.wilson_normal_tiled_cuda(q[b], u, 0.12, lat, tile, layouts=L)
        assert torch.equal(ap[b], one[0]) and torch.equal(pap[b], one[1])
    jout = JCG.wilson_normal_graph(0.12).launch(
        {"p": JBatchedField.from_canonical("p", jnp.asarray(ps), lat, j_parse_layout(spec)),
         "u": JField.from_numpy("u", u_np, lat, j_parse_layout(spec))},
        config=JTargetConfig("pallas", vvl=128), outputs=("ap", "pap"),
        plan=JPlan("pallas", bx=2, by=2, bz=2, interpret=True))
    for b in range(2):
        want = np.asarray(jout["ap"].element(b).to_numpy()).reshape(24, -1)
        got = lay.unpack(ap[b]).numpy()
        np.testing.assert_allclose(got, want, rtol=FIELD_RTOL, atol=FIELD_RTOL * np.abs(want).max())
        jp = np.asarray(jout["pap"])[b]
        terms = np.abs(ps[b].reshape(24, -1) * want).sum(axis=1)
        assert (np.abs(pap[b].numpy() - jp) <= 1e-5 * terms).all()

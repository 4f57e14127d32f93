"""Port parity for mixed precision (the DtypePolicy lowering axis): the
policy and its accumulate resolution, Kahan folding, tests/test_dtype.py's
contracts on the port's torch engine, the plain versions of the cuda
engine's policy instances (K5/K5B, K5L, K3/K3B fed a bf16 ap, K3's and
K3L's policy instances, K2's compensated sum) against the JAX package's
launches under the same policy,
the refined MILC solve, and the refusals of what is not yet ported
(Ludwig's bf16 LB storage and refined serving are in
tests/test_torch_dtype_serving.py).

The JAX side runs on the jnp engine (or pallas in interpret mode, as the
JAX package's own tests run it); inputs are numpy arrays from a seed."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.apps.ludwig import LudwigConfig as JLudwigConfig  # noqa: E402
from repro.apps.ludwig import driver as JLD  # noqa: E402
from repro.apps.milc import cg as JCG  # noqa: E402
from repro.apps.milc import driver as JMD  # noqa: E402
from repro.core import AOS as J_AOS  # noqa: E402
from repro.core import SOA as J_SOA  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import LaunchGraph as JLaunchGraph  # noqa: E402
from repro.core import LoweringPlan as JPlan  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import aosoa as j_aosoa  # noqa: E402
from repro.core import fuse as JF  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import target_sum as j_target_sum  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig  # noqa: E402
from repro_torch.apps.ludwig import driver as PLD  # noqa: E402
from repro_torch.apps.milc import cg as PCG  # noqa: E402
from repro_torch.apps.milc import driver as PMD  # noqa: E402
from repro_torch.apps.milc import fields as PF  # noqa: E402
from repro_torch.core import AOS, SOA, BatchedField, DtypePolicy, Field, LaunchGraph  # noqa: E402
from repro_torch.core import LoweringPlan, TargetConfig, aosoa, target_max, target_sum  # noqa: E402
from repro_torch.core import fuse as PFU  # noqa: E402
from repro_torch.core import plan as pplan  # noqa: E402
from repro_torch.core import reduce as PR  # noqa: E402
from repro_torch.apps.ludwig import kernel as LK  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as K8  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as WK  # noqa: E402

LAT = (4, 4, 8)  # 128 sites, as tests/test_dtype.py
LAYOUTS = [(AOS, J_AOS), (SOA, J_SOA), (aosoa(16), j_aosoa(16))]
BF16 = DtypePolicy(storage="bfloat16", compute="float32", accumulate="float64")
ACC64 = DtypePolicy(accumulate="float64")
J_BF16 = jplan.DtypePolicy(storage="bfloat16", compute="float32", accumulate="float64")
J_ACC64 = jplan.DtypePolicy(accumulate="float64")
TORCH = TargetConfig("torch", device="cpu")
ORACLE_RTOL = 2.5e-7    # |sum - fp64 oracle| <= ORACLE_RTOL * sum|x| + 1e-6 (test_dtype.py)
ADVERSARIAL = [
    np.array([1.0, 1e8, 1.0, -1e8] * 16, np.float32),
    np.array([1e7, 0.125, -1e7, 0.125] * 16, np.float32),
    np.concatenate([np.full(64, 3e7, np.float32), np.full(64, -3e7, np.float32),
                    np.full(64, 2.0 ** -12, np.float32)]),
]


def _torch_plan(dtypes=None):
    return TargetConfig("torch", device="cpu", plan_policy=LoweringPlan("torch", dtypes=dtypes))


def _jax_plan(dtypes=None):
    return JTC("pallas", plan_policy=JPlan("pallas", vvl=16, interpret=True, dtypes=dtypes))


def _dot_graphs(ncomp=3):
    def body(v):
        return {"t": v["x"] * v["y"]}
    return tuple(G("dt_dot").add(body, {"x": "x", "y": "y"}, {"t": ncomp})
                 .add_reduce("t", op="sum", name="dot") for G in (LaunchGraph, JLaunchGraph))


def _cancel_fixture(ncomp):
    """tests/test_dtype.py's cross-block cancellation: +1e8 in block 0,
    -1e8 in block 4, filler 0.1875 (oracle 18 a component)."""
    x = np.full((ncomp, 128), 0.1875, np.float32)
    x[:, 0:16] = 0.0
    x[:, 64:80] = 0.0
    x[:, 0] = 1.0e8
    x[:, 64] = -1.0e8
    return x


def _np(t):
    """A port tensor or Field (bf16 too) as fp32 numpy."""
    if isinstance(t, Field):
        t = t.canonical_nd()
    return t.detach().float().numpy()


def _jnp(a):
    return np.asarray(a.to_numpy() if isinstance(a, JField) else a).astype(np.float32)


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significand bits)."""
    a = np.maximum(np.abs(v.astype(np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _within_bf16_ulp(got, want):
    gotf, wantf = got.astype(np.float64), want.astype(np.float64)
    err = np.abs(gotf - wantf)
    return float(np.max(err / _bf16_ulp(np.maximum(np.abs(gotf), np.abs(wantf)))))


def _oracle_err(got, terms, axis=-1):
    """max |got - fp64 sum| / (sum|terms| + 1e-6/ORACLE_RTOL), in units of
    ORACLE_RTOL (<= 1 passes)."""
    t = np.asarray(terms, np.float64)
    oracle, mass = t.sum(axis=axis), np.abs(t).sum(axis=axis)
    return float(np.max(np.abs(np.asarray(got, np.float64) - oracle)
                        / (ORACLE_RTOL * mass + 1e-6)))


# -- the policy and its resolution ------------------------------------------------

def test_dtype_policy_matches_reference():
    """DtypePolicy's tag, bool, storage itemsize and validation messages are
    the JAX package's; 'float64' resolves to compensated fp32 as there (x64
    is off) and 'compensated' too."""
    cases = [("", "", ""), ("bfloat16", "float32", "float64"), ("float32", "", "compensated"),
             ("", "", "float32"), ("float16", "float64", "")]
    for c in cases:
        p, j = DtypePolicy(*c), jplan.DtypePolicy(*c)
        assert (p.tag(), bool(p), p.storage_itemsize(4)) == (j.tag(), bool(j), j.storage_itemsize(4))
        assert pplan.resolve_accumulate(c[2]) == jplan.resolve_accumulate(c[2])
    assert pplan.resolve_accumulate("float64") == ("float32", True)
    for bad in (("bf16", "", ""), ("", "half", ""), ("", "", "int32"), ("", "", "double")):
        with pytest.raises(ValueError) as got:
            DtypePolicy(*bad).validate()
        with pytest.raises(ValueError) as want:
            jplan.DtypePolicy(*bad).validate()
        assert str(got.value) == str(want.value)
    assert pplan.dtype_itemsize("bfloat16") == 2 and pplan.dtype_itemsize("", 8) == 8
    plan = LoweringPlan("cuda", 128, dtypes=BF16)
    assert LoweringPlan.from_json(plan.to_json()) == plan
    assert plan.describe() == "cuda/vvl=128/dt=bf16:f32:f64"
    assert LoweringPlan("cuda", 128, dtypes=DtypePolicy()).describe() == "cuda/vvl=128"
    # what the cuda kernels take, and what they refuse
    assert pplan.cuda_policy(None) == (False, False)
    assert pplan.cuda_policy(BF16) == (True, True)
    assert pplan.cuda_policy(DtypePolicy(storage="float32")) == (False, False)
    assert pplan.cuda_policy(ACC64) == (False, True)
    for bad in (DtypePolicy(storage="bfloat16"), DtypePolicy(storage="float16", compute="float32"),
                DtypePolicy(accumulate="float16"), DtypePolicy(compute="float64")):
        with pytest.raises(ValueError, match="not yet ported"):
            pplan.cuda_policy(bad)


@pytest.mark.parametrize("case", range(len(ADVERSARIAL) + 2))
def test_kahan_fold_bitwise_vs_reference(case):
    """kahan_fold is the reference's scan step for step: bitwise on the
    adversarial fixtures and on random inputs (a 2-D fold along either
    axis), within the classic Kahan bound of the fp64 oracle."""
    rng = np.random.default_rng(case)
    if case < len(ADVERSARIAL):
        x, axis = ADVERSARIAL[case], -1
    else:
        x = (rng.normal(size=(3, 200)) * 10.0 ** rng.integers(-3, 6, size=(3, 200))).astype(
            np.float32)
        axis = case - len(ADVERSARIAL)
    got = PFU.kahan_fold(torch.from_numpy(x), axis=axis).numpy()
    want = np.asarray(JF.kahan_fold(jnp.asarray(x), axis=axis))
    np.testing.assert_array_equal(got, want)
    assert _oracle_err(got, x, axis=axis) <= 1.0


def test_kahan_fold_beats_naive_sequential_fold():
    """Small increments on a large running sum: the naive fp32 fold loses
    them all (measured error 126), the scan keeps them (measured 2)."""
    x = np.concatenate([[2.0 ** 25], np.full(126, 1.0), [-2.0 ** 25]]).astype(np.float32)
    got = float(PFU.kahan_fold(torch.from_numpy(x)))
    naive = np.float32(0.0)
    for v in x:
        naive = np.float32(naive + v)
    assert abs(got - 126.0) <= 4.0
    assert abs(float(naive) - 126.0) >= 64.0


# -- tests/test_dtype.py's contracts on the port -----------------------------------

@pytest.mark.parametrize("lays", LAYOUTS, ids=lambda p: p[0].name)
def test_empty_policy_is_bitwise_identity(lays):
    """No policy and the empty policy give the same bits, field and sum, in
    AoS, SoA and aosoa16; and equal the JAX package's pallas launch."""
    lay, jlay = lays
    rng = np.random.default_rng(0)
    x, y = (rng.normal(size=(3,) + LAT).astype(np.float32) for _ in range(2))
    g, jg = _dot_graphs()
    ins = {"x": Field.from_numpy("x", x, LAT, lay), "y": Field.from_numpy("y", y, LAT, lay)}
    base = g.launch(ins, config=_torch_plan(None), outputs=("t", "dot"))
    out = g.launch(ins, config=_torch_plan(DtypePolicy()), outputs=("t", "dot"))
    assert torch.equal(out["t"].data, base["t"].data) and torch.equal(out["dot"], base["dot"])
    jout = jg.launch({"x": JField.from_numpy("x", x, LAT, jlay),
                      "y": JField.from_numpy("y", y, LAT, jlay)},
                     config=_jax_plan(jplan.DtypePolicy()), outputs=("t", "dot"))
    np.testing.assert_array_equal(_np(out["t"]), _jnp(jout["t"]))


def test_accumulate_only_policy_keeps_fields_bitwise():
    """accumulate="float64" changes the sum alone: the field is bitwise the
    policy-free one, the sum within 2.0 of the fp64 oracle on the
    cancellation fixture (measured 0: fp64 rounded once), where the plain
    fold is off by 0.1875; the JAX package's compensated pallas sum is
    within the same 2.0 (measured 1.0)."""
    x = _cancel_fixture(3)
    g, jg = _dot_graphs()
    ins = {"x": Field.from_canonical("x", torch.from_numpy(x), LAT),
           "y": Field.from_canonical("y", torch.ones((3, 128)), LAT)}
    base = g.launch(ins, config=_torch_plan(None), outputs=("t", "dot"))
    out = g.launch(ins, config=_torch_plan(ACC64), outputs=("t", "dot"))
    assert torch.equal(out["t"].data, base["t"].data)
    oracle = x.astype(np.float64).sum(axis=1)
    got_err = np.max(np.abs(out["dot"].numpy().astype(np.float64) - oracle))
    plain_err = np.max(np.abs(base["dot"].numpy().astype(np.float64) - oracle))
    assert got_err <= 2.0 and got_err < plain_err
    jout = jg.launch({"x": JField.from_canonical("x", jnp.asarray(x), LAT, J_SOA),
                      "y": JField.from_canonical("y", jnp.ones((3, 128), jnp.float32), LAT,
                                                 J_SOA)},
                     config=_jax_plan(J_ACC64), outputs=("t", "dot"))
    assert np.max(np.abs(np.asarray(jout["dot"], np.float64) - oracle)) <= 2.0
    assert np.max(np.abs(out["dot"].numpy() - np.asarray(jout["dot"]))) <= 2.0


def test_storage_policy_casts_and_halves_bytes():
    """bf16 storage: the field comes back in bf16 within 1e-2 rel of full
    precision and within one bf16 ulp of the JAX package's (pallas,
    interpret) bf16 field; bytes_moved halves."""
    rng = np.random.default_rng(1)
    x, y = (rng.normal(size=(3,) + LAT).astype(np.float32) for _ in range(2))
    g, jg = _dot_graphs()
    ins = {"x": Field.from_numpy("x", x, LAT), "y": Field.from_numpy("y", y, LAT)}
    base = g.launch(ins, config=_torch_plan(None), outputs=("t", "dot"))
    out = g.launch(ins, config=TargetConfig("torch", device="cpu", dtypes=BF16),
                   outputs=("t", "dot"))
    assert out["t"].data.dtype == torch.bfloat16 and out["dot"].dtype == torch.float32
    err = np.linalg.norm(_np(out["t"]) - _np(base["t"])) / np.linalg.norm(_np(base["t"]))
    assert err < 1e-2
    jout = jg.launch({"x": JField.from_numpy("x", x, LAT), "y": JField.from_numpy("y", y, LAT)},
                     config=_jax_plan(J_BF16), outputs=("t", "dot"))
    assert jout["t"].data.dtype == jnp.bfloat16
    assert _within_bf16_ulp(_np(out["t"]), _jnp(jout["t"])) <= 1.0
    # the sum: the fp32 product of the rounded inputs, compensated
    xr, yr = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (x, y))
    assert _oracle_err(out["dot"].numpy(), (xr * yr).reshape(3, -1)) <= 1.0
    assert _oracle_err(np.asarray(jout["dot"]), (xr * yr).reshape(3, -1)) <= 1.0
    bm = g.bytes_moved({"x": 3, "y": 3}, 128, outputs=("t", "dot"))
    bm_pol = g.bytes_moved({"x": 3, "y": 3}, 128, outputs=("t", "dot"), dtypes=BF16)
    assert bm_pol["fused"] * 2 == bm["fused"] and bm_pol["unfused"] * 2 == bm["unfused"]
    assert bm_pol == jg.bytes_moved({"x": 3, "y": 3}, 128, outputs=("t", "dot"), dtypes=J_BF16)


def test_max_and_integer_sums_bitwise_under_policy():
    """max and integer sums ignore the policy: a fused max under an
    accumulate policy, a standalone max under any, integer sums under any
    (tests/test_dtype.py's cases)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 128)).astype(np.float32)
    fx = Field.from_canonical("x", torch.from_numpy(x), LAT)
    g = (LaunchGraph("dt_max").add(lambda v: {"t": v["x"] * v["x"]}, {"x": "x"}, {"t": 3})
         .add_reduce("t", op="max", name="tmax"))
    base = g.launch({"x": fx}, config=_torch_plan(None), outputs=("tmax",))["tmax"]
    assert torch.equal(g.launch({"x": fx}, config=_torch_plan(ACC64), outputs=("tmax",))["tmax"],
                       base)
    for pol in (ACC64, BF16):
        assert torch.equal(target_max(fx, _torch_plan(pol)), target_max(fx, _torch_plan(None)))
    di = rng.integers(-100, 100, size=(3, 128)).astype(np.int32)
    fi = Field.from_canonical("xi", torch.from_numpy(di), LAT)
    for pol in (None, ACC64, BF16):
        got = target_sum(fi, _torch_plan(pol))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), di.sum(axis=1))


def test_standalone_float_sum_accumulates_compensated():
    """target_sum under an accumulate policy (the plan's or the config's)
    matches the fp64 oracle on the cancellation fixture (measured 0; the
    JAX package's jnp Kahan scan 1.0), single and batched (each row the
    single one); the plain fold does not (0.1875)."""
    x = _cancel_fixture(2)
    fx = Field.from_canonical("x", torch.from_numpy(x), LAT)
    oracle = x.astype(np.float64).sum(axis=1)
    for cfg in (_torch_plan(ACC64), TargetConfig("torch", device="cpu", dtypes=ACC64)):
        got = target_sum(fx, cfg).numpy().astype(np.float64)
        assert np.max(np.abs(got - oracle)) <= 2.0
    plain = target_sum(fx, TORCH).numpy().astype(np.float64)
    assert np.max(np.abs(got - oracle)) < np.max(np.abs(plain - oracle))
    jx = JField.from_canonical("x", jnp.asarray(x), LAT, J_SOA)
    jgot = np.asarray(j_target_sum(jx, JTC("jnp", plan_policy=JPlan("jnp", dtypes=J_ACC64))))
    assert np.max(np.abs(jgot - oracle)) <= 2.0
    bx = BatchedField.stack([fx, fx.with_data(fx.data * 0.5)])
    rows = target_sum(bx, _torch_plan(ACC64))
    assert torch.equal(rows[0], target_sum(fx, _torch_plan(ACC64)))


def test_footprint_model_is_policy_aware():
    """The footprint model prices a policy's launch at the storage itemsize
    and the tile planner picks the JAX package's tiles under it."""
    in_views, out_views, lat = ((19, 1, 4), (3, 0, 4)), ((19, 4),), (8, 14, 16)
    for by, bz in ((0, 0), (2, 4), (7, 0)):
        for pol, jpol in ((None, None), (BF16, J_BF16)):
            got = pplan.estimate_smem_bytes(LoweringPlan("cuda", bx=1, by=by, bz=bz, dtypes=pol),
                                            lattice=lat, in_views=in_views, out_views=out_views)
            want = jplan.estimate_vmem_bytes(JPlan("pallas", bx=1, by=by, bz=bz, dtypes=jpol),
                                             lattice=lat, in_views=in_views, out_views=out_views)
            assert got == want
    base = pplan.estimate_smem_bytes(LoweringPlan("cuda", bx=1), lattice=lat, in_views=in_views,
                                     out_views=out_views)
    for budget in (base // 2, base // 5, base // 40):
        got = pplan.choose_tiles(lat, 1, in_views=in_views, out_views=out_views,
                                 smem_bytes=budget, dtypes=BF16)
        want = jplan.choose_tiles(lat, 1, in_views=in_views, out_views=out_views,
                                  vmem_bytes=budget, dtypes=J_BF16)
        assert got == want
        plain = pplan.choose_tiles(lat, 1, in_views=in_views, out_views=out_views,
                                   smem_bytes=budget)
        assert (got[0] or lat[1]) * (got[1] or lat[2]) >= (plain[0] or lat[1]) * (plain[1] or lat[2])


# -- the policy instances' plain versions against the JAX package -------------------

MILC_LAT = (4, 4, 4, 8)
KAPPA = 0.1


@pytest.fixture(scope="module")
def milc_fields():
    u = PF.random_su3_gauge(MILC_LAT, seed=0, hot=0.6)
    rng = np.random.default_rng(5)
    ps = [rng.normal(size=(24,) + MILC_LAT).astype(np.float32) for _ in range(2)]
    return u, ps


def _j_normal(u, p, pol, jlay=J_SOA):
    out = JCG.wilson_normal_graph(KAPPA).launch(
        {"p": JField.from_numpy("p", p, MILC_LAT, jlay), "u": JField.from_numpy("u", u, MILC_LAT, jlay)},
        config=JTC("jnp", dtypes=pol), outputs=("ap", "pap"))
    return out["ap"], np.asarray(out["pap"])


@pytest.mark.parametrize("lays", [(SOA, J_SOA), (AOS, J_AOS)], ids=lambda p: p[0].name)
def test_wilson_normal_policy_plain_vs_reference(milc_fields, lays):
    """K5's policy instance, plain: stage-in rounding bitwise the JAX
    package's astype; ap in bf16 within one bf16 ulp of the JAX package's
    policy launch (jnp) and bitwise the port's own torch-engine graph
    launch; pap within the oracle bound of the fp64 sum of the rounded p
    times the fp32 ap.  Under storage float32 the fields are the policy-free
    ones bitwise.  The batched form: each slot bitwise the single one."""
    lay, jlay = lays
    u, ps = milc_fields
    pol = pplan.cuda_policy(BF16)
    pt = lay.pack(torch.from_numpy(ps[0]).reshape(24, -1))
    ut = lay.pack(torch.from_numpy(u).reshape(72, -1))
    lays_ = {"p": lay, "u": lay, "ap": lay}
    ap, pap = WK.wilson_normal_plain(pt, ut, KAPPA, MILC_LAT, lays_, policy=pol)
    assert ap.dtype == torch.bfloat16 and pap.dtype == torch.float32
    jap, jpap = _j_normal(u, ps[0], J_BF16, jlay)
    # the stage-in rounding
    np.testing.assert_array_equal(WK.bf16_round(torch.from_numpy(u)).numpy(),
                                  np.asarray(jnp.asarray(u).astype(jnp.bfloat16)
                                             .astype(jnp.float32)))
    ap_c = lay.unpack(ap).float().numpy()
    assert _within_bf16_ulp(ap_c, _jnp(jap).reshape(24, -1)) <= 1.0
    # pap from the fp32 ap: recompute it unrounded
    ap32, _ = WK.wilson_normal_plain(WK.bf16_round(pt), WK.bf16_round(ut), KAPPA, MILC_LAT,
                                     lays_)
    terms = WK.bf16_round(lay.unpack(pt)).numpy() * lay.unpack(ap32).numpy()
    assert _oracle_err(pap.numpy(), terms) <= 1.0
    assert _oracle_err(jpap, terms) <= 4.0   # Kahan: 2 eps of the mass (measured < 1)
    # the graph on the port's torch engine under the policy
    g = PCG.wilson_normal_graph(KAPPA).launch(
        {"p": Field("p", 24, MILC_LAT, lay, pt), "u": Field("u", 72, MILC_LAT, lay, ut)},
        config=TargetConfig("torch", device="cpu", dtypes=BF16), outputs=("ap", "pap"),
        out_layouts={"ap": lay})
    assert g["ap"].data.dtype == torch.bfloat16
    assert _within_bf16_ulp(_np(g["ap"]).reshape(24, -1), ap_c) <= 1.0
    assert _oracle_err(g["pap"].numpy(), terms) <= 1.0
    # storage float32: bitwise the policy-free fields; compensated pap
    f32 = pplan.cuda_policy(DtypePolicy(storage="float32", compute="float32",
                                        accumulate="float64"))
    a32, p32 = WK.wilson_normal_plain(pt, ut, KAPPA, MILC_LAT, lays_, policy=f32)
    a0, _ = WK.wilson_normal_plain(pt, ut, KAPPA, MILC_LAT, lays_)
    assert torch.equal(a32, a0)
    # batched: each slot the single plain version
    pb = torch.stack([pt, lay.pack(torch.from_numpy(ps[1]).reshape(24, -1))])
    apb, papb = WK.wilson_normal_plain(pb, ut, KAPPA, MILC_LAT, lays_, batched=True, policy=pol)
    assert torch.equal(apb[0], ap) and torch.equal(papb[0], pap)


@pytest.mark.parametrize("tile", [(1, 1, 1), (2, 2, 4)], ids=str)
def test_k5t_policy_plain_vs_reference_tiled_launch(milc_fields, tile):
    """K5T's policy instance, plain (wilson_normal_tiled_plain under the
    refined solve's policy): ap bitwise K5's policy plain version and
    within one bf16 ulp of the reference's tiled launch under the policy
    (interpret); pap (compensated, which needs no order) bitwise K5's and
    within the oracle bound; two slots each bitwise the single one."""
    u, ps = milc_fields
    pol = pplan.cuda_policy(BF16)
    pt = torch.from_numpy(ps[0]).reshape(24, -1)
    ut = torch.from_numpy(u).reshape(72, -1)
    ap, pap = WK.wilson_normal_tiled_cuda(pt, ut, KAPPA, MILC_LAT, tile, policy=pol)
    k5 = WK.wilson_normal_plain(pt, ut, KAPPA, MILC_LAT, policy=pol)
    assert ap.dtype == torch.bfloat16
    assert torch.equal(ap, k5[0]) and torch.equal(pap, k5[1])
    jout = JCG.wilson_normal_graph(KAPPA).launch(
        {"p": JField.from_numpy("p", ps[0], MILC_LAT), "u": JField.from_numpy("u", u, MILC_LAT)},
        config=JTC("pallas", dtypes=J_BF16), outputs=("ap", "pap"),
        plan=JPlan("pallas", bx=tile[0], by=tile[1], bz=tile[2], interpret=True, dtypes=J_BF16))
    assert _within_bf16_ulp(ap.float().numpy(), _jnp(jout["ap"]).reshape(24, -1)) <= 1.0
    ap32, _ = WK.wilson_normal_plain(WK.bf16_round(pt), WK.bf16_round(ut), KAPPA, MILC_LAT)
    terms = WK.bf16_round(pt).numpy() * ap32.numpy()
    assert _oracle_err(pap.numpy(), terms) <= 1.0
    assert _oracle_err(np.asarray(jout["pap"]), terms) <= 4.0
    pb = torch.stack([pt, torch.from_numpy(ps[1]).reshape(24, -1)])
    apb, papb = WK.wilson_normal_tiled_cuda(pb, ut, KAPPA, MILC_LAT, tile, batched=True,
                                            policy=pol)
    assert torch.equal(apb[0], ap) and torch.equal(papb[0], pap)


def test_wilson_normal_policy_reads_a_bf16_u_copy(milc_fields):
    """Under bf16 storage K5's policy instance reads u as a bf16 copy made
    once per operator (``bf16_pack_cuda``; its plain version on the CPU):
    the copy holds the stage-in rounding's values bitwise (the JAX
    package's astype), and the plain version fed the copy gives the fp32
    u's ap and pap bitwise, single and batched."""
    u, ps = milc_fields
    pol = pplan.cuda_policy(BF16)
    ut = torch.from_numpy(u).reshape(72, -1)
    pt = torch.from_numpy(ps[0]).reshape(24, -1)
    u16 = WK.bf16_pack_cuda(ut)
    assert u16.dtype == torch.bfloat16
    np.testing.assert_array_equal(u16.float().numpy(),
                                  np.asarray(jnp.asarray(u).astype(jnp.bfloat16)
                                             .astype(jnp.float32)).reshape(72, -1))
    for got, want in zip(WK.wilson_normal_plain(pt, u16, KAPPA, MILC_LAT, policy=pol),
                         WK.wilson_normal_plain(pt, ut, KAPPA, MILC_LAT, policy=pol)):
        assert torch.equal(got, want)
    pb = torch.stack([pt, torch.from_numpy(ps[1]).reshape(24, -1)])
    for got, want in zip(WK.wilson_normal_plain(pb, u16, KAPPA, MILC_LAT, batched=True,
                                                policy=pol),
                         WK.wilson_normal_plain(pb, ut, KAPPA, MILC_LAT, batched=True,
                                                policy=pol)):
        assert torch.equal(got, want)


def test_the_bf16_copy_of_u_follows_the_launch_policy(monkeypatch, milc_fields):
    """make_fused_normal binds the bf16 copy of u exactly where the policy
    the bound graph resolves (``core.plan.launch_policy``: the explicit
    plan's engine and own policy, else the config's) asks the cuda engine
    for bf16 storage, the copy K5's policy wrapper requires."""
    f32 = DtypePolicy(storage="float32", compute="float32", accumulate="float64")
    cases = [
        (TargetConfig("cuda", device="cpu", dtypes=BF16), ("cuda", BF16), 1),
        (TargetConfig("cuda", device="cpu", dtypes=f32), ("cuda", f32), 0),
        (TargetConfig("cuda", device="cpu"), ("cuda", None), 0),
        (TargetConfig("torch", device="cpu", dtypes=BF16), ("torch", BF16), 0),
        (TargetConfig("cuda", device="cpu", dtypes=BF16,
                      plan_policy=LoweringPlan("cuda", vvl=32, dtypes=f32)), ("cuda", f32), 0),
        (TargetConfig("cuda", device="cpu",
                      plan_policy=LoweringPlan("cuda", vvl=32, dtypes=BF16)), ("cuda", BF16), 1),
    ]
    u = Field.from_numpy("u", milc_fields[0], MILC_LAT)
    for cfg, want, copies in cases:
        packed = []
        monkeypatch.setattr(PCG, "bf16_pack_cuda",
                            lambda x: packed.append(x) or x.to(torch.bfloat16))
        assert pplan.launch_policy(cfg) == want
        PCG.make_fused_normal(u, KAPPA, cfg)
        assert len(packed) == copies, cfg


def test_lb_step_policy_plain_vs_reference():
    """K5L's policy instance, plain: dist2 and u in bf16 within one bf16 ulp
    of the JAX package's ludwig_lb_step launch under the same policy (jnp),
    and of the port's torch-engine graph launch under it."""
    lat = (4, 4, 8)
    rng = np.random.default_rng(7)
    w = np.array([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12, np.float32)
    dist = (w[:, None] * (1.0 + 0.1 * rng.normal(size=(19, 128)))).astype(np.float32)
    force = (1e-3 * rng.normal(size=(3, 128))).astype(np.float32)
    d2, u = K8.lb_step_plain(torch.from_numpy(dist), torch.from_numpy(force), 0.8, lat,
                             bf16=True)
    assert d2.dtype == torch.bfloat16 and u.dtype == torch.bfloat16
    jcfg = JLudwigConfig(lattice=lat, target=JTC("jnp"), storage="bfloat16")
    jout = JLD.lb_step_graph(jcfg).launch(
        {"dist": JField.from_numpy("dist", dist, lat), "force": JField.from_numpy("force", force, lat)},
        config=JLD._lb_target(jcfg), outputs=("dist2", "u"))
    assert _within_bf16_ulp(d2.float().numpy(), _jnp(jout["dist2"]).reshape(19, -1)) <= 1.0
    assert _within_bf16_ulp(u.float().numpy(), _jnp(jout["u"]).reshape(3, -1)) <= 1.0
    cfg = LudwigConfig(lattice=lat, target=TORCH, storage="bfloat16")
    out = PLD.lb_step_graph(cfg).launch(
        {"dist": Field.from_numpy("dist", dist, lat), "force": Field.from_numpy("force", force, lat)},
        config=PLD._lb_target(cfg), outputs=("dist2", "u"))
    assert _within_bf16_ulp(_np(out["dist2"]).reshape(19, -1), d2.float().numpy()) <= 1.0
    assert _within_bf16_ulp(_np(out["u"]).reshape(3, -1), u.float().numpy()) <= 1.0


def test_cg_update_bf16_ap_plain_vs_reference():
    """K3 and K3B fed a bf16 ap: the update chain's graph (policy-free) on a
    bf16 ap against the JAX package's on the same inputs: x_new and r_new
    fp32 within 1 fp32 ulp (XLA contracts y + a x into one rounding where
    torch rounds twice: measured 2.4e-7 abs), rr within the oracle bound;
    the plain version equals the graph launch bitwise, and the masked plain
    version's live slot equals the single one."""
    rng = np.random.default_rng(9)
    x, r, p = (rng.normal(size=(24, 128)).astype(np.float32) for _ in range(3))
    ap16 = torch.from_numpy(rng.normal(size=(24, 128)).astype(np.float32)).to(torch.bfloat16)
    alpha = 0.37
    ins = {n: Field.from_canonical(n, torch.from_numpy(a), LAT) for n, a in
           (("x", x), ("r", r), ("p", p))}
    ins["ap"] = Field.from_canonical("ap", ap16, LAT)
    out = PCG.cg_update_graph(24).launch(ins, scalars={"alpha": alpha, "neg_alpha": -alpha},
                                         config=TORCH, outputs=("x_new", "r_new", "rr"))
    jins = {n: JField.from_numpy(n, a, LAT) for n, a in (("x", x), ("r", r), ("p", p))}
    jins["ap"] = JField.from_numpy("ap", ap16.float().numpy(), LAT, dtype=jnp.bfloat16)
    jout = JCG.cg_update_graph(24).launch(jins, scalars={"alpha": alpha, "neg_alpha": -alpha},
                                          config=JTC("jnp"), outputs=("x_new", "r_new", "rr"))
    assert out["r_new"].data.dtype == torch.float32
    for o in ("x_new", "r_new"):
        np.testing.assert_allclose(_np(out[o]), _jnp(jout[o]), rtol=1.2e-7, atol=2.4e-7)
    rn = _np(out["r_new"]).reshape(24, -1)
    assert _oracle_err(out["rr"].numpy(), rn * rn) <= 1.0
    a = torch.tensor(alpha)
    xp, rp, rrp = PFU.cg_update_plain(ins["x"].data, ins["r"].data, ins["p"].data, ap16, a, -a)
    assert torch.equal(rp, out["r_new"].data) and torch.equal(xp, out["x_new"].data)
    st = [torch.stack([t, t]) for t in (ins["x"].data, ins["r"].data, ins["p"].data)]
    xm, rm, rrm = PFU.cg_update_masked_plain(*st, torch.stack([ap16, ap16]), a.repeat(2),
                                             -a.repeat(2), torch.tensor([1.0, 0.0]))
    assert torch.equal(rm[0], rp) and torch.equal(rrm[0], rrp)
    assert torch.equal(rm[1], st[1][1])


# -- the flat chains' policy instances (K3 cg_update, K3L chem_stress, lc_update) ---

LC_ARGS = dict(a0=0.01, gamma=3.0, kappa_m=0.01, kappa_s=0.01, xi=0.7)
LU_ARGS = dict(gamma_rot=0.3, xi=0.7, dt=1.0)


def _flat_arrays(seed=11, n=128):
    rng = np.random.default_rng(seed)
    mk = lambda c, s: (s * rng.normal(size=(c, n))).astype(np.float32)  # noqa: E731
    return dict(x=mk(24, 1.0), r=mk(24, 1.0), p=mk(24, 1.0), ap=mk(24, 1.0), q=mk(5, 0.05),
                lapq=mk(5, 0.02), dq=mk(15, 0.02), h=mk(5, 0.01), w=mk(9, 0.01),
                adv=mk(5, 0.01))


def _ref_flat(graph, arrays, names, outs, pol, scalars=None, bf16_in=()):
    """The JAX package's launch of a flat graph (jnp) under ``pol``; the
    inputs named in ``bf16_in`` arrive in bf16."""
    jins = {n: JField.from_numpy(n, arrays[n], LAT, dtype=jnp.bfloat16 if n in bf16_in else None)
            for n in names}
    cfg = JTC("jnp", plan_policy=JPlan("jnp", dtypes=pol)) if pol else JTC("jnp")
    return graph.launch(jins, config=cfg, outputs=outs, scalars=scalars)


def _t(a, bf16=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if bf16 else t


@pytest.mark.parametrize("pol,jpol", [(BF16, J_BF16), (ACC64, J_ACC64)], ids=["bf16", "acc64"])
def test_cg_update_policy_plain_vs_reference(pol, jpol):
    """K3's policy instance, plain: under bf16 storage x_new and r_new in bf16
    within one bf16 ulp of the JAX package's cg_update launch under the
    policy, rr within the fp64 oracle bound of the fp32 r_new's squares;
    under the accumulate-only policy the fields bitwise the policy-free
    plain version.  The port's torch-engine graph launch under the policy
    is the plain version bitwise; bf16 inputs are taken as the reference
    takes them: bitwise their fp32 sources under the policy."""
    a = _flat_arrays()
    alpha = 0.37
    at = torch.tensor(alpha)
    cpol = pplan.cuda_policy(pol)
    ins = [_t(a[n]) for n in ("x", "r", "p", "ap")]
    xn, rn, rr = PFU.cg_update_plain(*ins, at, -at, policy=cpol)
    jout = _ref_flat(JCG.cg_update_graph(24), a, ("x", "r", "p", "ap"), ("x_new", "r_new", "rr"),
                     jpol, {"alpha": alpha, "neg_alpha": -alpha})
    r32 = torch.from_numpy(a["r"]).to(torch.bfloat16).float() if cpol.bf16 else _t(a["r"])
    ap32 = torch.from_numpy(a["ap"]).to(torch.bfloat16).float() if cpol.bf16 else _t(a["ap"])
    terms = (r32 + (-at) * ap32) ** 2
    assert _oracle_err(rr.numpy(), terms.numpy()) <= 1.0
    assert _oracle_err(np.asarray(jout["rr"]), terms.numpy()) <= 1.0
    if cpol.bf16:
        assert xn.dtype == rn.dtype == torch.bfloat16
        for got, o in ((xn, "x_new"), (rn, "r_new")):
            assert _within_bf16_ulp(got.float().numpy(), _jnp(jout[o]).reshape(24, -1)) <= 1.0
    else:
        x0, r0, _ = PFU.cg_update_plain(*ins, at, -at)
        assert torch.equal(xn, x0) and torch.equal(rn, r0)
    out = PCG.cg_update_graph(24).launch(
        {n: Field.from_canonical(n, t, LAT) for n, t in zip(("x", "r", "p", "ap"), ins)},
        scalars={"alpha": alpha, "neg_alpha": -alpha}, config=_torch_plan(pol),
        outputs=("x_new", "r_new", "rr"))
    assert torch.equal(out["x_new"].canonical(), xn) and torch.equal(out["r_new"].canonical(), rn)
    assert torch.equal(out["rr"], rr)
    if cpol.bf16:
        ins16 = [t.to(torch.bfloat16) for t in ins]
        got = PFU.cg_update_plain(*ins16, at, -at, policy=cpol)
        for g, w in zip(got, (xn, rn, rr)):
            assert torch.equal(g, w)
        j16 = _ref_flat(JCG.cg_update_graph(24), a, ("x", "r", "p", "ap"), ("x_new", "r_new"),
                        jpol, {"alpha": alpha, "neg_alpha": -alpha}, bf16_in=("x", "r", "p", "ap"))
        assert _within_bf16_ulp(got[1].float().numpy(), _jnp(j16["r_new"]).reshape(24, -1)) <= 1.0


@pytest.mark.parametrize("pol,jpol", [(BF16, J_BF16), (ACC64, J_ACC64)], ids=["bf16", "acc64"])
def test_ludwig_flat_policy_plain_vs_reference(pol, jpol):
    """K3L's policy instances, plain: under bf16 storage h, sigma and q_new
    in bf16 within one bf16 ulp of the JAX package's launches under the
    policy (jnp), and bitwise the port's torch-engine launches; under the
    accumulate-only policy (these graphs have no sums) bitwise the
    policy-free plain versions.  A bf16 input is taken as the reference
    takes it: bitwise its fp32 source under the policy."""
    a = _flat_arrays()
    cpol = pplan.cuda_policy(pol)
    jcfg = JLudwigConfig(a0=0.01, gamma=3.0, kappa=0.01, xi=0.7, gamma_rot=0.3)
    pcfg = LudwigConfig(a0=0.01, gamma=3.0, kappa=0.01, xi=0.7, gamma_rot=0.3)
    cs_in = ("q", "lapq", "dq")
    h, sig = LK.chem_stress_plain(*(_t(a[n]) for n in cs_in), **LC_ARGS, policy=cpol)
    lu_in = ("q", "h", "w", "adv")
    qn = LK.lc_update_plain(*(_t(a[n]) for n in lu_in), **LU_ARGS, policy=cpol)
    jcs = _ref_flat(JLD.chem_stress_graph(jcfg), a, cs_in, ("h", "sigma"), jpol)
    jlu = _ref_flat(JLD.lc_update_graph(jcfg), a, lu_in, ("q_new",), jpol)
    pcs = PLD.chem_stress_graph(pcfg).launch(
        {n: Field.from_canonical(n, _t(a[n]), LAT) for n in cs_in}, config=_torch_plan(pol),
        outputs=("h", "sigma"))
    plu = PLD.lc_update_graph(pcfg).launch(
        {n: Field.from_canonical(n, _t(a[n]), LAT) for n in lu_in}, config=_torch_plan(pol),
        outputs=("q_new",))
    for got, ref, port, nc in ((h, jcs["h"], pcs["h"], 5), (sig, jcs["sigma"], pcs["sigma"], 9),
                               (qn, jlu["q_new"], plu["q_new"], 5)):
        assert got.dtype == (torch.bfloat16 if cpol.bf16 else torch.float32)
        assert torch.equal(port.canonical(), got)
        assert _within_bf16_ulp(got.float().numpy(), _jnp(ref).reshape(nc, -1)) <= 1.0
    if not cpol.bf16:
        h0, s0 = LK.chem_stress_plain(*(_t(a[n]) for n in cs_in), **LC_ARGS)
        q0 = LK.lc_update_plain(*(_t(a[n]) for n in lu_in), **LU_ARGS)
        assert torch.equal(h, h0) and torch.equal(sig, s0) and torch.equal(qn, q0)
        return
    h16, s16 = LK.chem_stress_plain(*(_t(a[n], True) for n in cs_in), **LC_ARGS, policy=cpol)
    q16 = LK.lc_update_plain(*(_t(a[n], True) for n in lu_in), **LU_ARGS, policy=cpol)
    assert torch.equal(h16, h) and torch.equal(s16, sig) and torch.equal(q16, qn)
    j16 = _ref_flat(JLD.lc_update_graph(jcfg), a, lu_in, ("q_new",), jpol, bf16_in=lu_in)
    assert _within_bf16_ulp(q16.float().numpy(), _jnp(j16["q_new"]).reshape(5, -1)) <= 1.0


def test_flat_chains_take_a_bf16_input_without_a_policy():
    """A policy-free K3/K3L fed a bf16 field (h from a chem_stress winner
    with bf16 storage, x and r from an update-chain one) widens it exactly
    at load and computes in fp32 (the wrappers' policy instance with its
    round and its bf16 writes off): the plain version is bitwise the one
    fed the widened field, and within the bf16 rounding of its
    intermediates of the JAX package's jnp promotion, whose products of a
    bf16 operand with a Python-float coefficient stay in bf16."""
    a = _flat_arrays()
    h16 = _t(a["h"], True)
    got = LK.lc_update_plain(_t(a["q"]), h16, _t(a["w"]), _t(a["adv"]), **LU_ARGS)
    wide = LK.lc_update_plain(_t(a["q"]), h16.float(), _t(a["w"]), _t(a["adv"]), **LU_ARGS)
    assert got.dtype == torch.float32 and torch.equal(got, wide)
    jcfg = JLudwigConfig(a0=0.01, gamma=3.0, kappa=0.01, xi=0.7, gamma_rot=0.3)
    ref = _ref_flat(JLD.lc_update_graph(jcfg), a, ("q", "h", "w", "adv"), ("q_new",), None,
                    bf16_in=("h",))["q_new"]
    ref = _jnp(ref).reshape(5, -1)
    # the reference's bf16 products: |gamma_rot h| dt rounded to bf16, 2^-8 relative
    bound = 2.0 ** -8 * LU_ARGS["gamma_rot"] * np.abs(a["h"]).max() * 4 + 1e-7
    assert np.max(np.abs(got.numpy() - ref)) <= bound
    at = torch.tensor(0.37)
    x16, r16 = _t(a["x"], True), _t(a["r"], True)
    xn, rn, rr = PFU.cg_update_plain(x16, r16, _t(a["p"]), _t(a["ap"]), at, -at)
    w = PFU.cg_update_plain(x16.float(), r16.float(), _t(a["p"]), _t(a["ap"]), at, -at)
    assert xn.dtype == torch.float32 and all(torch.equal(g, v) for g, v in zip((xn, rn, rr), w))


def test_compensated_sum_plain_vs_reference():
    """K2's compensated instance, plain (fp64 rounded once): within the
    oracle bound on the adversarial fixtures and random fields, as is the
    JAX package's compensated pallas reduction (interpret); the batched
    form and the pair fold agree with it."""
    rng = np.random.default_rng(11)
    cases = [np.stack([np.resize(a, 128)] * 2) for a in ADVERSARIAL]
    cases.append((rng.normal(size=(2, 128)) * 1e4).astype(np.float32))
    for x in cases:
        got = PR.reduce_sites(torch.from_numpy(x), "sum", compensated=True).numpy()
        assert _oracle_err(got, x) <= 1.0
        jgot = np.asarray(j_target_sum(JField.from_canonical("x", jnp.asarray(x), LAT, J_SOA),
                                       _jax_plan(J_ACC64)))
        assert _oracle_err(jgot, x) <= 1.0
        rows = PR.reduce_sites_batched(torch.from_numpy(np.stack([x, x])), "sum",
                                       compensated=True)
        assert torch.equal(rows[0], torch.from_numpy(got))
    pairs = torch.from_numpy(rng.normal(size=(5, 3, 2)).astype(np.float32))
    np.testing.assert_array_equal(
        PR.fold_partials(pairs, "sum", compensated=True).numpy(),
        pairs.double().sum(dim=(0, 2)).float().numpy())


# -- the drivers -------------------------------------------------------------------

def _milc_cfgs(lat=MILC_LAT, **kw):
    cfg = PMD.MilcConfig(lattice=lat, kappa=0.1, tol=1e-10, target=TORCH, **kw)
    jcfg = JMD.MilcConfig(lattice=lat, kappa=0.1, tol=1e-10, target=JTC("jnp", vvl=128), **kw)
    return cfg, jcfg


@pytest.fixture(scope="module")
def refined():
    """tests/test_dtype.py's refined solve on both packages, with the
    full-precision solves."""
    base, jbase = _milc_cfgs()
    cfg, jcfg = (dataclasses.replace(c, storage="bfloat16") for c in (base, jbase))
    u, b = PMD.init_problem(base, seed=0)
    ju, jb = JMD.init_problem(jbase, seed=0)
    return (cfg, u, b, PMD.solve(base, u, b), PMD.solve(cfg, u, b),
            JMD.solve(jcfg, ju, jb))


def test_refined_solve_hits_tolerance(refined):
    """storage="bfloat16": the reference's bounds on the port (measured: x
    rel 1.3e-5 to full precision, residual_check 6.8e-7, 26 inner iterations
    against 20), and the JAX package's refined solve: inner iterations
    within +-2 of its 26 (measured 26), x within rel-L2 5e-5 of its x
    (measured 6.5e-7)."""
    cfg, u, b, full, res, jres = refined
    assert res.x.data.dtype == torch.float32
    rel = np.linalg.norm(_np(res.x) - _np(full.x)) / np.linalg.norm(_np(full.x))
    assert rel < 5e-5, rel
    assert PMD.residual_check(cfg, u, b, res.x) < 5e-6
    assert res.iterations <= 4 * full.iterations
    assert abs(res.iterations - int(jres.iterations)) <= 2, (res.iterations, int(jres.iterations))
    jx = _jnp(jres.x)
    assert np.linalg.norm(_np(res.x) - jx) / np.linalg.norm(jx) < 5e-5


def test_refined_solve_cg_refined_directly(refined):
    """cg_refined with refine_k 1 restarts after every inner iteration and
    still converges; the policy-free operator as the inner one gives the
    refined solve of full precision."""
    cfg, u, b, full, _, _ = refined
    _, apply_mdag, _ = PCG.make_wilson_op(u, cfg.kappa, TORCH)
    rhs = apply_mdag(b)
    hi = PCG.make_fused_normal(u, cfg.kappa, TORCH)
    res = PCG.cg_refined(hi, rhs, config=TORCH, tol=1e-10, max_iter=400, refine_k=5)
    assert PMD.residual_check(cfg, u, b, res.x) < 5e-6 and res.iterations <= 4 * full.iterations


def test_policy_refusals_before_any_device_check():
    """On the cuda engine a policy on a graph without a policy instance
    raises before the fields' device is looked at (these fields lie on the
    CPU); a policy on a tiled plan runs K5T's policy instance, so its launch
    passes the plan checks and refuses the CPU fields; the empty policy is
    no policy."""
    rng = np.random.default_rng(3)
    fx = Field.from_numpy("x", rng.normal(size=(3,) + LAT).astype(np.float32), LAT)
    g, _ = _dot_graphs()
    cuda = TargetConfig("cuda", device="cpu", dtypes=BF16)
    with pytest.raises(ValueError, match="no policy instance.*not yet ported"):
        g.launch({"x": fx, "y": fx}, config=cuda, outputs=("t", "dot"))
    u = Field.from_numpy("u", PF.random_su3_gauge((2, 2, 4, 4), seed=0, hot=0.6), (2, 2, 4, 4))
    p = Field.from_numpy("p", PF.random_spinor((2, 2, 4, 4), seed=1), (2, 2, 4, 4))
    tiled = TargetConfig("cuda", device="cpu",
                         plan_policy=LoweringPlan("cuda", vvl=32, bx=1, by=1, dtypes=BF16))
    with pytest.raises(ValueError, match="CUDA device"):
        PCG.make_fused_normal(u, 0.1, tiled)(p)
    for pol in (BF16, DtypePolicy()):   # a policy it has, and the empty one
        with pytest.raises(ValueError, match="CUDA device"):
            PCG.make_fused_normal(u, 0.1, dataclasses.replace(cuda, dtypes=pol))(p)
    # the flat chains with policy instances (cg_update, ludwig_chem_stress,
    # ludwig_lc_update) pass the plan checks and refuse the CPU fields; the
    # update chain's p update (cg_xpay) has none and refuses the policy
    f24 = {n: Field.from_numpy(n, rng.normal(size=(24,) + LAT).astype(np.float32), LAT)
           for n in ("x", "r", "p", "ap")}
    with pytest.raises(ValueError, match="CUDA device"):
        PCG.fused_cg_update(f24["x"], f24["r"], f24["p"], f24["ap"], 0.3, cuda)
    with pytest.raises(ValueError, match="no policy instance.*not yet ported"):
        PCG.fused_xpay(f24["r"], 0.3, f24["p"], cuda)
    lcfg = LudwigConfig(lattice=LAT, target=cuda)
    q5, q9, q15 = (Field.from_numpy("q", rng.normal(size=(nc,) + LAT).astype(np.float32), LAT)
                   for nc in (5, 9, 15))
    for graph, ins, outs in (
            (PLD.chem_stress_graph(lcfg), {"q": q5, "lapq": q5, "dq": q15}, ("h", "sigma")),
            (PLD.lc_update_graph(lcfg), {"q": q5, "h": q5, "w": q9, "adv": q5}, ("q_new",))):
        with pytest.raises(ValueError, match="CUDA device"):
            graph.launch(ins, config=cuda, outputs=outs)
    # a policy-free cuda launch whose fields would come back in bf16 raises
    f16 = {n: f.with_data(f.data.to(torch.bfloat16)) for n, f in f24.items()}
    with pytest.raises(ValueError, match="policy-free launch"):
        PCG.fused_cg_update(f16["x"], f16["r"], f16["p"], f16["ap"], 0.3,
                            TargetConfig("cuda", device="cpu"))

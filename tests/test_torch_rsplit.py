"""Split reductions (the ``rsplit`` plan axis) on the port, against the JAX
package (``tests/test_rsplit.py``'s contracts).

``ReduceSpec``'s stage-2 combine is bitwise the reference's; the plan axis
(describe, JSON, validate, ``_rsplit_factors``) mirrors it.  K2S's plain
emulation ``fold_tree_split`` is ``fold_tree`` at rsplit 1, within rtol 1e-5
(of the sum of the terms' magnitudes) of the reference's split pallas
launches (interpret mode), exact for max and int32 whatever the split,
batched rows bitwise the single row, compensated within the fp64 oracle
bound.  The reference's MILC solve under split plans agrees with the port's
torch-engine solve (which refuses a split, as the jnp engine does).  K2's
int32 and bf16 reductions on the torch engine: int32 bitwise the
reference's, bf16 within the bound derived in ``test_bf16_sum_and_max``."""

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
from repro.core import ReduceSpec as JSpec  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import fuse as JFuse  # noqa: E402
from repro.core import layout as JL  # noqa: E402
from repro.core import plan as JP  # noqa: E402
from repro.core import target_max as j_max  # noqa: E402
from repro.core import target_sum as j_sum  # noqa: E402
from repro_torch.apps.milc import MilcConfig, solve  # noqa: E402
from repro_torch.core import Field, TargetConfig, parse_layout  # noqa: E402
from repro_torch.core import fuse as PF  # noqa: E402
from repro_torch.core import plan as PP  # noqa: E402
from repro_torch.core import reduce as R  # noqa: E402

LAT = (4, 4, 8)   # 128 sites
SPECS = ["aos", "soa", "aosoa16"]
SUM_RTOL = 1e-5
ORACLE_RTOL = 2.5e-7   # |sum - fp64 sum| <= ORACLE_RTOL * sum|x| + 1e-6 (tests/test_dtype.py)
TORCH = TargetConfig("torch", device="cpu")


def _jcfg(rsplit, vvl=16):
    return JTC("pallas", plan_policy=JPlan("pallas", vvl=vvl, rsplit=rsplit, interpret=True))


def _close_sum(got, want, terms):
    """|got - want| <= SUM_RTOL x sum|terms| per component."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= SUM_RTOL * np.abs(np.asarray(terms, np.float64)).sum(axis=-1)), err


def _bits(a, b):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


# -- ReduceSpec: init, the stage-2 combine, the Kahan combine -----------------------

def test_reduce_spec_bitwise_the_reference(rng):
    """init (iinfo.min for an integer max, -inf, 0), combine_partials (a
    sequential fold in index order; max keeps NaN) and _kahan_combine
    bitwise the reference's."""
    for op in ("sum", "max"):
        for dt, jdt in ((torch.float32, jnp.float32), (torch.int32, jnp.int32)):
            got = PF.ReduceSpec(op).init((2, 3), dt)
            want = JSpec(op).init((2, 3), jdt)
            assert got.dtype == dt and np.array_equal(got.numpy(), np.asarray(want))
    assert int(PF.ReduceSpec("max").init((1,), torch.int32)[0]) == np.iinfo(np.int32).min
    parts = rng.normal(size=(7, 5, 3)).astype(np.float32) * 1e3
    parts[2, 1, 0] = np.nan
    for op in ("sum", "max"):
        for axis in (0, 1):
            got = PF.ReduceSpec(op).combine_partials(torch.from_numpy(parts), axis=axis)
            want = JSpec(op).combine_partials(jnp.asarray(parts), axis=axis)
            assert _bits(got.numpy(), np.asarray(want)), (op, axis)
    ip = rng.integers(-2**31, 2**31 - 1, size=(9, 4), dtype=np.int64).astype(np.int32)
    for op in ("sum", "max"):
        got = PF.ReduceSpec(op).combine_partials(torch.from_numpy(ip))
        assert np.array_equal(got.numpy(), np.asarray(JSpec(op).combine_partials(jnp.asarray(ip))))
    acc = rng.normal(size=(4, 3, 2)).astype(np.float32)
    part = rng.normal(size=(4, 3, 1)).astype(np.float32) * 1e-4
    got = PF._kahan_combine(torch.from_numpy(acc), torch.from_numpy(part))
    want = JFuse._kahan_combine(jnp.asarray(acc), jnp.asarray(part))
    assert _bits(got.numpy(), np.asarray(want))


# -- the plan axis -------------------------------------------------------------------

def test_plan_names_validates_and_factors_as_the_reference():
    """rs4 in describe() (and no rs at 1), JSON both ways, the reference's
    validate errors (the torch engine refuses a split as jnp does, the
    site-block and x-slab counts must divide), _rsplit_factors equal."""
    p = PP.LoweringPlan("cuda", vvl=16, rsplit=4)
    assert "rs4" in p.describe() and "rs" not in PP.LoweringPlan("cuda", vvl=16).describe()
    assert p.to_json()["rsplit"] == 4 and PP.LoweringPlan.from_json(p.to_json()) == p
    assert PP.LoweringPlan.from_json(JPlan("pallas", vvl=16, rsplit=4).to_json()).rsplit == 4
    soa = [parse_layout("soa")]
    cases = [(JPlan("jnp", rsplit=2), PP.LoweringPlan("torch", rsplit=2), {}),
             (JPlan("pallas", vvl=16, rsplit=3), PP.LoweringPlan("cuda", vvl=32, rsplit=3),
              dict(nsites=128, layouts=[JL.SOA])),   # 8 / 4 blocks: 3 divides neither
             (JPlan("pallas", bx=1, rsplit=3), PP.LoweringPlan("cuda", vvl=32, bx=1, rsplit=3),
              dict(nsites=128, layouts=[JL.SOA], lattice=LAT, stencil=True)),
             (JPlan("pallas", rsplit=0), PP.LoweringPlan("cuda", rsplit=0), {})]
    for jp, pp, kw in cases:
        with pytest.raises(ValueError) as je:
            jp.validate(**kw)
        with pytest.raises(ValueError) as pe:
            pp.validate(**{k: (soa if k == "layouts" else v) for k, v in kw.items()})
        for word in ("rsplit", "site-block", "x-slab count"):
            assert (word in str(je.value)) == (word in str(pe.value)), (je.value, pe.value)
    # an untiled stencil plan without an x-slab splits the site blocks
    with pytest.raises(ValueError, match="site-block"):
        PP.LoweringPlan("cuda", vvl=32, rsplit=3).validate(nsites=128, lattice=LAT, stencil=True)
    PP.LoweringPlan("cuda", vvl=32, bx=1, rsplit=4).validate(nsites=128, lattice=LAT,
                                                             stencil=True)
    # a tiled plan composes with a split (no tiled kernel holds a reduction)
    PP.LoweringPlan("cuda", bx=1, by=2, rsplit=2).validate(lattice=LAT, stencil=True)
    for n in (1, 2, 7, 12, 64, 96, 360, 1024, 4097):
        assert PP._rsplit_factors(n) == JP._rsplit_factors(n), n
        assert PP._rsplit_factors(n, cap=4, k=3) == JP._rsplit_factors(n, cap=4, k=3), n


def test_torch_engine_refuses_a_split_and_cuda_raises_before_the_device(rng):
    x = Field.from_numpy("x", rng.normal(size=(3,) + LAT).astype(np.float32), LAT)
    with pytest.raises(ValueError, match="rsplit"):
        R.target_sum(x, TargetConfig("torch", plan_policy=PP.LoweringPlan("torch", rsplit=2)))
    with pytest.raises(ValueError, match="CUDA device"):
        R.target_sum(x, TargetConfig("cuda", device="cpu",
                                     plan_policy=PP.LoweringPlan("cuda", vvl=32, rsplit=2)))


# -- K2S's emulation ------------------------------------------------------------------

@pytest.mark.parametrize("nrows", [1, 3, 64, 673, 1345, 4096])
def test_fold_tree_split(nrows, rng):
    """fold_tree_split: rsplit 1 bitwise fold_tree; max and int32 bitwise
    across splits and the plain fold; batched rows bitwise the single row;
    the split's segments are core.reduce.segments; compensated within the
    oracle bound of the fp64 sum; the CPU fold_partials is split_plain."""
    p = torch.from_numpy((rng.normal(size=(nrows, 24)) * 10).astype(np.float32))
    ip = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(nrows, 24),
                                       dtype=np.int64).astype(np.int32))
    assert torch.equal(R.fold_tree_split(p), R.fold_tree(p))
    for rs in (1, 2, 4, 8, 16):
        seg = R.segments(nrows, rs)
        assert seg[0][0] == 0 and seg[-1][1] == nrows and len(seg) == rs
        assert all(a[1] == b[0] for a, b in zip(seg, seg[1:]))
        assert torch.equal(R.fold_tree_split(p, "max", rsplit=rs), p.amax(dim=0))
        assert torch.equal(R.fold_tree_split(ip, "sum", rsplit=rs), ip.sum(0, dtype=torch.int32))
        assert torch.equal(R.fold_tree_split(ip, "max", rsplit=rs), ip.amax(dim=0))
        got = R.fold_tree_split(p, rsplit=rs)
        _close_sum(got.numpy(), p.double().sum(0).numpy(), p.T.numpy())
        rows = R.fold_tree_split(torch.stack([p * 2, p, -p]), rsplit=rs)
        assert torch.equal(rows[1], got)
        pairs = torch.stack([p, p * 2.0 ** -30], dim=-1)
        gc = R.fold_tree_split(pairs, compensated=True, rsplit=rs)
        exact = pairs.double().sum(dim=(0, 2))
        bound = ORACLE_RTOL * pairs.double().abs().sum(dim=(0, 2)) + 1e-6
        assert bool(((gc.double() - exact).abs() <= bound).all()), rs
        assert torch.equal(R.fold_partials(p, "sum", rsplit=rs), R.split_plain(p, "sum", rs))
        assert torch.equal(R.fold_partials(ip, "max", rsplit=rs), ip.amax(dim=0))
    assert R.fold_scratch(nrows, 24, 1) == R.fold_scratch(nrows, 24)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rsplit", [2, 4, 8])
def test_split_within_the_reference_split_launches(spec, rsplit, rng):
    """K2's split tree (reduce_tree with rsplit) against the reference's
    split pallas target_sum and split _dot_graph launch at (4, 4, 8):
    within 1e-5 x sum|terms|; max exact; both split trees bitwise the
    unsplit one's field-free counterparts where they must be."""
    x = rng.normal(size=(3,) + LAT).astype(np.float32)
    y = rng.normal(size=(3,) + LAT).astype(np.float32)
    jlay = JL.parse_layout(spec)
    fx, fy = JField.from_numpy("x", x, LAT, jlay), JField.from_numpy("y", y, LAT, jlay)
    tx, ty = torch.from_numpy(x.reshape(3, -1)), torch.from_numpy(y.reshape(3, -1))
    got = R.reduce_tree(tx, rsplit=rsplit)
    _close_sum(got.numpy(), np.asarray(j_sum(fx, _jcfg(rsplit))), x.reshape(3, -1))
    assert torch.equal(R.reduce_tree(tx, "max", rsplit=rsplit),
                       torch.from_numpy(np.asarray(j_max(fx, _jcfg(rsplit)))))
    g = (JLaunchGraph("rs_dot")
         .add(lambda v: {"t": v["x"] * v["y"]}, {"x": "x", "y": "y"}, {"t": 3})
         .add_reduce("t", op="sum", name="dot"))
    want = g.launch({"x": fx, "y": fy}, config=_jcfg(rsplit), outputs=("dot",))["dot"]
    prod = tx * ty
    _close_sum(R.reduce_tree(prod, rsplit=rsplit).numpy(), np.asarray(want), prod.numpy())
    # the port's own split of the same product: bitwise its tree, within tolerance
    # of the unsplit tree
    _close_sum(R.reduce_tree(prod, rsplit=rsplit).numpy(), R.reduce_tree(prod).numpy(),
               prod.numpy())


# -- dtypes on the torch engine -------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_int32_sum_and_max_bitwise_the_reference(spec, rng):
    """target_sum / target_max of an int32 field (a component past 2^31:
    the sum wraps) on the torch engine bitwise the reference's jnp and split
    pallas launches; the tree emulation (the card's bits) too, at any split."""
    di = rng.integers(-2**20, 2**20, size=(3, 128)).astype(np.int32)
    di[1] = 2**30 + 5
    lay, jlay = parse_layout(spec), JL.parse_layout(spec)
    fi = Field.from_canonical("xi", torch.from_numpy(di), LAT, lay)
    jfi = JField.from_canonical("xi", jnp.asarray(di), LAT, jlay)
    for op, pf, jf in (("sum", R.target_sum, j_sum), ("max", R.target_max, j_max)):
        got = pf(fi, TORCH)
        assert got.dtype == torch.int32
        for jcfg in (JTC("jnp"), _jcfg(2), _jcfg(1)):
            assert np.array_equal(got.numpy(), np.asarray(jf(jfi, jcfg))), (op, jcfg)
        for rs in (1, 2, 4):
            assert torch.equal(R.reduce_tree(torch.from_numpy(di), op, rsplit=rs), got)


def test_bf16_sum_and_max(rng):
    """A bf16 field on the torch engine: max bitwise the reference's; the
    sum within one bf16 ulp of the fp64 sum rounded (it is rounded once),
    as K2's bf16 instance (its tree on the widened field, rounded once),
    and within the reference's error bound of its pallas launch.  The
    reference accumulates its (ncomp, vvl) rows in bf16 over nblocks grid
    steps and folds the vvl lanes in bf16: at most nblocks + vvl roundings,
    each within 2^-8 (bf16's unit roundoff) of a partial no larger than
    sum|x|; so |port - reference| <= (nblocks + vvl + 1) 2^-8 sum|x|."""
    x = (1.0 + rng.random(size=(3, 128))).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    f = Field.from_canonical("x", xb, LAT)
    jf = JField.from_canonical("x", jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), LAT)
    got = R.target_sum(f, TORCH)
    assert got.dtype == torch.bfloat16
    want = xb.double().sum(dim=1).to(torch.bfloat16)
    ulp = torch.pow(2.0, torch.floor(torch.log2(want.double().abs())) - 7)
    assert bool(((got.double() - want.double()).abs() <= ulp).all())
    tree = R.reduce_tree(xb)
    assert bool(((tree.double() - want.double()).abs() <= ulp).all())
    vvl, nblocks = 16, 128 // 16
    terms = xb.double().abs().sum(dim=1).numpy()
    for jcfg in (_jcfg(1, vvl), _jcfg(2, vvl), JTC("jnp")):
        ref = np.asarray(j_sum(jf, jcfg)).astype(np.float64)
        assert np.all(np.abs(got.double().numpy() - ref) <= (nblocks + vvl + 1) * 2.0**-8 * terms)
        assert np.array_equal(R.target_max(f, TORCH).float().numpy(),
                              np.asarray(j_max(jf, jcfg)).astype(np.float32))


# -- the whole slice ------------------------------------------------------------------

def test_reference_split_solve_against_the_port():
    """The reference's MILC solve at (4, 4, 4, 4) with every launch under a
    split plan (rsplit 2: the site-local launches on site blocks of 64, the
    fused normal operator on x-slabs) against the port's torch-engine solve:
    iterations within +-1, x within rel-L2 1e-4."""
    kw = dict(lattice=(4, 4, 4, 4), kappa=0.1, tol=1e-8, max_iter=200)
    jsite = JTC("pallas", plan_policy=JPlan("pallas", vvl=64, rsplit=2, interpret=True))
    jsten = JTC("pallas", plan_policy=JPlan("pallas", bx=1, rsplit=2, interpret=True))
    jcfg = JMilcConfig(target=jsite, **kw)
    ju, jb = j_init(jcfg, seed=0)
    _, apply_mdag, apply_normal = JCG.make_wilson_op(ju, jcfg.kappa, jsite)
    jres = JCG.cg(apply_normal, apply_mdag(jb), config=jsite, tol=jcfg.tol,
                  max_iter=jcfg.max_iter,
                  apply_a_dot=JCG.make_fused_normal(ju, jcfg.kappa, jsten))
    cfg = MilcConfig(target=TORCH, **kw)
    u = Field.from_numpy("u", np.asarray(ju.to_numpy()), kw["lattice"])
    b = Field.from_numpy("b", np.asarray(jb.to_numpy()), kw["lattice"])
    res = solve(cfg, u, b)
    assert abs(res.iterations - int(jres.iterations)) <= 1
    x, jx = res.x.to_numpy(), np.asarray(jres.x.to_numpy())
    assert np.linalg.norm(x - jx) / np.linalg.norm(jx) < 1e-4

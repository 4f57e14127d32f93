"""The sharded plans under ``halo="pre"`` and ``"overlap"``: tiles, ``rsplit``
and the block view on pre-exchanged halos, held to the JAX package.

The JAX package's acceptance tests for this path
(tests/test_distributed.py::test_native_block_view_sharded_bit_identical
and ::test_tiled_lowering_sharded_bit_identical) launch the fused LB step
on the blocks of a (4, 2) mesh over LAT (16, 8, 8): (4, 4, 8) blocks, each
padded by its ring and exchanged.  Here each block with its ring is cut
from the periodic global array (what a rank holds after the exchange) and
launched locally: on the port's cuda engine with the device check lifted,
so that every kernel wrapper runs its plain version (K9H's and K5LH's,
K5TH's and K5H's, K5HO's), and through the JAX package's pallas engine in
interpret mode.  Held, for tiles (2, 0), (0, 4) and (2, 4) on bx 1,
aosoa(4) and SoA, views "staged-nd" and "block", halos "pre" and
"overlap": every configuration bitwise the untiled staged SoA "pre" launch
of the same block; the JAX package's launch of each configuration bitwise
its own untiled staged SoA "pre" launch (the claim of its acceptance
tests) and the port's within rtol 1e-6, atol 1e-6 x the largest magnitude
(the port's plain collision and XLA's CPU one round some sums apart by an
ulp, so the two packages agree to that bound, not bitwise, on the CPU);
the single-device jnp oracle within rtol 1e-5, atol 1e-6 (the reference
tests' own tolerance).  The same for ``wilson_normal`` tiled under "pre"
and "overlap" on (6, 5, 5, 5) blocks, against the reference within rtol
1e-5, atol 1e-6 x the output's largest magnitude (the Wilson hop's adds
are not the reference's in order).  Beside them: the block view's
refusals under "pre" against the reference's ``_block_geometry``;
``rsplit`` 2 under "pre" leaving the field outputs bitwise; the extended
walks (K9H's box grown by its ring, K5TH's ring-1 array, tiled K5HO's box
tables) each covering every site once; under "pre" ``candidate_plans``
equal to the reference's, its tile and block-view twins timed by a sweep
with none failed; the default "overlap" plan under a budget following the
reference's (untiled, the sub-plans' slabs alike).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.apps.milc import cg as JCG  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import SOA as J_SOA  # noqa: E402
from repro.core import LoweringPlan as JPlan  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import aosoa as jaosoa  # noqa: E402
from repro.core import overlap as joverlap  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.kernels.lb_propagation.ops import collide_propagate_graph as jcp_graph  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig  # noqa: E402
from repro_torch.apps.ludwig import driver as PLD  # noqa: E402
from repro_torch.apps.milc import cg as PCG  # noqa: E402
from repro_torch.core import SOA, Field, LoweringPlan, TargetConfig, aosoa, parse_layout  # noqa: E402,E501
from repro_torch.core import overlap, tune  # noqa: E402
from repro_torch.core import fuse as PFU  # noqa: E402
from repro_torch.core import plan as PP  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as lbk  # noqa: E402
from repro_torch.kernels.lb_propagation.ops import collide_propagate_graph  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as wk  # noqa: E402

LAT, BLOCK = (16, 8, 8), (4, 4, 8)        # the (4, 2) mesh's blocks
BLOCKS = ((0, 0, 0), (3, 1, 0))           # two of its eight
TILES = ((0, 0), (2, 0), (0, 4), (2, 4))  # (by, bz) on bx 1; (0, 0) untiled
TAU = 0.8
CUDA_ON_CPU = TargetConfig("cuda", device="cpu", vvl=64)
TORCH = TargetConfig("torch", device="cpu")
J_PALLAS = JTC("pallas", vvl=64)
ORACLE_RTOL, ORACLE_ATOL = 1e-5, 1e-6
# the port against the JAX package's launch of one block: rtol 1e-6, atol
# 1e-6 x the output's largest magnitude (tests/test_torch_halo.py's bound)
REF_RTOL = 1e-6
# wilson_normal: blocks of (6, 5, 5, 5) from a (12, 5, 5, 5) lattice, ring 2
WLAT, WBLOCK, WBLOCKS, KAPPA = (12, 5, 5, 5), (6, 5, 5, 5), ((0, 0, 0, 0), (1, 0, 0, 0)), 0.12
W_TILES = ((0, 0, 0), (2, 1, 5), (3, 5, 1))   # (bx, by, bz); (0, 0, 0) untiled
W_RTOL = W_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cold_reference_caches():
    """Drop JAX's compiled kernels when this file is done: the JAX package's
    tests/test_overlap.py counts the pallas_calls its split constructs,
    which the reference launches here would otherwise leave compiled for a
    later file in the same process."""
    yield
    jax.clear_caches()


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


def _globals(seed=0):
    rng = np.random.default_rng(seed)
    dist = (1.0 + 0.1 * rng.normal(size=(19, *LAT))).astype(np.float32)
    force = (0.01 * rng.normal(size=(3, *LAT))).astype(np.float32)
    return dist, force


def _block(arr, coords, block, ring):
    """The block at ``coords`` of ``arr`` (ncomp, *lattice) with its ring,
    cut from the periodic global array: what the rank holds once its halos
    are exchanged."""
    padded = np.pad(arr, [(0, 0)] + [(ring, ring)] * (arr.ndim - 1), mode="wrap")
    return np.ascontiguousarray(padded[(slice(None),) + tuple(
        slice(c * b, c * b + b + 2 * ring) for c, b in zip(coords, block))])


def _interior(arr, coords, block):
    return arr[(slice(None),) + tuple(slice(c * b, (c + 1) * b) for c, b in zip(coords, block))]


def _port(name, arr, lay):
    return Field.from_canonical(name, torch.from_numpy(arr), tuple(arr.shape[1:]), lay)


def _ref(name, arr, lay=J_SOA):
    return JField.from_canonical(name, jnp.asarray(arr), tuple(arr.shape[1:]), lay)


CONFIGS = [(lay, view) for lay, view in (("soa", "staged-nd"), ("aosoa4", "staged-nd"),
                                         ("aosoa4", "block"))]


@pytest.fixture(scope="module")
def lb_oracle():
    """The single-device jnp launch of the fused LB step over LAT."""
    dist, force = _globals()
    out = jcp_graph(TAU).launch({"dist": _ref("dist", dist, jaosoa(4)),
                                 "force": _ref("force", force, jaosoa(4))},
                                config=JTC("jnp"), outputs=("dist2",))["dist2"]
    return np.asarray(out.canonical_nd())


@pytest.fixture(scope="module")
def lb_reference_base():
    """The JAX package's untiled staged SoA "pre" pallas (interpret) launch
    of the first block."""
    dist, force = _globals()
    d, f = _block(dist, BLOCKS[0], BLOCK, 1), _block(force, BLOCKS[0], BLOCK, 1)
    out = jcp_graph(TAU).launch({"dist": _ref("dist", d), "force": _ref("force", f)},
                                config=J_PALLAS, outputs=("dist2",), halo="pre",
                                plan=JPlan("pallas", bx=1, halo="pre", interpret=True))
    return np.asarray(out["dist2"].canonical_nd())


def _close(got, want, rtol=REF_RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("tile", TILES, ids=str)
@pytest.mark.parametrize("halo", ["pre", "overlap"])
@pytest.mark.parametrize("lay,view", CONFIGS)
def test_lb_block_plans_bitwise_the_staged_pre_launch(lay, view, halo, tile, cuda_on_cpu,
                                                      lb_oracle, lb_reference_base):
    """The reference tests' configurations on two blocks: the port's launch
    (K9H's plain version; under "overlap" the split's boxes, each in its
    sub-plan's tiles) in the requested layout, bitwise the untiled staged
    SoA "pre" launch and within the jnp oracle's tolerance; on the first
    block the JAX package's pallas (interpret) launch of the configuration
    bitwise its untiled staged SoA "pre" launch and the port's within
    REF_RTOL."""
    dist, force = _globals()
    g, jg = collide_propagate_graph(TAU), jcp_graph(TAU)
    by, bz = tile
    layout = SOA if lay == "soa" else aosoa(4)
    plan = LoweringPlan("cuda", vvl=64, bx=1, by=by, bz=bz, halo=halo, view=view)
    for k, coords in enumerate(BLOCKS):
        d, f = _block(dist, coords, BLOCK, 1), _block(force, coords, BLOCK, 1)
        base = g.launch({"dist": _port("dist", d, SOA), "force": _port("force", f, SOA)},
                        config=TORCH, outputs=("dist2",), halo="pre")["dist2"]
        got = g.launch({"dist": _port("dist", d, layout), "force": _port("force", f, layout)},
                       config=CUDA_ON_CPU, outputs=("dist2",), halo=halo,
                       plan=plan)["dist2"]
        assert got.layout == layout and got.lattice == BLOCK
        assert torch.equal(got.canonical(), base.canonical()), (coords, plan.describe())
        np.testing.assert_allclose(got.canonical_nd().numpy(),
                                   _interior(lb_oracle, coords, BLOCK),
                                   rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
        if k:
            continue
        # the JAX package's launch of the same block: bitwise its own untiled
        # staged SoA "pre" launch (its acceptance tests' claim), the port's
        # within REF_RTOL (XLA's CPU collision rounds some sums another way)
        jlay = jaosoa(4) if lay == "aosoa4" else J_SOA
        jins = {"dist": _ref("dist", d, jlay), "force": _ref("force", f, jlay)}
        jplan_ = JPlan("pallas", bx=1, by=by, bz=bz, halo=halo, view=view, interpret=True)
        want = np.asarray(jg.launch(jins, config=J_PALLAS, outputs=("dist2",), halo=halo,
                                    plan=jplan_)["dist2"].canonical_nd())
        np.testing.assert_array_equal(want, lb_reference_base)
        _close(got.canonical_nd().numpy(), want)


@pytest.mark.parametrize("halo", ["pre", "overlap"])
def test_ludwig_lb_step_plans_bitwise_on_every_layout(halo, cuda_on_cpu):
    """The ludwig_lb_step graph (dist2 and u) on the first block: tiled,
    in AoS, aosoa(4) and the block view, bitwise the torch engine's
    untiled SoA "pre" launch."""
    dist, force = _globals(1)
    g = PLD.lb_step_graph(LudwigConfig(tau=TAU))
    d, f = _block(dist, BLOCKS[1], BLOCK, 1), _block(force, BLOCKS[1], BLOCK, 1)
    base = g.launch({"dist": _port("dist", d, SOA), "force": _port("force", f, SOA)},
                    config=TORCH, outputs=("dist2", "u"), halo="pre")
    for lay, view, (by, bz) in (("aos", "staged-nd", (2, 4)), ("aosoa4", "block", (0, 4)),
                                ("aosoa4", "block", (0, 0)), ("soa", "staged-nd", (2, 0))):
        layout = parse_layout(lay)
        plan = LoweringPlan("cuda", vvl=64, bx=1, by=by, bz=bz, halo=halo, view=view)
        out = g.launch({"dist": _port("dist", d, layout), "force": _port("force", f, layout)},
                       config=CUDA_ON_CPU, outputs=("dist2", "u"), halo=halo, plan=plan)
        for n in ("dist2", "u"):
            assert out[n].layout == layout
            assert torch.equal(out[n].canonical(), base[n].canonical()), (lay, view, n)


def _wilson_globals():
    rng = np.random.default_rng(2)
    p = rng.normal(size=(24, *WLAT)).astype(np.float32)
    u = (0.3 * rng.normal(size=(72, *WLAT))).astype(np.float32)
    return p, u


@pytest.fixture(scope="module")
def wilson_oracle():
    p, u = _wilson_globals()
    out = JCG.wilson_normal_graph(KAPPA).launch(
        {"p": _ref("p", p), "u": _ref("u", u)}, config=JTC("jnp"),
        outputs=("ap",))["ap"]
    return np.asarray(out.canonical_nd())


@pytest.mark.parametrize("tile", W_TILES, ids=str)
@pytest.mark.parametrize("halo", ["pre", "overlap"])
def test_wilson_normal_tiled_pre_and_overlap(halo, tile, cuda_on_cpu, wilson_oracle):
    """wilson_normal tiled under "pre" (K5TH's plain version, the tiles'
    windows cut from the halo'd arrays) and "overlap" (K5HO's box tables,
    the ap rows in each box's sub-plan tiles) on two (6, 5, 5, 5) blocks:
    bitwise the untiled "pre" launch; the JAX package's pallas (interpret)
    launch of the first block and the jnp oracle within rtol, atol 1e-5
    (x the largest magnitude for the reference launch)."""
    p, u = _wilson_globals()
    g = PCG.wilson_normal_graph(KAPPA)
    bx, by, bz = tile
    plan = LoweringPlan("cuda", vvl=64, bx=bx, by=by, bz=bz, halo=halo)
    for k, coords in enumerate(WBLOCKS):
        pb, ub = _block(p, coords, WBLOCK, 2), _block(u, coords, WBLOCK, 2)
        ins = {"p": _port("p", pb, SOA), "u": _port("u", ub, SOA)}
        base = g.launch(ins, config=TORCH, outputs=("ap",), halo="pre")["ap"]
        got = g.launch(ins, config=CUDA_ON_CPU, outputs=("ap",), halo=halo, plan=plan)["ap"]
        assert torch.equal(got.data, base.data), (coords, plan.describe())
        np.testing.assert_allclose(got.canonical_nd().numpy(),
                                   _interior(wilson_oracle, coords, WBLOCK),
                                   rtol=W_RTOL, atol=W_ATOL)
        if k or not bx:
            continue
        want = JCG.wilson_normal_graph(KAPPA).launch(
            {"p": _ref("p", pb), "u": _ref("u", ub)}, config=J_PALLAS,
            outputs=("ap",), halo=halo,
            plan=JPlan("pallas", bx=bx, by=by, bz=bz, halo=halo, interpret=True))["ap"]
        want = np.asarray(want.canonical_nd())
        np.testing.assert_allclose(got.canonical_nd().numpy(), want, rtol=W_RTOL,
                                   atol=W_ATOL * np.abs(want).max())


@pytest.mark.parametrize("lay,block_ok", [("aosoa8", False), ("soa", False), ("aosoa4", True),
                                          ("aosoa2", True)])
def test_block_view_refusals_under_pre_match_the_reference(lay, block_ok, cuda_on_cpu):
    """An explicit view="block" under "pre" is checked on the halo'd
    lattices as the reference's ``_block_geometry`` checks it, before any
    device is touched: an AoSoA input whose SAL does not divide the halo'd
    inner-plane count (60 at the (4, 4, 8) block), or no AoSoA at all,
    raises in both; aosoa(4) runs in both."""
    from repro.core import parse_layout as jparse
    dist, force = _globals()
    d, f = _block(dist, BLOCKS[0], BLOCK, 1), _block(force, BLOCKS[0], BLOCK, 1)
    layout, jlayout = parse_layout(lay), jparse(lay)
    for plan_kw in (dict(), dict(by=2)):
        plan = LoweringPlan("cuda", vvl=64, bx=1, view="block", **plan_kw)
        jplan_ = JPlan("pallas", bx=1, view="block", interpret=True, **plan_kw)
        outcome = []
        for launch in (
                lambda: collide_propagate_graph(TAU).launch(
                    {"dist": _port("dist", d, layout), "force": _port("force", f, layout)},
                    config=CUDA_ON_CPU, outputs=("dist2",), halo="pre", plan=plan),
                lambda: jcp_graph(TAU).launch(
                    {"dist": _ref("dist", d, jlayout), "force": _ref("force", f, jlayout)},
                    config=J_PALLAS, outputs=("dist2",), halo="pre", plan=jplan_)):
            try:
                launch()
                outcome.append(None)
            except ValueError as e:
                assert "view='block'" in str(e), e
                outcome.append("raised")
        assert outcome[0] == outcome[1] == (None if block_ok else "raised"), (lay, plan_kw)


def test_rsplit_under_pre_leaves_the_field_outputs_bitwise(cuda_on_cpu):
    """rsplit 2 under "pre" and "overlap": no "pre" or box kernel folds
    partial rows, so the field outputs are the rsplit-1 launch's bits; a
    reduction under "pre" still raises on the cuda engine, naming ROADMAP,
    and the torch engine refuses a split as it does on one device."""
    dist, force = _globals()
    d, f = _block(dist, BLOCKS[0], BLOCK, 1), _block(force, BLOCKS[0], BLOCK, 1)
    g = collide_propagate_graph(TAU)
    ins = {"dist": _port("dist", d, aosoa(4)), "force": _port("force", f, aosoa(4))}
    for halo in ("pre", "overlap"):
        one, two = (g.launch(ins, config=CUDA_ON_CPU, outputs=("dist2",), halo=halo,
                             plan=LoweringPlan("cuda", vvl=64, bx=1, rsplit=r, halo=halo))
                    for r in (1, 2))
        assert torch.equal(one["dist2"].data, two["dist2"].data)
    p, u = _wilson_globals()
    pb, ub = _block(p, WBLOCKS[0], WBLOCK, 2), _block(u, WBLOCKS[0], WBLOCK, 2)
    wins = {"p": _port("p", pb, SOA), "u": _port("u", ub, SOA)}
    wg = PCG.wilson_normal_graph(KAPPA)
    one, two = (wg.launch(wins, config=CUDA_ON_CPU, outputs=("ap",), halo="pre",
                          plan=LoweringPlan("cuda", vvl=64, bx=1, by=5, bz=5, rsplit=r))
                for r in (1, 3))
    assert torch.equal(one["ap"].data, two["ap"].data)
    with pytest.raises(ValueError, match="produces.*ROADMAP"):
        wg.launch(wins, config=CUDA_ON_CPU, outputs=("ap", "pap"), halo="pre",
                  plan=LoweringPlan("cuda", vvl=64, bx=1, rsplit=3))
    with pytest.raises(ValueError, match="rsplit"):
        wg.launch(wins, config=TORCH, outputs=("ap", "pap"), halo="pre",
                  plan=LoweringPlan("torch", rsplit=3))


@pytest.mark.parametrize("lat,tile", [((4, 4, 8), (1, 2, 4)), ((5, 3, 4), (5, 1, 2)),
                                      ((2, 6, 3), (2, 6, 3)), ((1, 1, 1), (1, 1, 1))])
def test_k9h_walk_covers_the_grown_box_once(lat, tile):
    """K9H's tiled walk over a box grown by its ring (tiled_walk ring=1):
    the box's sites in K9's tile order, each placed 1 in, then the ring;
    every site of the grown box once, the box's first."""
    w = lbk.tiled_walk(lat, tile, ring=1)
    grown = tuple(s + 2 for s in lat)
    assert sorted(w.tolist()) == list(range(math.prod(grown)))
    inner = torch.zeros(grown, dtype=torch.bool)
    inner[tuple(slice(1, s + 1) for s in lat)] = True
    n = math.prod(lat)
    assert inner.reshape(-1)[w[:n]].all() and not inner.reshape(-1)[w[n:]].any()
    base = lbk.tiled_walk(lat, tile)
    X, Y, Z = lat
    back = (((w[:n] // ((Y + 2) * (Z + 2))) - 1) * Y + (w[:n] // (Z + 2)) % (Y + 2) - 1) * Z \
        + w[:n] % (Z + 2) - 1
    assert torch.equal(back, base)


@pytest.mark.parametrize("lat,tile", [((6, 5, 5, 5), (2, 1, 5)), ((4, 3, 5, 4), (1, 3, 1)),
                                      ((2, 2, 2, 2), (2, 2, 2))])
def test_k5th_walks_cover_the_interior_and_the_ring_once(lat, tile):
    """K5TH's walks: ap's the interior in K5T's order, t's the ring-1 array
    (normal_walk ring=1) by rows whole along T, the interior's (x, y, z)
    rows first, in the walk's order, then the shell's; each site once."""
    assert sorted(wk.normal_walk(lat, tile).tolist()) == list(range(math.prod(lat)))
    w = wk.normal_walk(lat, tile, ring=1)
    grown = tuple(s + 2 for s in lat)
    assert sorted(w.tolist()) == list(range(math.prod(grown)))
    rows = w.reshape(-1, grown[3])
    assert (rows == rows[:, :1] + torch.arange(grown[3])).all()
    xyz = rows[:, 0] // grown[3]
    gx, gy, gz = xyz // (grown[1] * grown[2]), (xyz // grown[2]) % grown[1], xyz % grown[2]
    inside = ((gx >= 1) & (gx <= lat[0]) & (gy >= 1) & (gy <= lat[1]) & (gz >= 1)
              & (gz <= lat[2]))
    n = lat[0] * lat[1] * lat[2]
    assert inside[:n].all() and not inside[n:].any()
    walk = wk.normal_walk(lat[:3] + (1,), tile)
    assert torch.equal(((gx - 1) * lat[1] + gy - 1)[:n] * lat[2] + (gz - 1)[:n], walk)


def _tiled_table_sites(entries, tiles, block):
    """The kernels' block -> site map of a table launch whose boxes carry
    tiles (csrc's rt_htab_site, tile path): a box's slots (_row_lanes a
    row) cut linearly into blocks, slot row j the j-th (x, y, z) of the
    tile walk (rt_walk_site with T 1), lanes past the row's T sites idle;
    array coordinates (x, y, z, t) or None a thread."""
    from repro_torch._cuda import csrc_define
    out = []
    for (o, e, ts, tg), tile in zip(entries, tiles):
        g = 0 if e[3] > csrc_define("wilson_halo.cu", "RT_HROW_LANES_MAX") else \
            1 << (e[3] - 1).bit_length()
        w = g or e[3]
        walk = wk.normal_walk(tuple(e[:3]) + (1,), tile).tolist()
        nslots = e[0] * e[1] * e[2] * w
        for b in range(-(-nslots // block)):
            row = []
            for th in range(block):
                q = b * block + th
                r, lane = divmod(q, w)
                if r >= e[0] * e[1] * e[2] or lane >= e[3]:
                    row.append(None)
                    continue
                xyz = walk[r]
                x, y, z = xyz // (e[1] * e[2]), (xyz // e[2]) % e[1], xyz % e[2]
                tt = lane + (tg if lane >= ts else 0)
                row.append((o[0] + x, o[1] + y, o[2] + z, o[3] + tt))
            out.append(row)
    return out


@pytest.mark.parametrize("dims", [(0, 1, 2, 3), (3,), (0, 2)], ids=str)
@pytest.mark.parametrize("block", [32, 128])
def test_tiled_k5ho_ap_tables_cover_every_site_once(dims, block):
    """Tiled K5HO: the ap tables' boxes carry their sub-plans' tiles
    (split_tiles; a paired T-slab entry its first slab's) and the kernels'
    tiled block map covers every interior site once."""
    from repro_torch.core.overlap import split_boxes
    lat = (6, 7, 5, 6)
    interior, boundary = split_boxes(lat, 2, dims)
    oe = [(tuple(a for a, _ in b), tuple(c - a for a, c in b)) for b in [interior] + boundary]
    outer = LoweringPlan("cuda", vvl=64, bx=1, by=7, bz=5, halo="overlap")
    tiles = []
    for o, e in oe:
        sub = PP.sub_lattice_plan(outer, CUDA_ON_CPU, e, halo="pre")
        tiles.append(PP.plan_tile(sub))
    tabs = wk.split_tables(lat, oe[0], oe[1:])
    etiles = wk.split_tiles(oe[0], oe[1:], tiles)
    seen = np.zeros(lat, dtype=np.int32)
    ntiled = 0
    for part in ("interior ap", "boundary ap"):
        ents, tl = tabs[part][1], etiles[part]
        assert len(tl) == len(ents)
        for ent, t in zip(ents, tl):
            if t is None:   # an untiled sub-plan: the brick order (test_torch_k5ho.py)
                seen[wk._entry_mask(lat, [ent], "cpu").numpy()] += 1
                continue
            ntiled += 1
            assert all(n % x == 0 for n, x in zip(ent[1][:3], t))
            for row in _tiled_table_sites([ent], [t], block):
                for c in row:
                    if c is not None:
                        seen[c] += 1
    assert ntiled and (seen == 1).all()


def _to_port(ref, vvl):
    """A reference stencil candidate as the port's: engine mapped, the
    port's block size, the default view "auto" (tests/test_torch_tune.py)."""
    p = convert.to_plan(ref.to_json())
    view = p.view if p.view == PP.VIEW_BLOCK else PP.VIEW_AUTO
    return dataclasses.replace(p, vvl=vvl, view=view)


def test_pre_candidates_match_the_reference_and_sweep_clean(cuda_on_cpu, tmp_path, monkeypatch):
    """Under "pre" the candidate set is the reference's, its tile,
    block-view (and, for wilson_normal, split) twins included, and a sweep
    of each graph's launch times every candidate with none failed (the
    cuda engine's planning on CPU fields, the wrappers' plain versions)."""
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "t.json"))
    monkeypatch.delenv(PP.SMEM_ENV, raising=False)
    tune.clear_table_cache()
    kw = dict(nsites=math.prod(BLOCK), stencil=True, lattice=BLOCK, halo="pre", devices=1)
    got = PP.candidate_plans(CUDA_ON_CPU, layouts=[aosoa(4)], **kw)
    ref = jplan.candidate_plans(J_PALLAS, layouts=[jaosoa(4)], **kw)
    assert got == tuple(_to_port(r, got[0].vvl) for r in ref)
    assert any(c.tiled for c in got) and any(c.view == PP.VIEW_BLOCK for c in got)
    dist, force = _globals()
    d, f = _block(dist, BLOCKS[0], BLOCK, 1), _block(force, BLOCKS[0], BLOCK, 1)
    p, u = _wilson_globals()
    pb, ub = _block(p, WBLOCKS[0], WBLOCK, 2), _block(u, WBLOCKS[0], WBLOCK, 2)
    for g, ins, outs, twins in (
            (collide_propagate_graph(TAU),
             {"dist": _port("dist", d, aosoa(4)), "force": _port("force", f, aosoa(4))},
             ("dist2",), ("tiled", "block")),
            (PCG.wilson_normal_graph(KAPPA), {"p": _port("p", pb, SOA), "u": _port("u", ub, SOA)},
             ("ap",), ("tiled", "rsplit"))):
        plan, info = tune.autotune_graph(g, ins, config=CUDA_ON_CPU, outputs=outs, halo="pre",
                                         iters=1, warmup=0)
        # only the dtype-policy twins fail: a policy under "pre" is still to
        # be ported (ROADMAP queue 2 (e))
        assert all("/dt=" in c for c in info["failed"]), info["failed"]
        timed = list(info["timings_us"])
        assert ("tiled" not in twins or any("/ty" in t or "/tz" in t for t in timed)), timed
        assert ("block" not in twins or any("/block" in t for t in timed)), timed
        assert ("rsplit" not in twins or any("/rs" in t for t in timed)), timed
    tune.clear_table_cache()


def test_default_overlap_plan_under_a_budget_follows_the_reference(monkeypatch):
    """With no plan and a shared-memory budget, overlap_launch's outer plan
    is the reference's default "overlap" plan: untiled (no footprint is
    priced), each box's sub-plan the reference's slab, no tiles."""
    budget = 2048
    dist, force = _globals()
    d, f = _block(dist, BLOCKS[0], BLOCK, 1), _block(force, BLOCKS[0], BLOCK, 1)
    cfg = TargetConfig("cuda", device="cpu", vvl=64, smem_bytes=budget)
    # the budget tiles the "pre" launch's default plan
    assert PP.default_plan(cfg, nsites=math.prod(BLOCK), layouts=[SOA], stencil=True,
                           lattice=BLOCK, smem_views=(((19, 1, 4), (3, 1, 4)), ((19, 4),)),
                           bounded=True, halo="pre").tiled
    seen = {}
    real = overlap._split_launch

    def spy(graph, ins, **kw):
        seen["plan"] = kw["plan"]
        raise RuntimeError("stop")

    monkeypatch.setattr(overlap, "_split_launch", spy)
    ins = {"dist": _port("dist", d, SOA), "force": _port("force", f, SOA)}
    with pytest.raises(RuntimeError, match="stop"):
        overlap.overlap_launch(collide_propagate_graph(TAU), ins,
                               decomposed=((1, "x", 1), (2, "y", 1)), config=cfg,
                               outputs=("dist2",), halo="overlap")
    monkeypatch.setattr(overlap, "_split_launch", real)
    ours = seen["plan"]
    jcfg = JTC("pallas", vvl=64, vmem_bytes=budget)
    theirs = jplan.default_plan(jcfg, nsites=math.prod(BLOCK), layouts=[J_SOA], stencil=True,
                                lattice=BLOCK, halo="pre")
    assert not ours.tiled and not (theirs.by or theirs.bz)
    interior, boundary = overlap.split_boxes(BLOCK, 1, (0, 1))
    for box in [interior] + boundary:
        lat = tuple(e - s for s, e in box)
        a = PP.sub_lattice_plan(ours, cfg, lat)
        b = joverlap._sub_plan(theirs, jcfg, lat)
        assert (a.bx, a.by, a.bz, a.halo) == (b.bx, b.by, b.bz, b.halo), (box, a, b)


def test_exchange_field_keeps_an_aosoa_halo_field_in_its_layout():
    """``core.halo.exchange_field`` on an AoSoA halo'd Field (the overlap
    launch's "pre" exchange): the Field comes back in aosoa(4), its
    canonical view the exchange of the canonical array, as the reference's
    block test exchanges its AoSoA shards."""
    from repro_torch.core import halo
    from repro_torch.launch.mesh import Mesh
    dist, _ = _globals()
    d = _block(dist, BLOCKS[0], BLOCK, 1)
    mesh = Mesh((1, 1), ("a", "b"), rank=0, world_size=1, local_rank=0, device="cpu")
    dec = ((1, "a", 1), (2, "b", 1))
    f = _port("dist", d, aosoa(4))
    got = halo.exchange_field(f, dec, width=1, mesh=mesh)
    want = halo.exchange(torch.from_numpy(d).clone(), dec, width=1, mesh=mesh)
    assert got.layout == aosoa(4) and torch.equal(got.canonical_nd(), want)

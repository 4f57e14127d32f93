"""K5HO's box tables on the CPU: the shell of the ring-1 t array, the T-slab
pairing, the kernels' block -> site map (``_table_sites``, a mirror of
``csrc/wilson_halo.cu``'s index arithmetic), the footprint behind the
sector bound, and the plain box-table schedule against the per-box plain
split, the port's "pre" plain launch and the JAX package's ``halo="overlap"``
split (its jnp engine).

Tolerances: the port's own schedules bitwise (every site's arithmetic is the
whole launch's); against the reference's split at rtol 1e-6 (atol 1e-6 x
the output's largest magnitude), as tests/test_torch_overlap.py holds it.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.apps.milc import cg as JCG  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core.stencil import halo_pad as jhalo_pad  # noqa: E402
from repro_torch._cuda import csrc_define  # noqa: E402
from repro_torch.core import overlap  # noqa: E402
from repro_torch.core.stencil import halo_pad  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as wk  # noqa: E402

KAPPA = 0.12
LATS = ((6, 7, 5, 6), (10, 10, 4, 4))
# every split of 1-4 decomposed dims that leaves an interior (ring 2: L >= 5)
SPLITS = [(lat, d) for lat in LATS for r in range(1, 5)
          for d in itertools.combinations(range(4), r) if all(lat[i] >= 5 for i in d)]
RTOL = ATOL = 1e-6


def _grow(lat, w):
    return tuple(s + 2 * w for s in lat)


def _oe(lat, dims):
    interior, boundary = overlap.split_boxes(lat, 2, dims)
    return [(tuple(a for a, _ in b), tuple(c - a for a, c in b)) for b in [interior] + boundary]


def _row_lanes(T):
    """The thread slots a row of T sites takes in a table launch
    (csrc's rt_row_lanes): T rounded up to a power of two up to
    RT_HROW_LANES_MAX, 0 (rows cut linearly) above."""
    return 0 if T > csrc_define("wilson_halo.cu", "RT_HROW_LANES_MAX") else \
        1 << (T - 1).bit_length()


def _table_sites(entries, block):
    """The kernels' block -> site map of a table launch (csrc's
    rt_htab_site over rt_horder_site): for each block of the grid (the
    boxes' grids in table order, each box's in the brick order over its
    thread slots, _row_lanes a row) and each of its ``block`` threads, the
    array coordinates (x, y, z, t) of its site or None."""
    out = []
    for o, e, ts, tg in entries:
        rx, ry, rz = (range(o[d], o[d] + e[d]) for d in range(3))
        rt = [o[3] + j + (tg if j >= ts else 0) for j in range(e[3])]
        g = _row_lanes(e[3])
        P = e[1] * e[2] * (g or e[3])
        nq = -(-P // block)
        for i in range(nq * e[0]):
            per = wk.BRICK_X * nq
            brick = i // per
            x0 = wk.BRICK_X * brick
            w = min(wk.BRICK_X, e[0] - x0)
            r = i - per * brick
            row = []
            for th in range(block):
                q = (r // w) * block + th
                if q >= P or (g and q % g >= e[3]):
                    row.append(None)
                    continue
                if g:
                    q = (q // g) * e[3] + q % g
                tj, rest = q % e[3], q // e[3]
                row.append((rx[x0 + r % w], ry[rest // e[2]], rz[rest % e[2]], rt[tj]))
            out.append(row)
    return out


def _cover(shape, boxes):
    n = np.zeros(shape, dtype=np.int32)
    for o, e in boxes:
        n[tuple(slice(a, a + b) for a, b in zip(o, e))] += 1
    return n


@pytest.mark.parametrize("lat,dims", SPLITS, ids=str)
def test_shell_is_a_disjoint_cover_of_the_ring_less_the_grown_interior(lat, dims):
    """The shell's boxes and the interior's grown box cover the ring-1 array
    once each site, in split_boxes' order (two slabs a decomposed dim, of
    the ring's width), at most 8 boxes."""
    oe = _oe(lat, dims)
    (o, e) = oe[0]
    shell = wk.shell_boxes(lat, o, e)
    assert len(shell) == 2 * len(dims) <= 8
    assert (_cover(_grow(lat, 1), shell + [(o, _grow(e, 1))]) == 1).all()
    for k, d in enumerate(dims):
        lo, hi = shell[2 * k], shell[2 * k + 1]
        assert (lo[0][d], lo[1][d], hi[0][d], hi[1][d]) == (0, 2, lat[d], 2)


@pytest.mark.parametrize("dims", [(0, 1, 2, 3), (3,), (1, 3), (0, 2)], ids=str)
@pytest.mark.parametrize("block", [32, 64, 128])
def test_table_block_map_covers_every_site_once(dims, block):
    """The kernels' block -> site map over the interior's tables and the
    boundary's paired tables: every site of the boxes once, and nothing
    else."""
    lat = LATS[0]
    oe = _oe(lat, dims)
    o, e = oe[0]
    shell = wk.shell_boxes(lat, o, e)
    tabs = wk.split_tables(lat, oe[0], oe[1:])
    assert list(tabs) == ["interior t", "interior ap", "shell t", "boundary ap"]
    for shape, boxes, parts in (
            (_grow(lat, 1), [(o, _grow(e, 1))] + shell, ("interior t", "shell t")),
            (lat, oe, ("interior ap", "boundary ap"))):
        seen = np.zeros(shape, dtype=np.int32)
        for part in parts:
            for row in _table_sites(tabs[part][1], block):
                for c in row:
                    if c is not None:
                        seen[c] += 1
        assert (seen == _cover(shape, boxes)).all() and (seen == 1).all()


def test_pairing_takes_the_two_t_slabs_as_one_box():
    lat = (6, 7, 5, 6)
    oe = _oe(lat, (0, 1, 2, 3))
    ents = wk.pair_t_slabs(oe[1:])
    assert len(ents) == 7 and ents[:6] == wk.table_entries(oe[1:7])
    o, e, ts, tg = ents[6]
    assert (o, e[:3], e[3], ts, tg) == (oe[7][0], oe[7][1][:3], 4, 2, 2)
    assert wk.pair_t_slabs(oe[1:3]) == wk.table_entries(oe[1:3])   # x-slabs stay apart
    assert wk.HTAB_MAX == csrc_define("wilson_halo.cu", "RT_HTAB_MAX")
    with pytest.raises(ValueError, match="1 to 8 boxes"):
        wk._table(wk.table_entries(oe))


def _footprint_brute(lat, kind, ents):
    """(bytes, sectors) by enumerating every value read and written."""
    et, ep = _grow(lat, 1), _grow(lat, 2)
    # (computed array, its source and the source's offset, u's offset)
    out_shape, src_shape, src_off, u_off = (et, ep, 1, 1) if kind == "t" else (lat, et, 1, 2)
    arr = {}

    def touch(name, shape, comps, site):
        V = int(np.prod(shape))
        for k in comps:
            arr.setdefault(name, set()).add(k * V + int(np.ravel_multi_index(site, shape)))

    for o, e, ts, tg in ents:
        for c in itertools.product(*[range(a, a + b) for a, b in zip(o[:3], e[:3])],
                                   [o[3] + j + (tg if j >= ts else 0) for j in range(e[3])]):
            touch("out", out_shape, range(24), c)
            s = tuple(v + src_off for v in c)
            touch("src", src_shape, range(24), s)
            us = tuple(v + u_off for v in c)
            touch("u", ep, range(72), us)
            for mu in range(4):
                for sg in (1, -1):
                    touch("src", src_shape, range(24),
                          tuple(v + (sg if d == mu else 0) for d, v in enumerate(s)))
                touch("u", ep, range(18 * mu, 18 * mu + 18),
                      tuple(v - (1 if d == mu else 0) for d, v in enumerate(us)))
    nbytes = 4 * sum(len(v) for v in arr.values())
    sectors = sum(len({i // 8 for i in v}) for v in arr.values())
    return nbytes, sectors


@pytest.mark.parametrize("kind", ["t", "ap"])
def test_table_footprint_counts_every_value_and_sector(kind):
    """table_footprint's bytes and 32-byte sectors equal a brute-force count
    of the values a paired table launch reads and writes."""
    lat = (5, 3, 2, 6)
    oe = _oe(lat, (0, 3))
    if kind == "t":
        o, e = oe[0]
        ents = wk.pair_t_slabs(wk.shell_boxes(lat, o, e))
    else:
        ents = wk.pair_t_slabs(oe[1:])
    assert wk.table_footprint(lat, kind, ents) == _footprint_brute(lat, kind, ents)


def _inputs(lat, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(24, *lat)).astype(np.float32)
    u = rng.normal(size=(72, *lat)).astype(np.float32)
    sd = (1, 2, 3, 4)
    ph = halo_pad(torch.from_numpy(p), 2, sd)
    uh = halo_pad(torch.from_numpy(u), 2, sd)
    jph, juh = jhalo_pad(jnp.asarray(p), 2, sd), jhalo_pad(jnp.asarray(u), 2, sd)
    return ph.reshape(24, -1), uh.reshape(72, -1), jph, juh


@pytest.mark.parametrize("lat,dims", [(LATS[0], (0, 1, 2, 3)), (LATS[0], (3,)),
                                      (LATS[0], (0, 2)), (LATS[0], (1, 2, 3)),
                                      (LATS[1], (0, 1)), (LATS[1], (1,))], ids=str)
def test_box_table_schedule_plain_bitwise_and_against_the_reference(lat, dims):
    """The plain box-table schedule (t once into one ring-1 array, then ap on
    the boxes): bitwise the per-box plain split and the "pre" plain launch,
    the CPU wrappers (interior, then boundary) bitwise both, and within
    rtol 1e-6 of the JAX package's halo="overlap" split on its jnp engine
    (every dim split, its default)."""
    ph, uh, jph, juh = _inputs(lat, 3)
    oe = _oe(lat, dims)
    got = wk.wilson_normal_split_plain(ph, uh, KAPPA, lat, oe[0], oe[1:])
    pre = wk.wilson_normal_pre_plain(ph, uh, KAPPA, lat)
    assert torch.equal(got, pre)
    per_box = torch.full_like(pre, float("nan")).reshape((24,) + lat)
    for o, e in oe:
        per_box[(slice(None),) + tuple(slice(a, a + b) for a, b in zip(o, e))] = \
            wk.wilson_normal_box_plain(ph, uh, KAPPA, lat, o, e).reshape((24,) + e)
    assert torch.equal(got, per_box.reshape(24, -1))
    t = torch.full((24, int(np.prod(_grow(lat, 1)))), float("nan"))
    ap = torch.full_like(pre, float("nan"))
    wk.wilson_normal_interior_cuda(ph, uh, KAPPA, lat, oe[0], t, ap)
    wk.wilson_normal_boundary_cuda(ph, uh, KAPPA, lat, oe[0], oe[1:], t, ap)
    assert torch.equal(ap, pre) and not t.isnan().any()
    hl = _grow(lat, 2)
    jg = JCG.wilson_normal_graph(KAPPA)
    ref = jg.launch({"p": JField.from_canonical("p", jph, hl),
                     "u": JField.from_canonical("u", juh, hl)},
                    config=JTC("jnp"), outputs=("ap",), halo="overlap")["ap"]
    want = np.asarray(ref.canonical())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL * np.abs(want).max())

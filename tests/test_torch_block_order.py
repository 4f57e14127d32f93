"""The kernels' walks over the lattice, mirrored in Python, on the CPU.

K5's block order (``csrc/wilson_normal.cuh::rt_order_chunk``, mirrored by
``kernels/wilson_dslash/kernel.py::block_chunks``): the card runs each block
on one chunk of vvl consecutive sites and writes its partial row at the
chunk's index, so the order is right when it is a bijection from the linear
block indices onto the (slot, chunk) pairs; the card tests hold the kernels'
fields and sums to the plain version and each slot bitwise to its one-slot
launch.

K4 (``csrc/dslash.cu``) runs its chunks in the same order in every layout
(``block_chunks`` with one slot): every site computed exactly once, and
every neighbour a site reads computed by a block at most a brick's reuse
distance away.  K5L's staged loads and its push (``csrc/lb.cu``,
mirrored by ``lb_stage_copy``, ``lb_stage_read`` and ``lb_push_sites``):
each site's values read from the staged offset that holds them, and every
(destination, velocity) written exactly once.  K7's out stage (the same
maps, run backwards): every output of a chunk stored exactly once.  K8's
staged tiles (``k8_row_segment``, ``k8_stage_reads``, ``k8_tiled_emulate``):
each velocity read from the staged record of its source on the periodic
lattice, and the emulated kernel bitwise the plain version."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import parse_layout  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as K8  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as K  # noqa: E402

# the records' lattices (milc_small, the smoke's --small, the reuse-distance
# timing), the card tests' (4, 4, 6, 8), and X that is not a multiple of the
# brick (20, 17, 3)
LATTICES = [(64, 64, 64, 32), (16, 16, 16, 16), (256, 32, 32, 32), (4, 4, 6, 8),
            (20, 4, 4, 8), (17, 8, 8, 8), (3, 4, 4, 8)]


def _pairs(lattice, vvl, batch, slots=K.NORMAL_SLOTS):
    group, chunk = K.block_chunks(lattice, vvl, batch, slots=slots)
    return group, chunk, -(-math.prod(lattice) // vvl)


@pytest.mark.parametrize("slots", sorted({K.NORMAL_SLOTS, K.NORMAL_SLOTS_POLICY}))
@pytest.mark.parametrize("batch", [1, 4, 5, 9])
@pytest.mark.parametrize("vvl", [32, 128])
@pytest.mark.parametrize("lattice", LATTICES, ids=lambda t: "x".join(map(str, t)))
def test_block_order_is_a_bijection_onto_the_chunks(lattice, vvl, batch, slots):
    """Every (slot group, chunk) pair exactly once, the group the fastest
    index: ceil(batch / slots) groups of a batched launch (slots a thread:
    K5B's and its policy instance's), one of a single slot."""
    group, chunk, nchunks = _pairs(lattice, vvl, batch, slots)
    groups = -(-batch // slots)
    assert group.shape == chunk.shape == (nchunks * groups,)
    assert bool((group == torch.arange(nchunks * groups) % groups).all())
    assert bool((chunk >= 0).all()) and bool((chunk < nchunks).all())
    assert torch.unique(chunk * groups + group).numel() == nchunks * groups
    # a chunk's groups are consecutive blocks
    assert bool((chunk.view(-1, groups) == chunk.view(-1, groups)[:, :1]).all())


def test_brick_order_neighbours():
    """At (64, 64, 64, 32), vvl 128: x runs fastest inside a brick of
    BRICK_X x-planes (the x-neighbour's chunk one block away), the chunks of
    an x-plane next (a z-neighbour BRICK_X blocks away, a y-neighbour
    BRICK_X x 16 = 256), then the next brick."""
    lat, vvl = (64, 64, 64, 32), 128
    _, chunk, _ = _pairs(lat, vvl, 1)
    nq = 64 * 64 * 32 // vvl
    x, q = chunk // nq, chunk % nq
    bx = K.BRICK_X
    assert bx == 16
    assert x[:bx].tolist() == list(range(bx)) and bool((q[:bx] == 0).all())
    assert x[bx:2 * bx].tolist() == list(range(bx)) and bool((q[bx:2 * bx] == 1).all())
    pos = torch.empty_like(chunk)
    pos[chunk] = torch.arange(chunk.numel())
    # y-neighbour: chunk q + Z T / vvl = q + 16 of the same x
    assert int(pos[16]) - int(pos[0]) == bx * 16
    # the second brick starts after the first's 16 x nq blocks
    assert int(x[bx * nq]) == bx and int(q[bx * nq]) == 0


def test_block_order_thin_last_brick():
    """X = 20 at vvl 128 over (4, 4, 8): one chunk an x-plane, bricks of 16
    and 4 x-planes, x fastest in each."""
    _, chunk, _ = _pairs((20, 4, 4, 8), 128, 1)
    assert chunk.tolist() == list(range(20))
    _, chunk, _ = _pairs((20, 4, 4, 8), 32, 1)    # 4 chunks an x-plane
    nq = 4
    assert (chunk[:16] // nq).tolist() == list(range(16)) and bool((chunk[:16] % nq == 0).all())
    last = chunk[16 * nq:]
    assert (last[:4] // nq).tolist() == [16, 17, 18, 19] and bool((last[:4] % nq == 0).all())


def test_linear_order_where_vvl_does_not_divide_a_plane():
    """Y Z T = 96 sites at vvl 64: the chunks run in linear order, the last
    one partial; in AoS always."""
    groups = 3
    group, chunk, nchunks = _pairs((5, 4, 4, 6), 64, groups * K.NORMAL_SLOTS)
    assert nchunks == 8
    assert chunk.tolist() == [c for c in range(8) for _ in range(groups)]
    assert group.tolist() == list(range(groups)) * 8
    group, chunk = K.block_chunks((20, 4, 4, 8), 32, 2 * K.NORMAL_SLOTS, aos=True)
    assert chunk.tolist() == [c for c in range(80) for _ in range(2)]
    assert group.tolist() == [0, 1] * 80


# -- K4's block order ----------------------------------------------------------------

# milc_small, a T < 32 lattice past a brick in x (20, 2, 4, 4), thin bricks
# (6, 10, 4, 12), (2, 4, 4, 8), and (8, 8, 8, 8)
K4_LATTICES = [(64, 64, 64, 32), (8, 8, 8, 8), (6, 10, 4, 12), (20, 2, 4, 4), (2, 4, 4, 8)]


def _coords(lattice, site):
    X, Y, Z, T = lattice
    return site // (Y * Z * T), (site // (Z * T)) % Y, (site // T) % Z, site % T


def _site(lattice, x, y, z, t):
    X, Y, Z, T = lattice
    return ((x % X * Y + y % Y) * Z + z % Z) * T + t % T


@pytest.mark.parametrize("vvl", [32, 96, 128])
@pytest.mark.parametrize("lattice", K4_LATTICES, ids=lambda t: "x".join(map(str, t)))
def test_dslash_blocks_compute_every_site_once(lattice, vvl):
    """K4's blocks (one slot, the brick order where vvl divides Y Z T, else
    linear) compute each site of the lattice exactly once: block i's
    threads take sites chunk(i) vvl + l, those past V idle."""
    V = math.prod(lattice)
    _, chunk = K.block_chunks(lattice, vvl)
    sites = (chunk[:, None] * vvl + torch.arange(vvl)).reshape(-1)
    sites = sites[sites < V]
    assert sites.numel() == V
    assert torch.equal(torch.sort(sites).values, torch.arange(V))


def test_dslash_neighbours_within_the_reuse_distance():
    """At (64, 64, 64, 32), vvl 128: every neighbour a site reads is
    computed by a block at most BRICK_X x Z T / vvl = 256 blocks away (~16
    MB of K4's 480 compulsory bytes a site, within the 50 MB L2), except an
    x-neighbour across a brick's face (2 of BRICK_X x-planes) and a
    y-neighbour across the periodic wrap (2 of Y y-rows)."""
    lat, vvl = (64, 64, 64, 32), 128
    V = math.prod(lat)
    _, chunk = K.block_chunks(lat, vvl)
    pos = torch.empty_like(chunk)
    pos[chunk] = torch.arange(chunk.numel())        # block position of each chunk
    site = torch.arange(V)
    x, y, z, t = _coords(lat, site)
    far = {}
    for mu in range(4):
        for sgn in (1, -1):
            step = [0, 0, 0, 0]
            step[mu] = sgn
            n = _site(lat, x + step[0], y + step[1], z + step[2], t + step[3])
            dist = (pos[n // vvl] - pos[site // vvl]).abs()
            far[mu] = far.get(mu, 0) + int((dist > 256).sum())
    assert 256 * vvl * 480 < 50e6
    assert far == {0: 2 * V // K.BRICK_X, 1: 2 * V // lat[1], 2: 0, 3: 0}


# -- K5L's staged loads and its push --------------------------------------------------

STAGE_LAYOUTS = ["soa", "aos", "aosoa4", "aosoa16"]


@pytest.mark.parametrize("lattice", [(256, 256, 256), (8, 8, 8)], ids=["256", "8"])
@pytest.mark.parametrize("vvl", [32, 64, 128, 256])
@pytest.mark.parametrize("spec", STAGE_LAYOUTS)
def test_lb_stage_reads_each_sites_values(lattice, vvl, spec):
    """A chunk's staged copy (its float4s from the device offsets
    lb_stage_copy gives) holds, at the offset a thread reads (lb_stage_read),
    INDEX(c, s0 + l) of the layout for every component of dist (19) and
    force (3): every chunk at (8, 8, 8), the first, a middle and the last
    full one at (256, 256, 256)."""
    lay = parse_layout(spec)
    V = math.prod(lattice)
    assert K8.lb_step_stages(V, vvl, lay)
    full = V // vvl
    chunks = range(full) if V <= 4096 else (0, full // 2 + 3, full - 1)
    for ncomp in (19, 3):
        read = K8.lb_stage_read(lay, ncomp, vvl)
        c = torch.arange(ncomp)[:, None]
        for q in chunks:
            s0 = q * vvl
            staged = K8.lb_stage_copy(lay, ncomp, vvl, s0, V)
            assert bool((staged.view(-1, 4)[:, 0] % 4 == 0).all())   # 16-byte aligned float4s
            assert torch.equal(staged.view(-1, 4) - staged.view(-1, 4)[:, :1],
                               torch.arange(4).expand(ncomp * vvl // 4, 4))
            want = lay.flat_index(c, s0 + torch.arange(vvl)[None, :], ncomp, V)
            assert torch.equal(staged[read], want), (ncomp, q)


@pytest.mark.parametrize("lattice", [(256, 256, 256), (8, 8, 8), (3, 5, 7)],
                         ids=["256", "8", "3x5x7"])
def test_lb_push_writes_every_destination_once(lattice):
    """K5L's push: for each velocity the V destinations s + c_i of all
    sites cover every site (so each once), so every (destination, velocity)
    of dist2 is written exactly once."""
    V = math.prod(lattice)
    block = 1 << 20
    seen = torch.zeros((19, V), dtype=torch.bool)
    for s0 in range(0, V, block):
        dst = K8.lb_push_sites(lattice, torch.arange(s0, min(V, s0 + block)))
        seen.scatter_(1, dst, True)
    assert bool(seen.all())


# -- K7's out stage and K8's staged tiles ---------------------------------------------

@pytest.mark.parametrize("vvl", [32, 64, 128, 256])
@pytest.mark.parametrize("spec", STAGE_LAYOUTS)
def test_k7_out_stage_writes_each_output_once(spec, vvl):
    """K7's staged chunk writes its outputs back through the stage: thread
    l puts component c at the staged offset lb_stage_read gives, and the
    block stores staged float4 e at lb_stage_copy's device offsets.  Every
    (c, s) of a chunk reaches INDEX(c, s) exactly once, at (8, 8, 8) and
    at the first, a middle and the last chunk of (256, 256, 256)."""
    lay = parse_layout(spec)
    for lattice in ((8, 8, 8), (256, 256, 256)):
        V = math.prod(lattice)
        full = V // vvl
        read = K8.lb_stage_read(lay, 19, vvl)
        assert torch.equal(torch.sort(read.reshape(-1)).values, torch.arange(19 * vvl))
        for q in range(full) if V <= 4096 else (0, full // 2 + 1, full - 1):
            s0 = q * vvl
            dev = K8.lb_stage_copy(lay, 19, vvl, s0, V)[read]
            want = lay.flat_index(torch.arange(19)[:, None], s0 + torch.arange(vvl)[None, :],
                                  19, V)
            assert torch.equal(dev, want), q


# lattices K8 stages: extents 1, 2, 3 on x (its wrap onto itself), a last
# x-slab that is partial (X not a multiple of K8_XS), several z-tiles, and
# the wrap along every axis
K8_TILE_LATTICES = [(1, 4, 32), (2, 8, 32), (3, 4, 64), (K8.K8_XS + 2, 8, 64), (5, 12, 96)]
K8_TILE_LAYOUTS = ["aos"] + [f"aosoa{n}" for n in (2, 4, 8, 16, 32) if n <= K8.K8_MAX_SAL]


@pytest.mark.parametrize("spec", K8_TILE_LAYOUTS)
@pytest.mark.parametrize("lattice", K8_TILE_LATTICES, ids=lambda t: "x".join(map(str, t)))
def test_k8_tiles_emulate_propagate(lattice, spec):
    """K8's staged tiles run in Python (k8_tiled_emulate: the kernel's row
    segments, stage, reads, out stage and stores, every output written
    exactly once) equal propagate_plain bitwise; unstaged floats of the
    stage are NaN, so a read outside the staged runs would show."""
    lay = parse_layout(spec)
    V = math.prod(lattice)
    assert K8.k8_tiles(lattice, lay)
    d = lay.pack(torch.randn((19, V), generator=torch.Generator().manual_seed(V)))
    got = K8.k8_tiled_emulate(d.reshape(-1), lattice, lay)
    assert torch.equal(got, K8.propagate_plain(d, lattice, {"dist": lay}).reshape(-1))


@pytest.mark.parametrize("spec", K8_TILE_LAYOUTS)
@pytest.mark.parametrize("lattice", K8_TILE_LATTICES[:3], ids=lambda t: "x".join(map(str, t)))
def test_k8_stage_reads_hold_each_source(lattice, spec):
    """Each (velocity i, site s) of a tile step reads, at the stage offset
    k8_stage_reads gives, the float that the plane's row copies
    (k8_row_copies: a 16-byte aligned run of the tile's W records and the
    edge values) put there from INDEX(i, s - c_i) on the periodic lattice:
    the stage covers every source, the wrap along every axis included."""
    lay = parse_layout(spec)
    X, Y, Z = lattice
    V = X * Y * Z
    R, run = K8.K8_TY + 2, K8.K8_W * 19
    cv = torch.from_numpy(K8.d3q19.CV.astype("int64"))
    t = torch.arange(K8.K8_TY * K8.K8_W)
    for b in range((Z // K8.K8_W) * (Y // K8.K8_TY) * -(-X // K8.K8_XS)):
        x0, y0, z0, xs = K8.k8_block_tile(lattice, b)
        # the device float behind each stage offset of the planes of step j
        held = torch.full((K8.K8_SLOTS * R * K8.K8_ROW,), -1, dtype=torch.int64)
        for j in range(xs):
            for pi in range(j, j + 3):
                for q in range(R):
                    lo, edges = K8.k8_row_copies(lattice, lay, x0, y0, z0, pi, q)
                    assert lo % 4 == 0 and len(edges) == 2 * K8.K8_EDGE
                    at = ((pi % K8.K8_SLOTS) * R + q) * K8.K8_ROW
                    held[at:at + K8.K8_ROW] = -1
                    held[at:at + run] = torch.arange(lo, lo + run)
                    held[at + run:at + run + len(edges)] = torch.tensor(edges)
            off = K8.k8_stage_reads(lay, j)
            x, y, z = x0 + j, y0 + t // K8.K8_W, z0 + t % K8.K8_W
            for i in range(19):
                src = (((x - cv[i, 0]) % X * Y + (y - cv[i, 1]) % Y) * Z + (z - cv[i, 2]) % Z)
                assert torch.equal(held[off[i]], lay.flat_index(i, src, 19, V)), (b, j, i)


@pytest.mark.parametrize("lattice,spec", [
    ((4, 4, 32), "soa"), ((4, 4, 32), f"aosoa{2 * K8.K8_MAX_SAL}"), ((4, 4, 40), "aos"),
    ((4, 6, 32), "aos"), ((4, 4, 36), "aosoa4"), ((2, 1, 3), "aos")])
def test_k8_tiles_refused(lattice, spec):
    """SoA and SALs above K8_MAX_SAL, Z not a multiple of K8_W and Y not
    of K8_TY take K8's site-by-site path."""
    assert not K8.k8_tiles(lattice, parse_layout(spec))

"""K5's block order (``csrc/wilson_normal.cuh::rt_order_chunk``, mirrored by
``kernels/wilson_dslash/kernel.py::block_chunks``), on the CPU.

The card runs each block on one chunk of vvl consecutive sites and writes
its partial row at the chunk's index, so the order is right when it is a
bijection from the linear block indices onto the (slot, chunk) pairs; the
card tests hold the kernels' fields and sums to the plain version and each
slot bitwise to its one-slot launch."""

import math

import pytest

torch = pytest.importorskip("torch")

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

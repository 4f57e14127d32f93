"""CUDA wrappers for D3Q19 streaming: K8 (propagation) and K5L (the fused
LB step), both in ``csrc/lb.cu``, and K9 (the tiled LB step,
``csrc/lb_tiled.cu``), each beside its plain PyTorch version.

K8 replaces ``kernels/lb_propagation/kernel.py::propagate_pallas`` of the
JAX package: a pull gather ``out_i(r) = f_i(r - c_i)`` with the periodic
wrap inside the kernel, so the halo'd copy the TPU path stages is never
built.  It moves data only and equals its plain version bitwise.  In SoA
(and AoSoA with a SAL above K8_MAX_SAL) a thread takes a site and every
velocity's loads coalesce.  In AoS and small-SAL AoSoA a block stages the
rows of source records a tile of K8_TY x K8_W sites pulls from, walks
K8_XS x-planes with the next plane's copy in flight, and stores whole
records through an out stage (:func:`k8_tiles`, :func:`k8_row_copies`,
:func:`k8_stage_reads`, :func:`k8_tiled_emulate` mirror it); any other
launch goes site by site.

K8, K5L and K9 take every layout (SoA, AoS, AoSoA): each tensor comes with
its layout, the kernels address it through INDEX, and the wrappers take
physical tensors and ``layouts`` (names as in each signature; an input not
named is SoA, an output takes the first input's layout).

K5L replaces ``core/fuse.py::LaunchGraph._build_nd`` for the
``ludwig_lb_step`` graph (moments, collision, streaming -> dist2 and u) and,
without u, for ``lb_collide_propagate``.  It streams by push: each site's
thread collides in registers and writes its post-collision values to the
neighbours, so the post-collision distributions never reach device memory.

K5L's blocks each take a chunk of vvl consecutive sites.  Where every
tensor shares one layout, the chunk's dist and force lie in contiguous runs
(in AoSoA where the SAL divides vvl), which the block moves into shared
memory as 16-byte vectors before each thread reads its site's 22 values
there (:func:`lb_step_stages`, :func:`lb_stage_copy`, :func:`lb_stage_read`
mirror it); every other launch loads site by site.  Offsets are 32-bit where
19 V < 2^31.  The stores are the push, from registers (:func:`lb_push_sites`).

K5L's policy instance (``bf16=True``, ``rt_lb_step_bf16``) is the same
kernel under a bf16-storage DtypePolicy: dist and force rounded to bf16 as
they are loaded, moments, collision and streaming in fp32, dist2 and u
written in bf16.

K9 replaces the same function's ``dma_kernel`` for both graphs under a
tiled plan: it walks the sites tile by tile in the reference's grid order
(:func:`tiled_walk`), collides each once and streams it by push, as K5L
does, so no halo'd window is copied or collided; each thread loads its
site's values straight into registers through INDEX, with no shared
memory.  Its plain version is ``core.fuse.tiled_plain`` on the collide ->
propagate graph, and its fields equal K5L's bitwise in every layout.  Its
policy instance (``bf16=True``, ``rt_lb_step_tiled_bf16``) rounds dist and
force to bf16 as they are loaded and writes dist2 and u in bf16, bitwise
K5L's policy instance.

K8H (:func:`propagate_halo_cuda`, ``csrc/lb_halo.cu``) is K8 on a
pre-exchanged halo of any width: a pull from the halo'd array at its own
strides, bitwise its plain version.  K5LH (:func:`lb_step_pre_cuda`) is
the ``ludwig_lb_step`` graph under ``halo="pre"``: dist2 and u on the
interior from dist and force padded by 1, the ring's sites collided too
(the push from every site of the halo'd box keeps what lands inside).
K5LHO (:func:`lb_step_box_cuda`) is K5LH on one box of the interior, the
sub-launch of the ``halo="overlap"`` split: the box grown by 1 collides
(each box its own ring) and pushes into the box, read in place from the
whole halo'd dist and force and written into the box's sites of the
whole-interior dist2 and u, each bitwise the whole launch's.  Both are
the untiled SoA instances of K9H (``rt_lb_step_halo``): the same kernel
under a tile (the box's sites in K9's tile order, then its ring:
:func:`tiled_walk` with ``ring=1``) and in any layout (every value through
INDEX, AoSoA read and written in place), which :func:`lb_step_pre_cuda` and
:func:`lb_step_box_cuda` launch under a tiled plan or off SoA; with
``with_u=False`` (no u) they run ``lb_collide_propagate``.  All take fp32
fields.

On a CPU tensor each wrapper returns its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch._cuda import Kernel, check_field, check_tensor, csrc_define
from repro_torch.core.fuse import tiled_plain
from repro_torch.core.layout import Layout, LayoutKind, resolve_layouts
from repro_torch.core.plan import tile_extents
from repro_torch.core.stencil import box_slices, shell_order, tile_boxes
from repro_torch.maths import d3q19
from repro_torch.kernels.lb_collision.kernel import collide_plain, lb_params
from repro_torch.kernels.lb_collision.ref import moments
from . import ref

__all__ = ["propagate_cuda", "propagate_plain", "lb_step_cuda", "lb_step_plain",
           "lb_step_stages", "lb_stage_copy", "lb_stage_read", "lb_push_sites", "LB_MAX_VVL",
           "k8_tiles", "k8_block_tile", "k8_row_copies", "k8_stage_reads", "k8_tiled_emulate",
           "lb_step_tiled_cuda", "lb_step_tiled_plain", "tiled_walk", "PROPAGATE", "LB_STEP",
           "LB_STEP_BF16", "LB_STEP_TILED", "LB_STEP_TILED_BF16", "propagate_halo_cuda",
           "propagate_halo_plain", "lb_step_pre_cuda", "lb_step_pre_plain", "PROPAGATE_HALO",
           "LB_STEP_PRE", "lb_step_box_cuda", "lb_step_box_plain", "LB_STEP_BOX",
           "LB_STEP_HALO"]

PROPAGATE = Kernel("lb_propagate", "rt_lb_propagate")
LB_STEP = Kernel("lb_step", "rt_lb_step")
LB_STEP_BF16 = Kernel("lb_step_bf16", "rt_lb_step_bf16")   # K5L's policy instance
# K8H and K5LH, on pre-exchanged halos (csrc/lb_halo.cu)
PROPAGATE_HALO = Kernel("lb_propagate_halo", "rt_lb_propagate_halo")
LB_STEP_PRE = Kernel("lb_step_pre", "rt_lb_step_pre")
# K5LHO, K5LH on one box of the interior (the halo="overlap" sub-launches)
LB_STEP_BOX = Kernel("lb_step_box", "rt_lb_step_box")
# K9H: the template whose untiled SoA instances K5LH and K5LHO are, under a
# tile or off SoA
LB_STEP_HALO = Kernel("lb_step_halo", "rt_lb_step_halo")
LB_STEP_TILED = Kernel("lb_step_tiled", "rt_lb_step_tiled")
LB_STEP_TILED_BF16 = Kernel("lb_step_tiled_bf16", "rt_lb_step_tiled_bf16")   # K9's policy instance
K9_BLOCK = 256   # threads a K9 block (at most RT_K9_MAX_THREADS in lb_tiled.cu)


# K5L's and K7's staged chunks: the most sites a chunk (lb.cu)
LB_MAX_VVL = csrc_define("lb.cu", "RT_LB_MAX_VVL")


def lb_step_stages(nsites: int, vvl: int, layout: Layout) -> bool:
    """Whether K5L stages the loads (and K7 its loads and stores) of a
    launch over ``nsites`` sites in chunks of ``vvl`` with every tensor in
    ``layout`` (``rt_lb_stages`` of ``csrc/lb.cu``, the fields' alignment
    aside)."""
    if vvl % 4 or vvl > LB_MAX_VVL or 19 * nsites >= 2 ** 31:
        return False
    if layout.kind is LayoutKind.SOA:
        return nsites % 4 == 0
    if layout.kind is LayoutKind.AOSOA:
        return vvl % layout.sal == 0 and layout.sal & (layout.sal - 1) == 0
    return True


def lb_stage_copy(layout: Layout, ncomp: int, vvl: int, s0: int, nsites: int) -> torch.Tensor:
    """The device offset of each of the ncomp vvl values K5L stages for the
    chunk starting at site s0, in their staged order (``rt_lb_vec_at``:
    float4 e holds staged values [4 e, 4 e + 4)): in SoA, component c's run
    of vvl floats, c = e / (vvl / 4); else the chunk's one run."""
    j = torch.arange(ncomp * vvl, dtype=torch.int64)
    if layout.kind is LayoutKind.SOA:
        c = (j // 4) // (vvl // 4)
        return c * nsites + s0 + (j - c * vvl)
    return ncomp * s0 + j


def lb_stage_read(layout: Layout, ncomp: int, vvl: int) -> torch.Tensor:
    """The staged offset (ncomp, vvl) from which the thread of chunk site l
    reads component c: INDEX(c, l) of the layout over vvl sites."""
    c = torch.arange(ncomp, dtype=torch.int64)[:, None]
    return layout.flat_index(c, torch.arange(vvl, dtype=torch.int64)[None, :], ncomp, vvl)


def lb_push_sites(lattice, sites: torch.Tensor) -> torch.Tensor:
    """The destination of each velocity pushed from each of ``sites``:
    (19, n) sites s + c_i on the periodic lattice (K5L's stores)."""
    X, Y, Z = _check_3d(lattice)
    cv = torch.from_numpy(d3q19.CV.astype("int64"))
    z, y, x = sites % Z, (sites // Z) % Y, sites // (Y * Z)
    return ((((x[None] + cv[:, :1]) % X) * Y + (y[None] + cv[:, 1:2]) % Y) * Z
            + (z[None] + cv[:, 2:]) % Z)


# K8's staged tiles (lb.cu): TY y-rows x W z-sites a tile, XS x-planes a block
K8_TY = csrc_define("lb.cu", "RT_K8_TY")
K8_W = csrc_define("lb.cu", "RT_K8_W")
K8_XS = csrc_define("lb.cu", "RT_K8_XS")
K8_MAX_SAL = csrc_define("lb.cu", "RT_K8_MAX_SAL")
K8_SLOTS = csrc_define("lb.cu", "RT_K8_SLOTS")   # plane slots of a block's ring
K8_EDGE = csrc_define("lb.cu", "RT_K8_EDGE")
K8_ROW = (K8_W * 19 + 2 * K8_EDGE + 3) & ~3   # floats of a staged row (RT_K8_ROW)
K8_EDGE_VELOCITIES = (5, 11, 13, 15, 17)      # c_z = +1; each one more has c_z = -1


def k8_tiles(lattice, layout: Layout) -> bool:
    """Whether K8 runs a launch with dist and out in ``layout`` on staged
    tiles (``rt_k8_tiles`` of ``csrc/lb.cu``, the fields' alignment aside):
    AoS, or AoSoA with a power-of-two SAL of at most K8_MAX_SAL; Z a
    multiple of K8_W, Y of K8_TY; 19 V < 2^31."""
    X, Y, Z = _check_3d(lattice)
    if layout.kind is LayoutKind.AOSOA:
        if layout.sal > min(K8_MAX_SAL, K8_W) or layout.sal & (layout.sal - 1):
            return False
    elif layout.kind is not LayoutKind.AOS:
        return False
    return Z % K8_W == 0 and Y % K8_TY == 0 and 19 * X * Y * Z < 2 ** 31


def k8_block_tile(lattice, block: int) -> Tuple[int, int, int, int]:
    """(x0, y0, z0, xs): the tile of K8 block ``block`` and the x-planes it
    walks."""
    X, Y, Z = lattice
    ntz, nty = Z // K8_W, Y // K8_TY
    z0 = block % ntz * K8_W
    y0 = block // ntz % nty * K8_TY
    x0 = block // (ntz * nty) * K8_XS
    return x0, y0, z0, min(K8_XS, X - x0)


def k8_row_copies(lattice, layout: Layout, x0: int, y0: int, z0: int, pi: int, q: int):
    """(run, edges) of staged row q of plane pi (x = x0 - 1 + pi, y = y0 -
    1 + q, both periodic): ``run``, the device float where the row's W
    records z0 .. z0 + W - 1 start (W 19 floats, one 16-byte aligned run,
    copied to the row's floats [0, 19 W)); ``edges``, the device offsets of
    the 2 K8_EDGE values copied after it: the c_z = +1 velocities of record
    z0 - 1, then the c_z = -1 ones of record z0 + W (periodic)."""
    X, Y, Z = lattice
    V = X * Y * Z
    rs = ((x0 - 1 + pi) % X * Y + (y0 - 1 + q) % Y) * Z
    left = [layout.flat_index(i, rs + (z0 - 1) % Z, 19, V) for i in K8_EDGE_VELOCITIES]
    right = [layout.flat_index(i + 1, rs + (z0 + K8_W) % Z, 19, V) for i in K8_EDGE_VELOCITIES]
    return (rs + z0) * 19, left + right


def k8_stage_reads(layout: Layout, j: int) -> torch.Tensor:
    """The stage offset from which each thread of a block reads each
    velocity i at step j (x = x0 + j), (19, TY * W): in the row of its
    source (x - c_x, y - c_y), INDEX over the row's W sites of z - c_z, or
    i's edge value where z - c_z leaves the tile."""
    t = torch.arange(K8_TY * K8_W, dtype=torch.int64)
    tz, ty = t % K8_W, t // K8_W
    offset = torch.zeros((19, t.numel()), dtype=torch.int64)
    for i in range(19):
        cx, cy, cz = (int(c) for c in d3q19.CV[i])
        row = (((j + 1 - cx) % K8_SLOTS) * (K8_TY + 2) + ty + 1 - cy) * K8_ROW
        zs = tz - cz
        inside = (zs >= 0) & (zs < K8_W)
        edge = 0
        if cz:
            edge = K8_W * 19 + (cz < 0) * K8_EDGE + K8_EDGE_VELOCITIES.index(i - (cz < 0))
        offset[i] = row + torch.where(inside, layout.flat_index(i, zs % K8_W, 19, K8_W), edge)
    return offset


def k8_tiled_emulate(flat: torch.Tensor, lattice, layout: Layout) -> torch.Tensor:
    """K8's staged tiles run on a flat dist in ``layout``, block by block and
    step by step as the kernel does (its row copies, reads, out stage and
    stores), returning the flat out: propagate_plain's bits when the address
    maps are right.  A slot is NaN before each plane's copy, so a read of a
    float the copy does not write shows."""
    X, Y, Z = _check_3d(lattice)
    R, run = K8_TY + 2, K8_W * 19
    out = torch.full_like(flat, float("nan"))
    written = torch.zeros(flat.numel(), dtype=torch.int64)
    t = torch.arange(K8_TY * K8_W)
    for b in range((Z // K8_W) * (Y // K8_TY) * -(-X // K8_XS)):
        x0, y0, z0, xs = k8_block_tile(lattice, b)
        stage = torch.full((K8_SLOTS * R * K8_ROW,), float("nan"), dtype=flat.dtype)

        def load(pi):
            slot = (pi % K8_SLOTS) * R * K8_ROW
            stage[slot:slot + R * K8_ROW] = float("nan")
            for q in range(R):
                lo, edges = k8_row_copies(lattice, layout, x0, y0, z0, pi, q)
                at = slot + q * K8_ROW
                assert lo % 4 == 0 and at % 4 == 0
                stage[at:at + run] = flat[lo:lo + run]
                stage[at + run:at + run + 2 * K8_EDGE] = flat[torch.tensor(edges)]

        for pi in range(3):
            load(pi)
        for j in range(xs):
            if j + 3 <= xs + 1:
                load(j + 3)
            o = stage[k8_stage_reads(layout, j)]
            ost = torch.empty(K8_TY * run, dtype=flat.dtype)
            for i in range(19):
                ost[t // K8_W * run + layout.flat_index(i, t % K8_W, 19, K8_W)] = o[i]
            for r in range(K8_TY):
                dst = (((x0 + j) * Y + y0 + r) * Z + z0) * 19
                out[dst:dst + run] = ost[r * run:(r + 1) * run]
                written[dst:dst + run] += 1
    assert bool((written == 1).all()), "K8's tiles write every output exactly once"
    return out


def _check_3d(lattice: Sequence[int]) -> Tuple[int, int, int]:
    lat = tuple(int(s) for s in lattice)
    if len(lat) != 3 or min(lat) < 1:
        raise ValueError(f"the LB kernels need a 3-D lattice, got {lat}")
    return lat


def _propagate_canonical(dist: torch.Tensor, lat) -> torch.Tensor:
    return ref.propagate_ref(dist.reshape((19,) + lat)).reshape(19, -1)


def propagate_plain(dist: torch.Tensor, lattice, layouts=None) -> torch.Tensor:
    """dist (19 components) -> streamed, periodic; ``layouts`` names
    "dist", "out"."""
    lat = _check_3d(lattice)
    lay = resolve_layouts(layouts, ("dist",), ("out",))
    return lay["out"].pack(_propagate_canonical(lay["dist"].unpack(dist), lat))


def propagate_cuda(dist: torch.Tensor, lattice, vvl: int = 128, *,
                   layouts=None) -> torch.Tensor:
    """K8: periodic D3Q19 streaming of 19-component distributions."""
    if dist.device.type == "cpu":
        return propagate_plain(dist, lattice, layouts)
    lat = _check_3d(lattice)
    lay = resolve_layouts(layouts, ("dist",), ("out",))
    V = math.prod(lat)
    ld = check_field("dist", dist, lay["dist"], 19, V, dist.device)
    out = torch.empty(lay["out"].physical_shape(19, V), dtype=dist.dtype, device=dist.device)
    PROPAGATE.launch(dist.device, dist.data_ptr(), out.data_ptr(), *lat, ld,
                     lay["out"].descriptor(), vvl)
    return out


def moments_velocity(dist: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
    """The ludwig_lb_step graph's u: mom/rho + 0.5 force/rho (the driver's
    _moments_body, not collision's (mom + 0.5 force)/rho)."""
    rho, u = moments(dist)
    return u + 0.5 * force / rho[None, :]


_STEP_IN, _STEP_OUT = ("dist", "force"), ("dist2", "u")


def lb_step_plain(dist: torch.Tensor, force: torch.Tensor, tau: float, lattice,
                  with_u: bool = True, layouts=None, bf16: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dist2 = propagate(collide(dist, force)), u or None); ``layouts``
    names "dist", "force", "dist2", "u".  ``bf16``: dist and force rounded
    to bf16 first, dist2 and u returned in bf16."""
    lat = _check_3d(lattice)
    lay = resolve_layouts(layouts, _STEP_IN, _STEP_OUT)
    d, f = lay["dist"].unpack(dist), lay["force"].unpack(force)
    if bf16:
        d, f = (t.to(torch.bfloat16).to(t.dtype) for t in (d, f))
    out = torch.bfloat16 if bf16 else d.dtype
    dist2 = lay["dist2"].pack(_propagate_canonical(collide_plain(d, f, tau), lat).to(out))
    return dist2, (lay["u"].pack(moments_velocity(d, f).to(out)) if with_u else None)


def lb_step_cuda(dist: torch.Tensor, force: torch.Tensor, tau: float, lattice,
                 vvl: int = 128, with_u: bool = True, *, layouts=None, bf16: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5L: one launch computing the streamed post-collision distributions
    and (with_u) the half-force velocity of dist (19 components) and force
    (3); ``layouts`` names "dist", "force", "dist2", "u".  ``bf16``: the
    policy instance (bf16 stage-in, dist2 and u in bf16)."""
    if dist.device.type == "cpu":
        return lb_step_plain(dist, force, tau, lattice, with_u, layouts, bf16)
    lat = _check_3d(lattice)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _STEP_IN, _STEP_OUT)
    ld = check_field("dist", dist, lay["dist"], 19, V, dist.device)
    lf = check_field("force", force, lay["force"], 3, V, dist.device)
    out = torch.bfloat16 if bf16 else dist.dtype
    dist2 = torch.empty(lay["dist2"].physical_shape(19, V), dtype=out, device=dist.device)
    u = (torch.empty(lay["u"].physical_shape(3, V), dtype=out, device=dist.device)
         if with_u else None)
    (LB_STEP_BF16 if bf16 else LB_STEP).launch(
        dist.device, dist.data_ptr(), force.data_ptr(), dist2.data_ptr(),
        u.data_ptr() if with_u else None, *lat, *lb_params(float(tau)), ld, lf,
        lay["dist2"].descriptor(), lay["u"].descriptor(), vvl)
    return dist2, u


def tiled_walk(lattice, tile: Sequence[int], ring: int = 0) -> torch.Tensor:
    """The site (x * Y + y) * Z + z at each position g of K9's walk
    (``rt_tile_site`` in d3q19.cuh): tiles in the reference's grid order,
    z-tile fastest, and in a tile x, y, then z fastest.  Position g is
    computed by thread g % block of the block's unit g // block.  With
    ``ring`` 1, K9H's tiled walk over the lattice (a box) grown by 1
    (lb_halo.cu): the box's walk, each site placed 1 in, then the ring
    (``core.stencil.shell_order``), sites linear over the grown box."""
    lat = _check_3d(lattice)
    bx, by, bz = tile_extents(lat, *tile)
    X, Y, Z = lat
    g = torch.arange(math.prod(lat), dtype=torch.int64)
    t, l = g // (bx * by * bz), g % (bx * by * bz)
    lz, l = l % bz, l // bz
    ly, lx = l % by, l // by
    nty, ntz = Y // by, Z // bz
    tz, r = t % ntz, t // ntz
    ty, tx = r % nty, r // nty
    x, y, z = tx * bx + lx, ty * by + ly, tz * bz + lz
    if not ring:
        return (x * Y + y) * Z + z
    if ring != 1:
        raise ValueError(f"K9H's walk grows the box by 1, not {ring}")
    return torch.cat([((x + 1) * (Y + 2) + y + 1) * (Z + 2) + z + 1, shell_order(lat)])


def lb_step_tiled_plain(dist: torch.Tensor, force: torch.Tensor, tau: float, lattice,
                        tile: Sequence[int], with_u: bool = True, layouts=None,
                        bf16: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The collide -> propagate graph tile by tile (``tiled_plain``), and
    (with_u) the half-force velocity, which is site-local; ``layouts`` and
    ``bf16`` as in :func:`lb_step_plain`."""
    from .ops import collide_propagate_graph  # ops imports this module

    lat = _check_3d(lattice)
    lay = resolve_layouts(layouts, _STEP_IN, _STEP_OUT)
    d, f = lay["dist"].unpack(dist), lay["force"].unpack(force)
    if bf16:
        d, f = (t.to(torch.bfloat16).to(t.dtype) for t in (d, f))
    out = torch.bfloat16 if bf16 else d.dtype
    nd = {"dist": d.reshape((19,) + lat), "force": f.reshape((3,) + lat)}
    dist2 = tiled_plain(collide_propagate_graph(float(tau)), nd, lat,
                        *tile_extents(lat, *tile))["dist2"]
    return (lay["dist2"].pack(dist2.reshape(19, -1).to(out)),
            lay["u"].pack(moments_velocity(d, f).to(out)) if with_u else None)


def lb_step_tiled_cuda(dist: torch.Tensor, force: torch.Tensor, tau: float, lattice,
                       tile: Sequence[int], with_u: bool = True, block: int = K9_BLOCK, *,
                       layouts=None, bf16: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K9: :func:`lb_step_cuda`'s outputs computed tile by tile, ``tile`` =
    (bx, by, bz) with 0 for a whole axis; ``layouts`` names "dist",
    "force", "dist2", "u"; ``bf16``: the policy instance.  Raises when the
    tile does not divide the lattice."""
    lat = _check_3d(lattice)
    tile = tile_extents(lat, *tile)
    if any(e < 1 or s % e for s, e in zip(lat, tile)):
        raise ValueError(f"K9: tile {tile} does not divide the lattice {lat}")
    if dist.device.type == "cpu":
        return lb_step_tiled_plain(dist, force, tau, lat, tile, with_u, layouts, bf16)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _STEP_IN, _STEP_OUT)
    ld = check_field("dist", dist, lay["dist"], 19, V, dist.device)
    lf = check_field("force", force, lay["force"], 3, V, dist.device)
    out = torch.bfloat16 if bf16 else dist.dtype
    dist2 = torch.empty(lay["dist2"].physical_shape(19, V), dtype=out, device=dist.device)
    u = (torch.empty(lay["u"].physical_shape(3, V), dtype=out, device=dist.device)
         if with_u else None)
    (LB_STEP_TILED_BF16 if bf16 else LB_STEP_TILED).launch(
        dist.device, dist.data_ptr(), force.data_ptr(), dist2.data_ptr(),
        u.data_ptr() if with_u else None, *lat, *tile, *lb_params(float(tau)), ld, lf,
        lay["dist2"].descriptor(), lay["u"].descriptor(), block)
    return dist2, u


# -- K8H and K5LH: on pre-exchanged halos ------------------------------------------------

def _halo_lattice(shape, ncomp: int, width: int, what: str) -> Tuple[int, int, int]:
    lat = tuple(int(s) - 2 * width for s in shape[1:])
    if width < 1 or shape[0] != ncomp or len(lat) != 3 or min(lat) < 1:
        raise ValueError(f"{what}: {tuple(shape)} is not a ({ncomp}, ...) field over a 3-D "
                         f"lattice padded by width {width}")
    return lat


def propagate_halo_plain(dist_h: torch.Tensor, width: int = 1) -> torch.Tensor:
    """dist_h (19, X+2w, Y+2w, Z+2w) canonical, halos exchanged -> the
    interior's streamed (19, X, Y, Z)."""
    _halo_lattice(dist_h.shape, 19, width, "propagate_halo")
    return ref.propagate_halo_ref(dist_h, width)


def propagate_halo_cuda(dist_h: torch.Tensor, width: int = 1, vvl: int = 128) -> torch.Tensor:
    """K8H: :func:`propagate_halo_plain` in one launch (``vvl`` interior
    sites a block, a site a thread)."""
    if dist_h.device.type == "cpu":
        return propagate_halo_plain(dist_h, width)
    lat = _halo_lattice(dist_h.shape, 19, width, "propagate_halo")
    check_tensor("dist_h", dist_h, tuple(dist_h.shape), dist_h.device)
    out = torch.empty((19,) + lat, dtype=dist_h.dtype, device=dist_h.device)
    PROPAGATE_HALO.launch(dist_h.device, dist_h.data_ptr(), out.data_ptr(), *lat, int(width),
                          vvl)
    return out


def _pre_canonical(dist_h, force_h, tau, lat, with_u):
    """(dist2 (19, V), u (3, V) or None), canonical, on the interior ``lat``
    from canonical dist_h (19, Vh) and force_h (3, Vh) over it padded by 1:
    the collision on the whole halo'd box, the streaming's pull from it, and
    u from the interior's moments."""
    hl = tuple(s + 2 for s in lat)
    post = collide_plain(dist_h, force_h, tau).reshape((19,) + hl)
    dist2 = ref.propagate_halo_ref(post, 1).reshape(19, -1)
    if not with_u:
        return dist2, None

    def inner(a):
        return a.reshape((a.shape[0],) + hl)[:, 1:-1, 1:-1, 1:-1].reshape(a.shape[0], -1)

    return dist2, moments_velocity(inner(dist_h), inner(force_h))


def _box_canonical(dist_h, force_h, tau, lat, origin, extents, with_u):
    """:func:`_pre_canonical` on the box at ``origin`` (``extents``) of the
    interior ``lat``: its window, the box padded by 1, cut from the whole
    halo'd inputs, as the reference's sub-launch and tile read it."""
    win = (slice(None),) + box_slices(lat, origin, extents, 1)
    hl = tuple(s + 2 for s in lat)
    return _pre_canonical(dist_h.reshape((19,) + hl)[win].reshape(19, -1),
                          force_h.reshape((3,) + hl)[win].reshape(3, -1), tau,
                          tuple(int(e) for e in extents), with_u)


def _pre_tiled_canonical(dist_h, force_h, tau, lat, tile, with_u):
    """:func:`_pre_canonical` tile by tile, the reference's tiled lowering
    on pre-exchanged halos: each tile's halo'd window cut from the whole
    arrays, its sites written (tiles in :func:`core.stencil.tile_boxes`'
    order)."""
    dist2 = torch.empty((19,) + lat, dtype=dist_h.dtype, device=dist_h.device)
    u = torch.empty((3,) + lat, dtype=dist_h.dtype, device=dist_h.device) if with_u else None
    for box in tile_boxes(lat, *tile):
        o, e = tuple(a for a, _ in box), tuple(b for _, b in box)
        d2, ub = _box_canonical(dist_h, force_h, tau, lat, o, e, with_u)
        sl = (slice(None),) + box_slices(lat, o, e)
        dist2[sl] = d2.reshape((19,) + e)
        if with_u:
            u[sl] = ub.reshape((3,) + e)
    return dist2.reshape(19, -1), (u.reshape(3, -1) if with_u else None)


def _pre_tile(lat, tile) -> Optional[Tuple[int, int, int]]:
    """A "pre" launch's tile (bx, by, bz; 0 a whole axis) checked to divide
    ``lat``, or None untiled."""
    if tile is None:
        return None
    ext = tile_extents(lat, *tile)
    if len(tile) != 3 or any(e < 1 or s % e for s, e in zip(lat, ext)):
        raise ValueError(f"K9H: tile {tuple(tile)} does not divide the box {lat}")
    return ext


def lb_step_pre_plain(dist_h: torch.Tensor, force_h: torch.Tensor, tau: float, lattice,
                      with_u: bool = True, *, tile=None, layouts=None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dist2, u or None) on the interior ``lattice`` from dist_h (19 x Vh)
    and force_h (3 x Vh) over the interior padded by 1 (halos exchanged),
    physical in ``layouts`` (names "dist", "force" over the halo'd sites,
    "dist2", "u" over the interior; SoA by default): the collision on the
    whole halo'd box, the streaming's pull from it, and u from the
    interior's moments.  ``tile`` (bx, by, bz; 0 a whole axis): the same
    tile by tile, each tile's window cut from the halo'd arrays."""
    lat = _check_3d(lattice)
    lay = resolve_layouts(layouts, _STEP_IN, _STEP_OUT)
    d, f = lay["dist"].unpack(dist_h), lay["force"].unpack(force_h)
    ext = _pre_tile(lat, tile)
    if ext is None:
        dist2, u = _pre_canonical(d, f, tau, lat, with_u)
    else:
        dist2, u = _pre_tiled_canonical(d, f, tau, lat, ext, with_u)
    return lay["dist2"].pack(dist2), (lay["u"].pack(u) if with_u else None)


def _halo_operands(dist_h, force_h, lat, lay):
    """K5LH's SoA checks (lay None), else K9H's descriptors of dist_h and
    force_h over the halo'd sites."""
    Vh = math.prod(s + 2 for s in lat)
    if lay is None:
        check_tensor("dist_h", dist_h, (19, Vh), dist_h.device)
        check_tensor("force_h", force_h, (3, Vh), dist_h.device)
        return None
    return (check_field("dist", dist_h, lay["dist"], 19, Vh, dist_h.device),
            check_field("force", force_h, lay["force"], 3, Vh, dist_h.device))


def _k9h_launch(dist_h, force_h, dist2, u, tau, lat, origin, extents, tile, lay, descs, vvl):
    LB_STEP_HALO.launch(dist_h.device, dist_h.data_ptr(), force_h.data_ptr(), dist2.data_ptr(),
                        u.data_ptr() if u is not None else None, *lat, *origin, *extents,
                        *(tile or (0, 0, 0)), *lb_params(float(tau)), *descs,
                        lay["dist2"].descriptor(), lay["u"].descriptor(), vvl)


def _soa_untiled(lay, tile) -> bool:
    return tile is None and all(lay[n].kind is LayoutKind.SOA for n in _STEP_IN + _STEP_OUT)


def lb_step_pre_cuda(dist_h: torch.Tensor, force_h: torch.Tensor, tau: float, lattice,
                     vvl: int = 128, with_u: bool = True, *, tile=None, layouts=None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`lb_step_pre_plain` in one launch (``vvl`` threads a block):
    K5LH where every field is SoA and the plan untiled, else K9H (the same
    template under the tile's walk and the layouts' addressing)."""
    if dist_h.device.type == "cpu":
        return lb_step_pre_plain(dist_h, force_h, tau, lattice, with_u, tile=tile,
                                 layouts=layouts)
    lat = _check_3d(lattice)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _STEP_IN, _STEP_OUT)
    ext = _pre_tile(lat, tile)
    dev = dist_h.device
    dist2 = torch.empty(lay["dist2"].physical_shape(19, V), dtype=dist_h.dtype, device=dev)
    u = (torch.empty(lay["u"].physical_shape(3, V), dtype=dist_h.dtype, device=dev)
         if with_u else None)
    if _soa_untiled(lay, ext):
        _halo_operands(dist_h, force_h, lat, None)
        LB_STEP_PRE.launch(dev, dist_h.data_ptr(), force_h.data_ptr(), dist2.data_ptr(),
                           u.data_ptr() if with_u else None, *lat, *lb_params(float(tau)), vvl)
    else:
        _k9h_launch(dist_h, force_h, dist2, u, tau, lat, (0, 0, 0), lat, ext, lay,
                    _halo_operands(dist_h, force_h, lat, lay), vvl)
    return dist2, u


def lb_step_box_plain(dist_h: torch.Tensor, force_h: torch.Tensor, tau: float, lattice, origin,
                      extents, with_u: bool = True, *, tile=None, layouts=None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dist2, u or None), canonical (SoA) over the box at ``origin``
    (``extents`` sites a dim) of the interior ``lattice``, from dist_h and
    force_h over the whole interior padded by 1, physical in ``layouts``
    (names as in :func:`lb_step_pre_plain`; only the inputs' are read): the
    "pre" lowering on the box's window (the box padded by 1), as the
    reference's sub-launch computes it, tile by tile under ``tile`` (the
    box's sub-plan's)."""
    lat = _check_3d(lattice)
    lay = resolve_layouts(layouts, _STEP_IN, _STEP_OUT)
    d, f = lay["dist"].unpack(dist_h), lay["force"].unpack(force_h)
    box = tuple(int(e) for e in extents)
    win = (slice(None),) + box_slices(lat, origin, box, 1)
    hl = tuple(s + 2 for s in lat)
    dw = d.reshape((19,) + hl)[win].reshape(19, -1)
    fw = f.reshape((3,) + hl)[win].reshape(3, -1)
    ext = _pre_tile(box, tile)
    if ext is None:
        return _pre_canonical(dw, fw, tau, box, with_u)
    return _pre_tiled_canonical(dw, fw, tau, box, ext, with_u)


def lb_step_box_cuda(dist_h: torch.Tensor, force_h: torch.Tensor, tau: float, lattice, origin,
                     extents, dist2: torch.Tensor, u: Optional[torch.Tensor] = None,
                     vvl: int = 128, *, tile=None, layouts=None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`lb_step_box_plain` written into the box's sites of ``dist2``
    (19 x V) and, where given, ``u`` (3 x V), the whole interior's outputs
    in ``layouts``, in one launch (``vvl`` threads a block): K5LHO where
    every field is SoA and the box untiled, else K9H.  Returns ``(dist2,
    u)``."""
    lat = _check_3d(lattice)
    sl = box_slices(lat, origin, extents)
    lay = resolve_layouts(layouts, _STEP_IN, _STEP_OUT)
    V = math.prod(lat)
    if dist_h.device.type == "cpu":
        d2, ub = lb_step_box_plain(dist_h, force_h, tau, lat, origin, extents, u is not None,
                                   tile=tile, layouts=layouts)
        box = tuple(int(e) for e in extents)
        for out, val, n, nc in ((dist2, d2, "dist2", 19), (u, ub, "u", 3)):
            if out is None:
                continue
            canon = lay[n].unpack(out).reshape((nc,) + lat).clone()
            canon[(slice(None),) + sl] = val.reshape((nc,) + box)
            out.copy_(lay[n].pack(canon.reshape(nc, V)))
        return dist2, u
    o, e = tuple(s.start for s in sl), tuple(s.stop - s.start for s in sl)
    ext = _pre_tile(e, tile)
    if _soa_untiled(lay, ext):
        _halo_operands(dist_h, force_h, lat, None)
        check_tensor("dist2", dist2, (19, V), dist_h.device)
        if u is not None:
            check_tensor("u", u, (3, V), dist_h.device)
        LB_STEP_BOX.launch(dist_h.device, dist_h.data_ptr(), force_h.data_ptr(),
                           dist2.data_ptr(), u.data_ptr() if u is not None else None, *lat, *o,
                           *e, *lb_params(float(tau)), vvl)
        return dist2, u
    descs = _halo_operands(dist_h, force_h, lat, lay)
    check_field("dist2", dist2, lay["dist2"], 19, V, dist_h.device)
    if u is not None:
        check_field("u", u, lay["u"], 3, V, dist_h.device)
    _k9h_launch(dist_h, force_h, dist2, u, tau, lat, o, e, ext, lay, descs, vvl)
    return dist2, u

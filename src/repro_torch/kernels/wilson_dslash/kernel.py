"""CUDA wrappers for the Wilson operator: K4 (``csrc/dslash.cu``) and K5
(``csrc/wilson_normal.cu``), each beside its plain PyTorch version.

K4 replaces ``kernels/wilson_dslash/kernel.py::dslash_site_pallas`` of the
JAX package together with its gather prologue; K5 replaces
``core/fuse.py::LaunchGraph._build_nd`` for the ``wilson_normal`` graph.
Both kernels run one thread per site over fp32 fields on a periodic 4-D
lattice, each field in its own layout (SoA, AoS or AoSoA, addressed
through INDEX inside the kernel), and share one device function for the
hopping term (``csrc/wilson.cuh``).  Each wrapper takes physical tensors
and ``layouts`` (names as in its signature; an input not named is SoA, an
output takes the first input's layout) and returns physical tensors.  Both are bound by device-memory bytes (480
compulsory bytes a site); see the sources for what each design leaves on
the table.

K4 and K5 run their blocks, each a chunk of vvl consecutive sites (the
plan's vvl is the block's thread count), in a brick order with short reuse
distances (``csrc/wilson_normal.cuh``; K4 in every layout, K5 linear under
AoS); :func:`block_chunks` mirrors that order.  Both address a field with
32-bit offsets where its gauge field has fewer than 2^31 values (72 V), and
with 64-bit ones above.  In AoS and in AoSoA with a SAL of 2 to 16, where T
is 32 and vvl at most 128, each warp of K4 copies its neighbours' records
into shared memory as 16-byte pieces, reading whole 32-byte sectors.

K5B, the batch instance (``batched=True``), runs K5's two kernels with a
thread computing its site for a group of up to NORMAL_SLOTS slots (the
policy instance: NORMAL_SLOTS_POLICY), each link loaded once for the group:
p and ap are ``batch`` stacked spinors, u is one gauge field shared by every
slot, pap is (batch, 24), and each slot's ap and pap are bitwise the single
launch's on that slot.  On a lattice with 72 V >= 2^31 K5B computes one
slot a thread.

K5's policy instance (``policy=``, a ``core.plan.CudaPolicy``;
``csrc/wilson_normal_mixed.cu``), single and batched: under bf16 storage u
is the caller's bf16 copy (:func:`bf16_pack_cuda`, made once per operator
by ``apps/milc/cg.py::make_fused_normal``; an fp32 ``u`` raises), p is
rounded to bf16 as it is loaded, t stays fp32, ap is written in bf16 and
pap takes the fp32 ap; under a compensated accumulate pap's partials are
(hi, lo) pairs folded by K2's compensated pass 2.  A policy asking for
neither runs the policy-free kernels.

K5T, the tiled instance (:func:`wilson_normal_tiled_cuda`; the
``wilson_normal`` graph under a tiled plan), single, batched and policy:
K5's two kernels with their blocks taking NORMAL_TILED_BLOCK consecutive
positions of the plan's tile walk (:func:`normal_walk`: tiles in the
reference's grid order, t whole in a tile) instead of the brick order's
chunks, and pap's partial rows folded by K2 in walk order.  t and ap are
bitwise K5's; pap is held to its plain version
(:func:`wilson_normal_tiled_plain`) within a tolerance, and is K5's bits
where the walk is the linear order.

K4H (:func:`dslash_halo_cuda`, ``csrc/wilson_halo.cu``) is K4 on
pre-exchanged halos: D psi on the interior of a spinor and a gauge field
padded by ``width`` a side, read at the halo'd arrays' own strides.  K5H
(:func:`wilson_normal_pre_cuda`) is the ``wilson_normal`` graph under
``halo="pre"``: ap = M^dag M p on the interior from p and u padded by 2,
in two launches (t on ring 1, then ap), with no pap (the sharded solve
takes <p, Ap> from ``dot``).  K5HO is the same two kernels on tables of
boxes, the ``halo="overlap"`` split: :func:`wilson_normal_interior_cuda`
computes t on the interior box grown by 1 and ap on the interior,
:func:`wilson_normal_boundary_cuda` t on the rest of the ring-1 array (the
shell, :func:`shell_boxes`) and ap on every boundary box, one launch a
kernel each, into one ring-1 t array and the whole-interior ap, so that no
t site is computed twice and every site is bitwise the whole launch's.  The
two T-slabs of a table are taken as one box (:func:`pair_t_slabs`;
:func:`split_tables` gives the four launches' tables, :func:`split_tiles`
the tiles of the ap tables' boxes under a tiled plan: tiled K5HO walks
each such box's rows in its sub-plan's tile order).  K5TH
(:func:`wilson_normal_pre_cuda` with ``tile``) is K5H's two kernels walking
K5T's order (:func:`normal_walk`; the t launch over the ring-1 array with
``ring=1``).  All take fp32 SoA fields.

On a CPU tensor each wrapper returns its plain version (unpack, torch ops,
pack); on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch._cuda import Kernel, check_batched_field, check_field, check_tensor, csrc_define
from repro_torch.core.layout import resolve_layouts
from repro_torch.core.plan import CudaPolicy
from repro_torch.core.reduce import compensated_plain, fold_partials, fold_partials_batched
from repro_torch.core.stencil import box_slices, shell_order, shifted_window, tile_boxes
from . import ref

__all__ = ["dslash_cuda", "dslash_plain", "wilson_normal_cuda",
           "wilson_normal_plain", "wilson_normal_tiled_cuda", "wilson_normal_tiled_plain",
           "normal_walk", "NORMAL_TILED_BLOCK", "WILSON_NORMAL_T_TILED",
           "WILSON_NORMAL_AP_TILED", "WILSON_NORMAL_T_TILED_MIXED",
           "WILSON_NORMAL_AP_TILED_MIXED", "bf16_round", "bf16_round_cuda", "bf16_pack_cuda",
           "block_chunks", "BRICK_X", "NORMAL_SLOTS", "NORMAL_SLOTS_POLICY", "DSLASH",
           "WILSON_NORMAL_T",
           "WILSON_NORMAL_AP", "WILSON_NORMAL_T_B", "WILSON_NORMAL_AP_B",
           "WILSON_NORMAL_T_MIXED", "WILSON_NORMAL_AP_MIXED", "BF16_ROUND", "BF16_PACK",
           "dslash_halo_cuda", "dslash_halo_plain", "wilson_normal_pre_cuda",
           "wilson_normal_pre_plain", "DSLASH_HALO", "WILSON_NORMAL_PRE_T",
           "WILSON_NORMAL_PRE_AP", "wilson_normal_box_plain", "wilson_normal_interior_cuda",
           "wilson_normal_boundary_cuda", "wilson_normal_split_plain", "split_tables",
           "shell_boxes", "pair_t_slabs", "table_entries", "HTAB_MAX", "WILSON_NORMAL_BOX_T",
           "WILSON_NORMAL_BOX_AP", "table_reads", "table_footprint",
           "WILSON_NORMAL_PRE_T_TILED", "WILSON_NORMAL_PRE_AP_TILED",
           "WILSON_NORMAL_BOX_AP_TILED", "split_tiles"]

DSLASH = Kernel("dslash", "rt_dslash")
WILSON_NORMAL_T = Kernel("wilson_normal_t", "rt_wilson_normal_t")
WILSON_NORMAL_AP = Kernel("wilson_normal_ap", "rt_wilson_normal_ap")
WILSON_NORMAL_T_B = Kernel("wilson_normal_t_batched", "rt_wilson_normal_t_batched")
WILSON_NORMAL_AP_B = Kernel("wilson_normal_ap_batched", "rt_wilson_normal_ap_batched")
# the policy instance, single and batched (one slot a grid row)
WILSON_NORMAL_T_MIXED = Kernel("wilson_normal_t_mixed", "rt_wilson_normal_t_mixed")
WILSON_NORMAL_AP_MIXED = Kernel("wilson_normal_ap_mixed", "rt_wilson_normal_ap_mixed")
# K5T, the tiled instance (every slot count), and its policy instance
WILSON_NORMAL_T_TILED = Kernel("wilson_normal_t_tiled", "rt_wilson_normal_t_tiled")
WILSON_NORMAL_AP_TILED = Kernel("wilson_normal_ap_tiled", "rt_wilson_normal_ap_tiled")
WILSON_NORMAL_T_TILED_MIXED = Kernel("wilson_normal_t_tiled_mixed",
                                     "rt_wilson_normal_t_tiled_mixed")
WILSON_NORMAL_AP_TILED_MIXED = Kernel("wilson_normal_ap_tiled_mixed",
                                      "rt_wilson_normal_ap_tiled_mixed")
NORMAL_TILED_BLOCK = 128   # K5T's walk positions a block (K5's default vvl)
# K4H and K5H, on pre-exchanged halos (csrc/wilson_halo.cu)
DSLASH_HALO = Kernel("dslash_halo", "rt_dslash_halo")
WILSON_NORMAL_PRE_T = Kernel("wilson_normal_pre_t", "rt_wilson_normal_pre_t")
WILSON_NORMAL_PRE_AP = Kernel("wilson_normal_pre_ap", "rt_wilson_normal_pre_ap")
# K5TH: K5H's two kernels walking K5T's tile order (a tiled "pre" plan)
WILSON_NORMAL_PRE_T_TILED = Kernel("wilson_normal_pre_t_tiled", "rt_wilson_normal_pre_t_tiled")
WILSON_NORMAL_PRE_AP_TILED = Kernel("wilson_normal_pre_ap_tiled",
                                    "rt_wilson_normal_pre_ap_tiled")
# K5HO: K5H's site arithmetic on the halo="overlap" split's box tables; tiled
# K5HO the ap launch on a table where a box carries its sub-plan's tile
WILSON_NORMAL_BOX_T = Kernel("wilson_normal_box_t", "rt_wilson_normal_t_boxes")
WILSON_NORMAL_BOX_AP = Kernel("wilson_normal_box_ap", "rt_wilson_normal_ap_boxes")
WILSON_NORMAL_BOX_AP_TILED = Kernel("wilson_normal_box_ap_tiled",
                                    "rt_wilson_normal_ap_boxes_tiled")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even) and widened back to its
    dtype: a bf16-storage policy's stage-in."""
    return x.to(torch.bfloat16).to(x.dtype)


BF16_ROUND = Kernel("bf16_round", "rt_bf16_round")
BF16_PACK = Kernel("bf16_pack", "rt_bf16_pack")


def bf16_round_cuda(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """:func:`bf16_round` of an fp32 tensor through the policy instances'
    own rounding (``csrc/bf16.cuh``), for the card tests that hold it
    bitwise to torch's."""
    if x.device.type == "cpu":
        return bf16_round(x)
    check_tensor("x", x, x.shape, x.device)
    out = torch.empty_like(x)
    BF16_ROUND.launch(x.device, x.data_ptr(), out.data_ptr(), x.numel(), block)
    return out


def bf16_pack_cuda(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """x (fp32) rounded to bf16, as a bf16 tensor: the copy of the gauge
    field K5's policy instance reads, made on the card with the policy
    instances' own rounding (``csrc/bf16.cuh``)."""
    if x.device.type == "cpu":
        return x.to(torch.bfloat16)
    check_tensor("x", x, x.shape, x.device)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    BF16_PACK.launch(x.device, x.data_ptr(), out.data_ptr(), x.numel(), block)
    return out


# x-planes of a brick of K5's block order, and K5B's slots a thread
# (csrc/wilson_normal.cuh)
BRICK_X = csrc_define("wilson_normal.cuh", "RT_BRICK_X")
NORMAL_SLOTS = csrc_define("wilson_normal.cuh", "RT_NORMAL_SLOTS")
NORMAL_SLOTS_POLICY = csrc_define("wilson_normal.cuh", "RT_NORMAL_SLOTS_POLICY")


def block_chunks(lattice, vvl: int, batch: int = 1, aos: bool = False,
                 slots: int = NORMAL_SLOTS) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's block order (``rt_order_chunk`` of ``csrc/wilson_normal.cuh``):
    for each linear block index of a launch over ``batch`` slots, ``slots``
    a thread (NORMAL_SLOTS; NORMAL_SLOTS_POLICY for the policy instance),
    the slot group (slots [slots group, slots (group + 1)); one group for a
    single slot) and the chunk (the vvl consecutive sites [chunk vvl,
    (chunk + 1) vvl)) it computes, as two int64 tensors; ``aos``: a K5
    launch in AoS (linear chunks).  K4's launches take the order of
    ``batch`` 1 in every layout."""
    X, Y, Z, T = _check_4d(lattice)
    nchunks = -(-X * Y * Z * T // vvl)
    groups = -(-batch // slots) if batch > 1 else 1
    i = torch.arange(nchunks * groups, dtype=torch.int64)
    group, j = i % groups, i // groups
    if aos or (Y * Z * T) % vvl:
        return group, j
    nq = Y * Z * T // vvl
    per = BRICK_X * nq
    brick = j // per
    x0 = BRICK_X * brick
    w = torch.clamp(X - x0, max=BRICK_X)
    r = j - per * brick
    return group, (x0 + r % w) * nq + r // w


def _check_normal(vvl: int) -> None:
    """K5's limit: blocks of whole warps."""
    if vvl % 32 or not 0 < vvl <= 1024:
        raise ValueError(f"wilson_normal: vvl {vvl} is not a whole number of warps (<= 1024)")


def _check_4d(lattice: Sequence[int]) -> Tuple[int, int, int, int]:
    lat = tuple(int(s) for s in lattice)
    if len(lat) != 4 or min(lat) < 1:
        raise ValueError(f"the Wilson kernels need a 4-D lattice, got {lat}")
    return lat


_DSLASH_IN, _DSLASH_OUT = ("psi", "u"), ("out",)
_NORMAL_IN, _NORMAL_OUT = ("p", "u"), ("ap",)


def _dslash_canonical(psi: torch.Tensor, u: torch.Tensor, lat) -> torch.Tensor:
    return ref.dslash_ref(psi.reshape((24,) + lat), u.reshape((72,) + lat)).reshape(24, -1)


def dslash_plain(psi: torch.Tensor, u: torch.Tensor, lattice, layouts=None) -> torch.Tensor:
    """psi (24 components), u (72) -> D psi (24), periodic."""
    lat = _check_4d(lattice)
    lay = resolve_layouts(layouts, _DSLASH_IN, _DSLASH_OUT)
    return lay["out"].pack(_dslash_canonical(lay["psi"].unpack(psi), lay["u"].unpack(u), lat))


def dslash_cuda(psi: torch.Tensor, u: torch.Tensor, lattice, vvl: int = 128, *,
                layouts=None) -> torch.Tensor:
    """K4: D psi of a 24-component psi and a 72-component u on a periodic
    lattice; ``layouts`` names "psi", "u", "out"; ``vvl``: the sites of a
    block."""
    if psi.device.type == "cpu":
        return dslash_plain(psi, u, lattice, layouts)
    lat = _check_4d(lattice)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _DSLASH_IN, _DSLASH_OUT)
    lpsi = check_field("psi", psi, lay["psi"], 24, V, psi.device)
    lu = check_field("u", u, lay["u"], 72, V, psi.device)
    out = torch.empty(lay["out"].physical_shape(24, V), dtype=psi.dtype, device=psi.device)
    DSLASH.launch(psi.device, psi.data_ptr(), u.data_ptr(), out.data_ptr(),
                  *lat, lpsi, lu, lay["out"].descriptor(), vvl)
    return out


def _m_g5(psi: torch.Tensor, d: torch.Tensor, kappa: float) -> torch.Tensor:
    t = psi - kappa * d
    return torch.cat([t[:12], -t[12:]], dim=0)


def wilson_normal_plain(p: torch.Tensor, u: torch.Tensor, kappa: float,
                        lattice, layouts=None, *, batched: bool = False,
                        policy: Optional[CudaPolicy] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """t = g5(p - kappa D p), ap = g5(t - kappa D t), pap = sum_sites p*ap;
    ``layouts`` names "p", "u", "ap"; ``batched``: p is stacked spinors, each
    slot computed as alone.  ``policy``: p and u rounded to bf16 first and
    ap returned in bf16 (pap from the fp32 ap), pap summed in fp64 and
    rounded once when compensated."""
    if batched:
        outs = [wilson_normal_plain(pb, u, kappa, lattice, layouts, policy=policy) for pb in p]
        return torch.stack([a for a, _ in outs]), torch.stack([s for _, s in outs])
    bf16, comp = policy or (False, False)
    lat = _check_4d(lattice)
    lay = resolve_layouts(layouts, _NORMAL_IN, _NORMAL_OUT)
    p, ap = _normal_canonical(p, u, kappa, lat, lay, bf16)
    pap = compensated_plain(p * ap) if comp else (p * ap).sum(dim=1)
    return lay["ap"].pack(ap.to(torch.bfloat16) if bf16 else ap), pap


def _normal_canonical(p, u, kappa, lat, lay, bf16):
    """(p, ap) canonical in fp32: p as the kernels read it (rounded to
    bf16 under ``bf16``) and ap = M^dag M p before any rounding."""
    p, u = lay["p"].unpack(p), lay["u"].unpack(u).to(p.dtype)
    if bf16:
        p, u = bf16_round(p), bf16_round(u)
    t = _m_g5(p, _dslash_canonical(p, u, lat), kappa)
    return p, _m_g5(t, _dslash_canonical(t, u, lat), kappa)


def wilson_normal_cuda(p: torch.Tensor, u: torch.Tensor, kappa: float, lattice,
                       vvl: int = 128, *, layouts=None, batched: bool = False,
                       policy: Optional[CudaPolicy] = None,
                       rsplit: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (ap, pap (24,)) = (M^dag M p, per-component p . ap), in two
    launches and the fold of the pap partials (``rsplit`` segments, K2S
    where > 1); ``layouts`` names "p", "u", "ap" (the intermediate t is
    SoA).  ``batched`` (K5B): p is ``batch`` stacked spinors and u shared ->
    (ap stacked, pap (batch, 24)).  ``policy``: the policy instance (see the
    module docstring); under bf16 storage ``u`` is its bf16 copy."""
    if p.device.type == "cpu":
        return wilson_normal_plain(p, u, kappa, lattice, layouts, batched=batched,
                                   policy=policy)
    if policy is not None and any(policy):
        return _wilson_normal_mixed(p, u, kappa, lattice, vvl, layouts, batched, policy, rsplit)
    if batched:
        return _wilson_normal_batched(p, u, kappa, lattice, vvl, layouts, rsplit)
    lat = _check_4d(lattice)
    _check_normal(vvl)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _NORMAL_IN, _NORMAL_OUT)
    lp = check_field("p", p, lay["p"], 24, V, p.device)
    lu = check_field("u", u, lay["u"], 72, V, p.device)
    t = torch.empty((24, V), dtype=p.dtype, device=p.device)
    ap = torch.empty(lay["ap"].physical_shape(24, V), dtype=p.dtype, device=p.device)
    partials = torch.empty((-(-V // vvl), 24), dtype=p.dtype, device=p.device)
    WILSON_NORMAL_T.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(),
                           float(kappa), *lat, lp, lu, vvl)
    WILSON_NORMAL_AP.launch(p.device, p.data_ptr(), t.data_ptr(), u.data_ptr(),
                            ap.data_ptr(), partials.data_ptr(), float(kappa),
                            *lat, lp, lu, lay["ap"].descriptor(), vvl)
    return ap, fold_partials(partials, "sum", rsplit=rsplit)


def _wilson_normal_batched(p, u, kappa, lattice, vvl, layouts, rsplit=1):
    """K5B: K5 over ``p.shape[0]`` stacked spinors p against one shared u."""
    lat = _check_4d(lattice)
    _check_normal(vvl)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _NORMAL_IN, _NORMAL_OUT)
    batch = p.shape[0]
    lp = check_batched_field("p", p, lay["p"], 24, V, batch, p.device)
    lu = check_field("u", u, lay["u"], 72, V, p.device)
    t = torch.empty((batch, 24, V), dtype=p.dtype, device=p.device)
    ap = torch.empty((batch,) + lay["ap"].physical_shape(24, V), dtype=p.dtype, device=p.device)
    partials = torch.empty((batch, -(-V // vvl), 24), dtype=p.dtype, device=p.device)
    WILSON_NORMAL_T_B.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(), float(kappa),
                             *lat, batch, lp, lu, vvl)
    WILSON_NORMAL_AP_B.launch(p.device, p.data_ptr(), t.data_ptr(), u.data_ptr(), ap.data_ptr(),
                              partials.data_ptr(), float(kappa), *lat, batch, lp, lu,
                              lay["ap"].descriptor(), vvl)
    return ap, fold_partials_batched(partials, "sum", rsplit=rsplit)


def _wilson_normal_mixed(p, u, kappa, lattice, vvl, layouts, batched, policy, rsplit=1):
    """K5's policy instance over one spinor p or ``p.shape[0]`` stacked ones
    (``batched``) against one shared u (under bf16 storage its bf16 copy)."""
    lat = _check_4d(lattice)
    _check_normal(vvl)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _NORMAL_IN, _NORMAL_OUT)
    bf16, comp = policy
    if bf16 and u.dtype != torch.bfloat16:
        raise ValueError(f"wilson_normal under bf16 storage reads the bf16 copy of u "
                         f"(bf16_pack_cuda, made once per operator), got {u.dtype}")
    if batched:
        batch = p.shape[0]
        lp = check_batched_field("p", p, lay["p"], 24, V, batch, p.device)
    else:
        batch = 1
        lp = check_field("p", p, lay["p"], 24, V, p.device)
    lu = check_field("u", u, lay["u"], 72, V, p.device,
                     torch.bfloat16 if bf16 else torch.float32)
    lead = (batch,) if batched else ()
    t = torch.empty((batch, 24, V), dtype=torch.float32, device=p.device)
    ap = torch.empty(lead + lay["ap"].physical_shape(24, V),
                     dtype=torch.bfloat16 if bf16 else torch.float32, device=p.device)
    partials = torch.empty((batch, -(-V // vvl), 24) + ((2,) if comp else ()),
                           dtype=torch.float32, device=p.device)
    if bf16:
        WILSON_NORMAL_T_MIXED.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(),
                                     float(kappa), *lat, batch, lp, lu, vvl)
    elif batched:
        WILSON_NORMAL_T_B.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(),
                                 float(kappa), *lat, batch, lp, lu, vvl)
    else:
        WILSON_NORMAL_T.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(),
                               float(kappa), *lat, lp, lu, vvl)
    WILSON_NORMAL_AP_MIXED.launch(p.device, p.data_ptr(), t.data_ptr(), u.data_ptr(),
                                  ap.data_ptr(), partials.data_ptr(), float(kappa), *lat, batch,
                                  int(bf16), int(comp), lp, lu, lay["ap"].descriptor(), vvl)
    pap = fold_partials_batched(partials, "sum", compensated=comp, rsplit=rsplit)
    return ap, (pap if batched else pap[0])


# -- K5T: the tiled wilson_normal ---------------------------------------------------------

def _check_tile(lat, tile) -> Tuple[int, int, int]:
    """The tile (bx, by, bz) with 0 a whole axis, checked to divide the
    lattice (t is whole in every tile)."""
    ext = tuple(int(e) or n for e, n in zip(tile, lat[:3]))
    if len(tile) != 3 or any(e < 1 or n % e for e, n in zip(ext, lat)):
        raise ValueError(f"K5T: tile {tuple(tile)} does not divide the lattice {lat}")
    return ext


def normal_walk(lattice, tile, ring: int = 0) -> torch.Tensor:
    """The site ((x Y + y) Z + z) T + t at each position g of K5T's walk
    (``rt_walk_site`` of ``csrc/wilson_normal.cuh``): tiles (bx, by, bz) in
    the reference's grid order (x-slab outermost, z-tile fastest), and in a
    tile x, y, z, then t fastest.  Position g is computed by thread g %
    NORMAL_TILED_BLOCK of the block whose partial row is g //
    NORMAL_TILED_BLOCK.  With ``ring`` 1, K5TH's t walk over the ring-1
    array (``csrc/wilson_halo.cu::rt_ring1_walk_site``), sites linear over
    it: its (x, y, z) rows, each whole along T (T + 2 sites), the
    interior's rows in the walk (T 1), each placed 1 in, then the other
    rows (``core.stencil.shell_order`` of the x, y, z box)."""
    X, Y, Z, T = lat = _check_4d(lattice)
    bx, by, bz = _check_tile(lat, tile)
    g = torch.arange(X * Y * Z * T, dtype=torch.int64)
    tsites = bx * by * bz * T
    t, l = g // tsites, g % tsites
    lt, l = l % T, l // T
    lz, l = l % bz, l // bz
    ly, lx = l % by, l // by
    tz, r = t % (Z // bz), t // (Z // bz)
    ty, tx = r % (Y // by), r // (Y // by)
    x, y, z = tx * bx + lx, ty * by + ly, tz * bz + lz
    if not ring:
        return ((x * Y + y) * Z + z) * T + lt
    if ring != 1:
        raise ValueError(f"K5TH's t walk covers ring 1, not {ring}")
    xyz = normal_walk((X, Y, Z, 1), tile)
    inner = ((xyz // (Y * Z) + 1) * (Y + 2) + (xyz // Z) % Y + 1) * (Z + 2) + xyz % Z + 1
    rows = torch.cat([inner, shell_order((X, Y, Z))])
    return (rows[:, None] * (T + 2) + torch.arange(T + 2)).reshape(-1)


def _tile_order_sum(prod: torch.Tensor, lat, tile) -> torch.Tensor:
    """(24, V) canonical products -> (24,): each tile's sum, the tiles'
    partials folded in tile order (the reference's per-tile contract)."""
    X, Y, Z, T = lat
    bx, by, bz = tile
    tiles = prod.reshape(24, X // bx, bx, Y // by, by, Z // bz, bz, T)
    per = tiles.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(24, -1, bx * by * bz * T).sum(dim=2)
    return per.sum(dim=1)


def wilson_normal_tiled_plain(p: torch.Tensor, u: torch.Tensor, kappa: float, lattice, tile,
                              layouts=None, *, batched: bool = False,
                              policy: Optional[CudaPolicy] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`wilson_normal_plain` under the tile ``tile`` (bx, by, bz; 0 a
    whole axis): the same fields, and pap the sum of each tile's partial,
    the tiles in the reference's grid order (compensated sums, which round
    once, need no order)."""
    if batched:
        outs = [wilson_normal_tiled_plain(pb, u, kappa, lattice, tile, layouts, policy=policy)
                for pb in p]
        return torch.stack([a for a, _ in outs]), torch.stack([s for _, s in outs])
    lat = _check_4d(lattice)
    ext = _check_tile(lat, tile)
    bf16, comp = policy or (False, False)
    lay = resolve_layouts(layouts, _NORMAL_IN, _NORMAL_OUT)
    p, ap = _normal_canonical(p, u, kappa, lat, lay, bf16)
    # pap takes the fp32 ap, before the write's rounding
    pap = compensated_plain(p * ap) if comp else _tile_order_sum(p * ap, lat, ext)
    return lay["ap"].pack(ap.to(torch.bfloat16) if bf16 else ap), pap


def wilson_normal_tiled_cuda(p: torch.Tensor, u: torch.Tensor, kappa: float, lattice, tile,
                             block: int = NORMAL_TILED_BLOCK, *, layouts=None,
                             batched: bool = False, policy: Optional[CudaPolicy] = None,
                             rsplit: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5T: :func:`wilson_normal_cuda`'s (ap, pap) with the blocks walking
    the tile ``tile`` (bx, by, bz; 0 a whole axis), ``block`` walk positions
    a block; ``batched`` and ``policy`` as there (under bf16 storage ``u``
    is its bf16 copy).  Raises when the tile does not divide the
    lattice."""
    lat = _check_4d(lattice)
    ext = _check_tile(lat, tile)
    if p.device.type == "cpu":
        return wilson_normal_tiled_plain(p, u, kappa, lat, ext, layouts, batched=batched,
                                         policy=policy)
    _check_normal(block)
    V = math.prod(lat)
    lay = resolve_layouts(layouts, _NORMAL_IN, _NORMAL_OUT)
    bf16, comp = policy or (False, False)
    mixed = bf16 or comp
    if bf16 and u.dtype != torch.bfloat16:
        raise ValueError(f"wilson_normal under bf16 storage reads the bf16 copy of u "
                         f"(bf16_pack_cuda, made once per operator), got {u.dtype}")
    batch = p.shape[0] if batched else 1
    lp = (check_batched_field("p", p, lay["p"], 24, V, batch, p.device) if batched
          else check_field("p", p, lay["p"], 24, V, p.device))
    lu = check_field("u", u, lay["u"], 72, V, p.device, torch.bfloat16 if bf16 else torch.float32)
    lead = (batch,) if batched else ()
    t = torch.empty((batch, 24, V), dtype=torch.float32, device=p.device)
    ap = torch.empty(lead + lay["ap"].physical_shape(24, V),
                     dtype=torch.bfloat16 if bf16 else torch.float32, device=p.device)
    partials = torch.empty((batch, -(-V // block), 24) + ((2,) if comp else ()),
                           dtype=torch.float32, device=p.device)
    args = (*lat, batch, *ext)
    if bf16:
        WILSON_NORMAL_T_TILED_MIXED.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(),
                                           float(kappa), *args, lp, lu, block)
    else:
        WILSON_NORMAL_T_TILED.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(),
                                     float(kappa), *args, lp, lu, block)
    if mixed:
        WILSON_NORMAL_AP_TILED_MIXED.launch(
            p.device, p.data_ptr(), t.data_ptr(), u.data_ptr(), ap.data_ptr(),
            partials.data_ptr(), float(kappa), *args, int(bf16), int(comp), lp, lu,
            lay["ap"].descriptor(), block)
    else:
        WILSON_NORMAL_AP_TILED.launch(p.device, p.data_ptr(), t.data_ptr(), u.data_ptr(),
                                      ap.data_ptr(), partials.data_ptr(), float(kappa), *args,
                                      lp, lu, lay["ap"].descriptor(), block)
    pap = fold_partials_batched(partials, "sum", compensated=comp, rsplit=rsplit)
    return ap, (pap if batched else pap[0])


# -- K4H and K5H: on pre-exchanged halos --------------------------------------------------

_DIMS4 = (1, 2, 3, 4)


def _grow(lat, w: int) -> Tuple[int, ...]:
    return tuple(s + 2 * w for s in lat)


def _hop_box(psi: torch.Tensor, wp: int, u: torch.Tensor, wu: int) -> torch.Tensor:
    """D psi (24, *box) on the box that the canonical psi (24, ...) covers
    less ``wp`` sites a side and u (72, ...) less ``wu``: the reference's
    ``dslash_halo`` (its periodic gathers, cropped) as displaced windows."""
    packs = []
    for mu in range(4):
        e = [0, 0, 0, 0]
        e[mu] = 1
        packs.append(shifted_window(psi, [-x for x in e], wp, _DIMS4))   # psi(x + mu)
        packs.append(shifted_window(psi, e, wp, _DIMS4))                 # psi(x - mu)
    nbrs = torch.cat(packs, dim=0)
    u_fwd = shifted_window(u, (0, 0, 0, 0), wu, _DIMS4)
    u_bwd = torch.cat([shifted_window(u[mu * 18:(mu + 1) * 18],
                                      (0,) * mu + (1,) + (0,) * (3 - mu), wu, _DIMS4)
                       for mu in range(4)], dim=0)
    box = tuple(u_fwd.shape[1:])

    def flat(a):
        return a.reshape(a.shape[0], -1)

    return ref.dslash_site_chunk(flat(u_fwd), flat(u_bwd), flat(nbrs)).reshape((24,) + box)


def _halo_shapes(psi_h: torch.Tensor, u_h: torch.Tensor, width: int) -> Tuple[int, ...]:
    """The interior lattice of a halo'd (24, ...) spinor and (72, ...)
    gauge field padded by ``width``; raises where they do not match."""
    hl = tuple(psi_h.shape[1:])
    lat = tuple(s - 2 * width for s in hl)
    if (width < 1 or psi_h.shape[0] != 24 or tuple(u_h.shape) != (72,) + hl
            or len(lat) != 4 or min(lat) < 1):
        raise ValueError(f"dslash_halo: psi_h {tuple(psi_h.shape)} and u_h "
                         f"{tuple(u_h.shape)} are not a (24, ...) spinor and a (72, ...) gauge "
                         f"field over one 4-D lattice padded by width {width}")
    return lat


def dslash_halo_plain(psi_h: torch.Tensor, u_h: torch.Tensor, width: int = 1) -> torch.Tensor:
    """psi_h (24, X+2w, ...), u_h (72, ...) canonical, halos exchanged ->
    interior D psi (24, X, Y, Z, T)."""
    _halo_shapes(psi_h, u_h, width)
    return _hop_box(psi_h, width, u_h, width)


def dslash_halo_cuda(psi_h: torch.Tensor, u_h: torch.Tensor, width: int = 1,
                     vvl: int = 128) -> torch.Tensor:
    """K4H: :func:`dslash_halo_plain` in one launch (``vvl`` sites a block)."""
    if psi_h.device.type == "cpu":
        return dslash_halo_plain(psi_h, u_h, width)
    lat = _halo_shapes(psi_h, u_h, width)
    hl = _grow(lat, width)
    check_tensor("psi_h", psi_h, (24,) + hl, psi_h.device)
    check_tensor("u_h", u_h, (72,) + hl, psi_h.device)
    out = torch.empty((24,) + lat, dtype=psi_h.dtype, device=psi_h.device)
    DSLASH_HALO.launch(psi_h.device, psi_h.data_ptr(), u_h.data_ptr(), out.data_ptr(), *lat,
                       int(width), vvl)
    return out


def _pre_canonical(p_nd, u_nd, kappa):
    """ap (24, *interior) from canonical p_nd (24, *halo'd) and u_nd (72,
    *halo'd) padded by 2: t on ring 1, then ap."""
    t = _m_g5(shifted_window(p_nd, (0, 0, 0, 0), 1, _DIMS4), _hop_box(p_nd, 1, u_nd, 1), kappa)
    return _m_g5(shifted_window(t, (0, 0, 0, 0), 1, _DIMS4), _hop_box(t, 1, u_nd, 2), kappa)


def wilson_normal_pre_plain(p_h: torch.Tensor, u_h: torch.Tensor, kappa: float,
                            lattice, tile=None) -> torch.Tensor:
    """ap = M^dag M p (24, V), SoA, on the interior ``lattice`` from p_h
    (24, Vh) and u_h (72, Vh), SoA over the interior padded by 2 (halos
    exchanged): t on ring 1, then ap, as the graph's plain lowering under
    ``halo="pre"`` computes them.  ``tile`` (bx, by, bz; 0 a whole axis, T
    whole): the reference's tiled lowering, each tile's window (the tile
    padded by 2) cut from the halo'd arrays and t recomputed on its ring."""
    lat = _check_4d(lattice)
    hl = _grow(lat, 2)
    p_nd, u_nd = p_h.reshape((24,) + hl), u_h.reshape((72,) + hl)
    if tile is None:
        return _pre_canonical(p_nd, u_nd, kappa).reshape(24, -1)
    ap = torch.empty((24,) + lat, dtype=p_h.dtype, device=p_h.device)
    for box in tile_boxes(lat, *_check_tile(lat, tile)):
        o, e = tuple(a for a, _ in box), tuple(b for _, b in box)
        win = (slice(None),) + box_slices(lat, o, e, 2)
        ap[(slice(None),) + box_slices(lat, o, e)] = _pre_canonical(p_nd[win], u_nd[win], kappa)
    return ap.reshape(24, -1)


# A box table entry: (origin, extents, tsplit, tgap), the box's T index j at
# T = j, or j + tgap from j = tsplit on (csrc/wilson_halo.cu's rt_htab)
Entry = Tuple[Tuple[int, ...], Tuple[int, ...], int, int]


HTAB_MAX = 8   # boxes a table launch takes (csrc's RT_HTAB_MAX; a test holds the two equal)


def table_entries(boxes) -> List[Entry]:
    """Box table entries of (origin, extents) boxes, no gaps."""
    return [(tuple(int(v) for v in o), tuple(int(v) for v in e), int(e[3]), 0)
            for o, e in boxes]


def _paired(boxes) -> List[Tuple[Entry, int]]:
    """:func:`pair_t_slabs`' entries, each with the index of its first box."""
    out: List[Tuple[Entry, int]] = []
    ents = table_entries(boxes)
    i = 0
    while i < len(ents):
        o, e, _, _ = ents[i]
        if i + 1 < len(ents):
            o2, e2, _, _ = ents[i + 1]
            if o[:3] == o2[:3] and e[:3] == e2[:3] and o2[3] > o[3] + e[3]:
                out.append(((o, e[:3] + (e[3] + e2[3],), e[3], o2[3] - o[3] - e[3]), i))
                i += 2
                continue
        out.append((ents[i], i))
        i += 1
    return out


def pair_t_slabs(boxes) -> List[Entry]:
    """Table entries of (origin, extents) boxes, two consecutive boxes that
    differ only in T (a lo and a hi T-slab of one x, y, z range: a split's
    last two boxes) taken as one entry with a gap between them, so that a
    warp's sites of the two slabs share the 32-byte sectors where one row's
    hi slab meets the next row's lo slab."""
    return [e for e, _ in _paired(boxes)]


def shell_boxes(lattice, origin, extents) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """The ring-1 array of ``lattice`` (its extents + 2) less the box at
    ``origin``, ``extents`` of the interior grown by 1 (in ring-1
    coordinates: at ``origin``, extents + 2), as (origin, extents) boxes of
    the ring-1 array carved in ``core.overlap.split_boxes``' order: two
    slabs a dim the grown box does not span, the earlier such dims cut to
    its range, a disjoint cover; at most 8 boxes."""
    lat = tuple(int(v) + 2 for v in lattice)
    go, ge = tuple(int(v) for v in origin), tuple(int(v) + 2 for v in extents)
    rng = [(0, L) for L in lat]
    out = []
    for d, L in enumerate(lat):
        if go[d] == 0 and ge[d] == L:
            continue
        for a, b in ((0, go[d]), (go[d] + ge[d], L)):
            if b > a:
                box = list(rng)
                box[d] = (a, b)
                out.append((tuple(s for s, _ in box), tuple(e - s for s, e in box)))
        rng[d] = (go[d], go[d] + ge[d])
    return out


def _entry_mask(shape, entries: Sequence[Entry], device) -> torch.Tensor:
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    for o, e, ts, tg in entries:
        xyz = tuple(slice(a, a + b) for a, b in zip(o[:3], e[:3]))
        m[xyz + (slice(o[3], o[3] + ts),)] = True
        if ts < e[3]:
            m[xyz + (slice(o[3] + ts + tg, o[3] + e[3] + tg),)] = True
    return m


def _placed(m: torch.Tensor, shape, off: int, disp) -> torch.Tensor:
    """m's sites moved into an array of ``shape`` at offset ``off`` + disp."""
    out = torch.zeros(shape, dtype=torch.bool, device=m.device)
    out[tuple(slice(off + d, off + d + n) for d, n in zip(disp, m.shape))] = m
    return out


def _sectors(parts) -> int:
    """32-byte sectors of one SoA fp32 field read at each (mask, comps) of
    ``parts``: its planes ``comps`` at the mask's sites (a sector that
    straddles two planes counted once)."""
    V = parts[0][0].numel()
    if V % 8 == 0:
        return sum(len(c) * int(m.reshape(-1, 8).any(dim=1).sum()) for m, c in parts)
    idx = [(m.reshape(-1).nonzero().reshape(-1), c) for m, c in parts]
    return int(torch.unique(torch.cat([(k * V + i) // 8 for i, c in idx for k in c])).numel())


def table_reads(lattice, kind: str, entries: Sequence[Entry], device="cpu"):
    """The values a table launch reads and writes, as masks: (out, spinor,
    links) with ``out`` the computed sites of its output array, ``spinor``
    the sites of the spinor it reads (each computed site and its 8
    neighbours) and ``links`` (mask, components) of u, one a direction (u
    at the site and a step below it).  ``kind`` "t": t on ring-1 boxes
    (array extents + 2) from p and u (ring 2); "ap": ap on interior boxes
    from t (ring 1) and u; u's masks are over ring 2 in both."""
    lat = _check_4d(lattice)
    et, ep = _grow(lat, 1), _grow(lat, 2)
    if kind not in ("t", "ap"):
        raise ValueError(f"kind must be 't' or 'ap', got {kind!r}")
    # the computed array, the spinor it reads (at the site + 1) and u's offset
    out, src, u_off = (et, ep, 1) if kind == "t" else (lat, et, 2)
    m = _entry_mask(out, entries, device)
    units = [tuple(1 if d == mu else 0 for d in range(4)) for mu in range(4)]
    reads = _placed(m, src, 1, (0, 0, 0, 0))
    for e in units:
        reads |= _placed(m, src, 1, e) | _placed(m, src, 1, tuple(-v for v in e))
    u_site = _placed(m, ep, u_off, (0, 0, 0, 0))
    links = [(u_site | _placed(m, ep, u_off, tuple(-v for v in e)), range(18 * mu, 18 * mu + 18))
             for mu, e in enumerate(units)]
    return m, reads, links


def table_footprint(lattice, kind: str, entries: Sequence[Entry], device="cpu"):
    """(bytes, sectors) a table launch must move: each value it reads or
    writes once (:func:`table_reads`), in bytes, and the 32-byte sectors
    those values lie in (SoA fp32).  A thin box's sectors hold few of its
    values, so its sector bound (sectors x 32 B over the memory rate) says
    what the layout lets it reach."""
    m, reads, links = table_reads(lattice, kind, entries, device)
    nbytes = 4 * (24 * int(reads.sum()) + 24 * int(m.sum())
                  + sum(18 * int(link.sum()) for link, _ in links))
    sectors = _sectors([(reads, range(24))]) + _sectors([(m, range(24))]) + _sectors(links)
    return nbytes, sectors


def _oe(box):
    o, e = box
    return tuple(int(v) for v in o), tuple(int(v) for v in e)


def split_tables(lattice, interior, boundary) -> dict:
    """K5HO's four launches on the overlap split of ``lattice`` (the
    ``interior`` box and the ``boundary`` boxes, each (origin, extents)):
    {"interior t", "interior ap", "shell t", "boundary ap"} -> (kind,
    table entries), in launch order; the shell's and the boundary's
    T-slabs paired."""
    o, e = _oe(interior)
    shell = shell_boxes(lattice, o, e)
    return {"interior t": ("t", table_entries([(o, _grow(e, 1))])),
            "interior ap": ("ap", table_entries([(o, e)])),
            "shell t": ("t", pair_t_slabs(shell)),
            "boundary ap": ("ap", pair_t_slabs([_oe(b) for b in boundary]))}


def split_tiles(interior, boundary, tiles) -> dict:
    """The tiles of :func:`split_tables`' entries: {"interior ap",
    "boundary ap"} -> a tile (bx, by, bz) or None an entry, from ``tiles``,
    the sub-plan tile (0 a whole axis) or None of each box, the interior
    first (a paired entry takes its first slab's: the two slabs' sub-plans
    are alike).  The t tables' boxes (the grown interior, the shell) are
    no sub-launch's and run in the brick order."""
    def ext(box, tile):
        if tile is None:
            return None
        e = _oe(box)[1]
        return tuple(int(t) or n for t, n in zip(tile, e[:3]))

    bnd = [_oe(b) for b in boundary]
    return {"interior ap": [ext(interior, tiles[0])],
            "boundary ap": [ext(bnd[i], tiles[1 + i]) for _, i in _paired(bnd)]}


def _table(entries: Sequence[Entry], tiles=None):
    """The C table of ``entries`` (13 ints an entry: origin, extents,
    tsplit, tgap and the tile or 0 0 0), ``tiles`` each entry's tile or
    None; raises for more boxes than a launch takes."""
    if not 1 <= len(entries) <= HTAB_MAX:
        raise ValueError(f"a box table launch takes 1 to {HTAB_MAX} boxes, got {len(entries)}")
    tiles = list(tiles) if tiles is not None else [None] * len(entries)
    vals = [v for (o, e, ts, tg), tl in zip(entries, tiles)
            for v in (*o, *e, ts, tg, *(tl or (0, 0, 0)))]
    return (ctypes.c_int * len(vals))(*vals), len(entries)


def _t_box_plain(p_nd, u_nd, kappa, lat, org, ext):
    """t = g5(p - kappa D p) (24, *ext) on the ring-1 box at ``org``, from
    p and u over ``lat`` padded by 2 (canonical)."""
    sl = (slice(None),) + box_slices(_grow(lat, 1), org, ext, 1)
    pw, uw = p_nd[sl], u_nd[sl]
    return _m_g5(shifted_window(pw, (0, 0, 0, 0), 1, _DIMS4), _hop_box(pw, 1, uw, 1), kappa)


def _ap_box_plain(t_nd, u_nd, kappa, lat, org, ext):
    """ap = g5(t - kappa D t) (24, *ext) on the interior box at ``org``,
    from t over ``lat`` padded by 1 and u padded by 2 (canonical)."""
    tw = t_nd[(slice(None),) + box_slices(lat, org, ext, 1)]
    uw = u_nd[(slice(None),) + tuple(slice(a + 1, a + b + 3) for a, b in zip(org, ext))]
    return _m_g5(shifted_window(tw, (0, 0, 0, 0), 1, _DIMS4), _hop_box(tw, 1, uw, 1), kappa)


def _put(dst_nd, org, ext, val):
    dst_nd[(slice(None),) + tuple(slice(a, a + b) for a, b in zip(org, ext))] = val


def _tables_plain(p_h, u_h, kappa, lat, t_boxes, ap_boxes, t, ap):
    hl = _grow(lat, 2)
    p_nd, u_nd = p_h.reshape((24,) + hl), u_h.reshape((72,) + hl)
    t_nd = t.reshape((24,) + _grow(lat, 1))
    for o, e in t_boxes:
        _put(t_nd, o, e, _t_box_plain(p_nd, u_nd, kappa, lat, o, e))
    ap_nd = ap.reshape((24,) + lat)
    for o, e in ap_boxes:
        _put(ap_nd, o, e, _ap_box_plain(t_nd, u_nd, kappa, lat, o, e))


def _check_halo_operands(p_h, u_h, lat, t, ap):
    Vh = math.prod(_grow(lat, 2))
    check_tensor("p_h", p_h, (24, Vh), p_h.device)
    check_tensor("u_h", u_h, (72, Vh), p_h.device)
    check_tensor("t", t, (24, math.prod(_grow(lat, 1))), p_h.device)
    check_tensor("ap", ap, (24, math.prod(lat)), p_h.device)


def _launch_tables(p_h, u_h, kappa, lat, t_entries, ap_entries, t, ap, vvl, ap_tiles=None):
    """K5HO's two kernels on box tables: t on the ``t_entries`` boxes of
    the ring-1 array ``t``, then ap on the ``ap_entries`` boxes of the
    interior (``ap_tiles`` their tiles, tiled K5HO where one is set),
    written into ``ap``; one launch each.  CUDA tensors only."""
    _check_halo_operands(p_h, u_h, lat, t, ap)
    tt, nt = _table(t_entries)
    ta, na = _table(ap_entries, ap_tiles)
    WILSON_NORMAL_BOX_T.launch(p_h.device, p_h.data_ptr(), u_h.data_ptr(), t.data_ptr(),
                               float(kappa), *lat, tt, nt, vvl)
    ap_kernel = (WILSON_NORMAL_BOX_AP_TILED if ap_tiles and any(ap_tiles)
                 else WILSON_NORMAL_BOX_AP)
    ap_kernel.launch(p_h.device, t.data_ptr(), u_h.data_ptr(), ap.data_ptr(), float(kappa), *lat,
                     ta, na, vvl)
    return ap


def wilson_normal_pre_cuda(p_h: torch.Tensor, u_h: torch.Tensor, kappa: float, lattice,
                           vvl: int = 128, tile=None) -> torch.Tensor:
    """K5H: :func:`wilson_normal_pre_plain` in two launches (``vvl`` sites a
    block), t (24 x ring-1 box, SoA, fp32) between them; under ``tile``
    (bx, by, bz; 0 a whole axis) K5TH, the same two kernels walking the
    tile order."""
    if p_h.device.type == "cpu":
        return wilson_normal_pre_plain(p_h, u_h, kappa, lattice, tile)
    lat = _check_4d(lattice)
    t = torch.empty((24, math.prod(_grow(lat, 1))), dtype=p_h.dtype, device=p_h.device)
    ap = torch.empty((24, math.prod(lat)), dtype=p_h.dtype, device=p_h.device)
    _check_halo_operands(p_h, u_h, lat, t, ap)
    if tile is None:
        WILSON_NORMAL_PRE_T.launch(p_h.device, p_h.data_ptr(), u_h.data_ptr(), t.data_ptr(),
                                   float(kappa), *lat, vvl)
        WILSON_NORMAL_PRE_AP.launch(p_h.device, t.data_ptr(), u_h.data_ptr(), ap.data_ptr(),
                                    float(kappa), *lat, vvl)
        return ap
    ext = _check_tile(lat, tile)
    WILSON_NORMAL_PRE_T_TILED.launch(p_h.device, p_h.data_ptr(), u_h.data_ptr(), t.data_ptr(),
                                     float(kappa), *lat, *ext, vvl)
    WILSON_NORMAL_PRE_AP_TILED.launch(p_h.device, t.data_ptr(), u_h.data_ptr(), ap.data_ptr(),
                                      float(kappa), *lat, *ext, vvl)
    return ap


def wilson_normal_box_plain(p_h: torch.Tensor, u_h: torch.Tensor, kappa: float, lattice,
                            origin, extents) -> torch.Tensor:
    """ap (24, prod(extents)), SoA over the box, of the box at ``origin``
    (``extents`` sites a dim) of the interior ``lattice``, from p_h (24,
    Vh) and u_h (72, Vh) over the whole interior padded by 2: the "pre"
    lowering on the box's window (the box padded by 2), as the reference's
    sub-launch computes it."""
    lat = _check_4d(lattice)
    win = (slice(None),) + box_slices(lat, origin, extents, 2)
    hl = _grow(lat, 2)
    return wilson_normal_pre_plain(p_h.reshape((24,) + hl)[win], u_h.reshape((72,) + hl)[win],
                                   kappa, tuple(int(e) for e in extents))


def wilson_normal_interior_cuda(p_h: torch.Tensor, u_h: torch.Tensor, kappa: float, lattice,
                                interior, t: torch.Tensor, ap: torch.Tensor,
                                vvl: int = 128, tile=None) -> torch.Tensor:
    """K5HO's interior: t on the ``interior`` box ((origin, extents) of the
    interior ``lattice``) grown by 1 into the ring-1 array ``t``, then ap
    on the box into ``ap`` (24, V), one launch each, the ap launch's rows
    in the walk of ``tile`` (the box's sub-plan's; tiled K5HO) where given;
    it reads p only at owned sites where the interior is a split's.  On CPU
    tensors the plain version.  Returns ``ap``."""
    lat = _check_4d(lattice)
    o, e = _oe(interior)
    box_slices(lat, o, e)
    if p_h.device.type == "cpu":
        _tables_plain(p_h, u_h, kappa, lat, [(o, _grow(e, 1))], [(o, e)], t, ap)
        return ap
    tabs = split_tables(lat, (o, e), [])
    tiles = split_tiles((o, e), [], [tile])
    return _launch_tables(p_h, u_h, kappa, lat, tabs["interior t"][1], tabs["interior ap"][1], t,
                          ap, vvl, tiles["interior ap"])


def wilson_normal_boundary_cuda(p_h: torch.Tensor, u_h: torch.Tensor, kappa: float, lattice,
                                interior, boundary, t: torch.Tensor, ap: torch.Tensor,
                                vvl: int = 128, tiles=None) -> torch.Tensor:
    """K5HO's boundary, after :func:`wilson_normal_interior_cuda` on the same
    ``interior`` and ``t``: t on the shell (:func:`shell_boxes`), then ap on
    every ``boundary`` box, each kernel one launch over its table, the
    T-slabs paired (:func:`pair_t_slabs`), the ap rows of a box in the walk
    of its sub-plan's tile where ``tiles`` (one a box, or None) gives one
    (tiled K5HO).  On CPU tensors the plain version.  Returns ``ap``."""
    lat = _check_4d(lattice)
    o, e = _oe(interior)
    bnd = [_oe(b) for b in boundary]
    for bo, be in bnd:
        box_slices(lat, bo, be)
    if p_h.device.type == "cpu":
        _tables_plain(p_h, u_h, kappa, lat, shell_boxes(lat, o, e), bnd, t, ap)
        return ap
    tabs = split_tables(lat, (o, e), bnd)
    etiles = split_tiles((o, e), bnd, [None] + list(tiles or [None] * len(bnd)))
    return _launch_tables(p_h, u_h, kappa, lat, tabs["shell t"][1], tabs["boundary ap"][1], t,
                          ap, vvl, etiles["boundary ap"])


def wilson_normal_split_plain(p_h: torch.Tensor, u_h: torch.Tensor, kappa: float, lattice,
                              interior, boundary) -> torch.Tensor:
    """The box-table schedule in torch ops: t once into one ring-1 array
    (the interior's grown box, then the shell), ap on the interior, then on
    the boundary boxes; returns ap (24, V)."""
    lat = _check_4d(lattice)
    t = torch.full((24, math.prod(_grow(lat, 1))), float("nan"), dtype=p_h.dtype,
                   device=p_h.device)
    ap = torch.full((24, math.prod(lat)), float("nan"), dtype=p_h.dtype, device=p_h.device)
    o, e = _oe(interior)
    _tables_plain(p_h, u_h, kappa, lat, [(o, _grow(e, 1))], [(o, e)], t, ap)
    _tables_plain(p_h, u_h, kappa, lat, shell_boxes(lat, o, e), [_oe(b) for b in boundary], t,
                  ap)
    return ap

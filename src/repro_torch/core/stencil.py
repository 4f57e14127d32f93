"""Stencil helpers on canonical (ncomp, *lattice) views.

Single-shard (periodic) stencils use rolls and periodic halo padding; these
are the ``"torch"``-engine implementations and the plain versions the CUDA
stencil kernels are held against.  Convention: ``out(r) = in(r - disp)``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

__all__ = ["shift_periodic", "halo_pad", "halo_pad_physical", "interior", "shifted_window",
           "tile_boxes", "box_slices", "shell_order"]


def tile_boxes(lattice: Sequence[int], bx: int, by: int = 0,
               bz: int = 0) -> List[Tuple[Tuple[int, int], ...]]:
    """The tile cover of a tiled stencil lowering (``LoweringPlan``
    bx/by/bz): one box per tile, each a per-dim ``(start, extent)`` tuple
    over the interior lattice.  ``by``/``bz`` of 0 mean the whole axis;
    every extent must divide its dim, so the cover is exact and disjoint.
    The order is the tiled kernels' linear tile order: x-slab outermost,
    z-tiles fastest (tile t = (i * nty + j) * ntz + k)."""
    lattice = tuple(int(s) for s in lattice)
    exts = []
    for d, s in enumerate(lattice):
        if d == 0:
            exts.append(int(bx))
        elif d == 1 and by:
            exts.append(int(by))
        elif d == 2 and bz:
            exts.append(int(bz))
        else:
            exts.append(s)
    counts = []
    for d, e in enumerate(exts):
        if e <= 0 or lattice[d] % e:
            raise ValueError(
                f"tile extent {e} does not divide lattice[{d}]={lattice[d]}")
        counts.append(lattice[d] // e)
    boxes = []
    idx = [0] * len(lattice)
    for _ in range(math.prod(counts)):
        boxes.append(tuple((idx[d] * exts[d], exts[d]) for d in range(len(lattice))))
        for d in reversed(range(len(lattice))):  # z fastest
            idx[d] += 1
            if idx[d] < counts[d]:
                break
            idx[d] = 0
    return boxes


def shift_periodic(x_nd: torch.Tensor, disp: Sequence[int]) -> torch.Tensor:
    """Value at site r of the result = value at site (r - disp) of x (periodic).

    x_nd: (ncomp, *lattice); disp indexes the lattice dims."""
    out = x_nd
    for d, s in enumerate(disp):
        if s:
            out = torch.roll(out, shifts=int(s), dims=d + 1)
    return out


def halo_pad(x_nd: torch.Tensor, width: int, site_dims: Sequence[int]) -> torch.Tensor:
    """Pad with periodic wrap — the single-shard halo fill (numpy's
    ``mode="wrap"``: padded index i reads site (i - width) mod extent, for
    any width)."""
    out = x_nd
    for d in site_dims:
        n = out.shape[d]
        idx = torch.arange(-width, n + width, device=out.device) % n
        out = out.index_select(d, idx)
    return out


def halo_pad_physical(data: torch.Tensor, layout, ncomp: int, lattice: Sequence[int],
                      width: int) -> torch.Tensor:
    """Halo-pad a *physical* tensor by periodic wrap: the physical tensor
    over the padded lattice, in the same layout.  The padded sites
    re-linearize, so an AoSoA field is re-blocked over the padded site
    count, which must stay a multiple of SAL (``Layout.pack`` raises a
    ValueError otherwise; ``core.plan.block_view_ok`` states the alignment
    a block-view launch needs).

    The JAX package stages a block-view stencil launch's inputs through
    it.  Nothing in the port needs it: the cuda kernels read every layout
    in place through INDEX and wrap the lattice themselves, the torch
    engine pads canonical views, and the sharded path pads canonical
    views before its exchange (the block view under ``halo="pre"`` is
    still to be ported, ROADMAP item 24)."""
    if width < 1:
        return data
    lattice = tuple(int(s) for s in lattice)
    nd = layout.unpack(data).reshape((ncomp,) + lattice)
    padded = halo_pad(nd, width, range(1, nd.ndim))
    return layout.pack(padded.reshape(ncomp, -1))


def interior(x_halo: torch.Tensor, width: int, site_dims: Sequence[int]) -> torch.Tensor:
    """Strip halos back off."""
    idx = [slice(None)] * x_halo.ndim
    for d in site_dims:
        idx[d] = slice(width, x_halo.shape[d] - width)
    return x_halo[tuple(idx)]


def shifted_window(x_halo: torch.Tensor, disp: Sequence[int], width: int,
                   site_dims: Sequence[int]) -> torch.Tensor:
    """Interior-shaped window of a halo'd array displaced by -disp:
    out(r) = x(r - disp) for every interior site r.  Reads reach at most
    ``width`` into the halo, so max|disp| <= width (a view, no copy)."""
    idx = [slice(None)] * x_halo.ndim
    for d, dim in enumerate(site_dims):
        s = int(disp[d])
        if abs(s) > width:
            raise ValueError(f"|disp|={abs(s)} exceeds halo width {width}")
        idx[dim] = slice(width - s, x_halo.shape[dim] - width - s)
    return x_halo[tuple(idx)]


def box_slices(lattice: Sequence[int], origin: Sequence[int], extents: Sequence[int],
               ring: int = 0) -> Tuple[slice, ...]:
    """The site slices of a box of ``lattice`` (``origin`` and ``extents``
    per dim) grown by ``ring`` a side, in the coordinates of the lattice
    padded by ``ring`` (with ring 0: the box itself): the window a
    sub-launch over the box reads from a halo'd array.  Raises where the
    box does not lie inside the lattice."""
    lat, o, e = (tuple(int(v) for v in a) for a in (lattice, origin, extents))
    if (len(o) != len(lat) or len(e) != len(lat) or min(o) < 0 or min(e) < 1
            or any(a + b > L for a, b, L in zip(o, e, lat))):
        raise ValueError(f"box at origin {o} of extents {e} does not lie in lattice {lat}")
    return tuple(slice(a, a + b + 2 * ring) for a, b in zip(o, e))


def shell_order(extents: Sequence[int]) -> torch.Tensor:
    """The sites of a box's ring of width 1, as the walks of the "pre"
    kernels take them after the box (K9H's ``rt_k9h_ring_site``, K5TH's
    ``rt_ring1_shell_site``): each an index, linear over the box grown by 1
    (extents + 2), for each axis d in turn its lo face, then its hi one,
    each over the box's range of the axes before d and the grown range of
    the axes after it, the later axes fastest."""
    n = [int(e) for e in extents]
    g = [e + 2 for e in n]
    strides = [math.prod(g[k + 1:]) for k in range(len(g))]
    out = []
    for d in range(len(n)):
        axes = [torch.arange(1, n[k] + 1) if k < d else torch.arange(g[k])
                for k in range(len(n)) if k != d]
        grids = torch.meshgrid(*axes, indexing="ij") if axes else ()
        rest = sum((c.reshape(-1) * strides[k] for c, k in
                    zip(grids, [k for k in range(len(n)) if k != d])),
                   torch.zeros(1, dtype=torch.int64))
        for face in (0, n[d] + 1):
            out.append(rest + face * strides[d])
    return torch.cat(out)

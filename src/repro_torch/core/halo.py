"""Halo exchange over a mesh of ranks: the paper's MPI layer.

targetDP handles the parallelism inside a device; the paper composes it
with MPI halo exchange on a domain-decomposed lattice (§2.1, §5).  The JAX
package exchanges with ``lax.ppermute`` inside ``shard_map``; the port
runs one process a rank (``launch.mesh.Mesh``) and exchanges with
``torch.distributed`` point-to-point operations: NCCL between cards, gloo
on the CPU.

Arrays are a rank's local canonical views ``(ncomp, *local_lattice)``
whose site dims already include ``width`` halo slots at both ends of every
decomposed dimension.  :func:`exchange_dim` fills the two halo slabs of one
dimension in place: it copies the two interior slabs next to the halos
into contiguous buffers (a slab of a canonical view is not contiguous, and
gloo and NCCL send contiguous buffers), sends the high one forward and the
low one backward along the dimension's mesh axis in one
``batch_isend_irecv``, and writes what it receives into the halo slabs.  On
an axis of size 1 the neighbour is this rank and the copy is local, which
reproduces the periodic wrap (``halo_pad``).  :func:`exchange` runs the
dimensions in order, each pass sending slabs that carry the halos the
earlier passes filled, so edges and corners come out right.

:func:`exchange_padded` is the sharded drivers' ``exchange(pad(x))`` in
one pass: the block copied into a halo'd array once, every site dim's
halos then filled by the exchange, a dim that is not decomposed by the
self-exchange (its periodic wrap).  Its values are the wrap-pad's and the
exchange's; it skips the JAX package's full wrap-pad, a copy of the whole
array a site dim.

Not yet ported: ``exchange_field`` (the AoSoA-backed form), and
``exchange_boundary``, ``start_exchange`` and ``finish_exchange``, which
go with the overlap schedule (ROADMAP item 23).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["axis_perms", "exchange_dim", "exchange", "exchange_padded"]


def axis_perms(n: int):
    """Forward/backward neighbour permutations for a periodic 1-D rank line."""
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def exchange_dim(x: torch.Tensor, *, axis_name: str, axis_size: int, dim: int, width: int,
                 mesh=None) -> torch.Tensor:
    """Fill the two halo slabs of array dim ``dim`` of ``x`` in place from
    the neighbours along mesh axis ``axis_name`` (of ``axis_size`` ranks;
    ``mesh``, a ``launch.mesh.Mesh``, names them, and may be None where the
    axis has one rank); returns ``x``.

    The global topology is periodic (both applications use periodic
    boundaries at the decomposition level).  With axis_size == 1 the
    self-exchange reproduces the periodic wrap."""
    L = x.shape[dim]
    if L < 3 * width:
        # the interior (L - 2*width) is thinner than the halo: the "interior"
        # slabs below would overlap the halo slots and silently exchange
        # corrupt data — refuse instead (thicken the local extent by using
        # fewer ranks along this dim, or shrink the stencil ring)
        raise ValueError(
            f"halo exchange of dim {dim}: local halo'd extent {L} is too "
            f"thin for width {width} (interior {L - 2 * width} < width; "
            f"need extent >= {3 * width})")
    lo_interior = x.narrow(dim, width, width).contiguous()
    hi_interior = x.narrow(dim, L - 2 * width, width).contiguous()
    if axis_size == 1:
        recv_lo, recv_hi = hi_interior, lo_interior
    else:
        if mesh is None or mesh.shape.get(axis_name) != axis_size:
            raise ValueError(f"exchange along mesh axis {axis_name!r} of {axis_size} ranks "
                             f"needs the mesh that holds it, got {mesh!r}")
        fwd, bwd = mesh.neighbours(axis_name)
        recv_lo = torch.empty_like(hi_interior)
        recv_hi = torch.empty_like(lo_interior)
        # my high interior -> the forward neighbour's low halo; my low
        # interior -> the backward neighbour's high halo.  Every rank posts
        # the same order (NCCL matches a pair's messages by order, gloo by
        # tag), so an axis of 2, whose two neighbours are one rank, pairs
        # them right.
        ops = [dist.P2POp(dist.isend, hi_interior, fwd, tag=2 * dim),
               dist.P2POp(dist.isend, lo_interior, bwd, tag=2 * dim + 1),
               dist.P2POp(dist.irecv, recv_lo, bwd, tag=2 * dim),
               dist.P2POp(dist.irecv, recv_hi, fwd, tag=2 * dim + 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    x.narrow(dim, 0, width).copy_(recv_lo)
    x.narrow(dim, L - width, width).copy_(recv_hi)
    return x


def exchange(x: torch.Tensor, decomposed: Sequence[Tuple[int, str, int]], *, width: int,
             mesh=None) -> torch.Tensor:
    """Exchange the halos of every decomposed lattice dim of ``x`` in place
    and return it.

    decomposed: (array_dim, mesh_axis_name, mesh_axis_size) per decomposed
    dim (``lattice.Domain.decomposed``), exchanged in that order so that
    edge and corner halos become correct (each pass includes the halos the
    earlier ones filled, the dimension-by-dimension MPI idiom of the
    paper's applications)."""
    for dim, axis_name, axis_size in decomposed:
        exchange_dim(x, axis_name=axis_name, axis_size=axis_size, dim=dim, width=width,
                     mesh=mesh)
    return x


def exchange_padded(x: torch.Tensor, decomposed: Sequence[Tuple[int, str, int]], *, width: int,
                    mesh=None) -> torch.Tensor:
    """``exchange(halo_pad(x, width, every site dim), decomposed)`` as a new
    halo'd array: x (ncomp, *block) -> (ncomp, *(block + 2 width)), every
    halo from the neighbours along a decomposed dim and by the periodic
    wrap along the others, the dims in order (so edges and corners are
    those of the global periodic array)."""
    site_dims = range(1, x.dim())
    if any(x.shape[d] < width for d in site_dims):
        # a block thinner than the halo wraps more than once: pad, then exchange
        from .stencil import halo_pad
        return exchange(halo_pad(x, width, site_dims), decomposed, width=width, mesh=mesh)
    out = x.new_empty((x.shape[0],) + tuple(x.shape[d] + 2 * width for d in site_dims))
    inner = (slice(None),) + tuple(slice(width, x.shape[d] + width) for d in site_dims)
    out[inner] = x
    axes = {dim: (name, size) for dim, name, size in decomposed}
    for d in site_dims:
        name, size = axes.get(d, (None, 1))
        exchange_dim(out, axis_name=name, axis_size=size, dim=d, width=width, mesh=mesh)
    return out

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
an axis of size 1 the neighbour is this rank: each halo slab is copied
from the opposite interior slab in place, with no buffer, which
reproduces the periodic wrap (``halo_pad``).  :func:`exchange` runs the
dimensions in order, each pass sending slabs that carry the halos the
earlier passes filled, so edges and corners come out right.

:func:`exchange_padded` is the sharded drivers' ``exchange(pad(x))`` in
two steps.  :func:`fill_padded` copies the block into a halo'd array once
and wraps the dims that are not decomposed (the JAX package's wrap-pad,
less the decomposed dims' halos, which the exchange overwrites; it skips
the full wrap-pad, a copy of the whole array a site dim); :func:`exchange`
then fills the decomposed dims' halos.  Filling the undecomposed dims first
keeps edges and corners right, since each later slab carries their halos.

The overlap schedule (``core.overlap``) runs other work between the two:
:func:`start_exchange` exchanges the decomposed dims in order and
:func:`finish_exchange` hands the array over where its halos are read.  On
the card the exchange runs on a side CUDA stream of high priority (the
slab copies, or NCCL's point-to-point operations), which waits only for
an event the caller recorded after the fill (:func:`fill_event`), so the
work issued on the current stream since then, which reads only owned sites
(the interior sub-launch, issued before the copies so that it is on the
card first), runs beside it.  An event marks the exchange's end, which
:func:`finish_exchange` makes the current stream wait for.  The array is
recorded on the side stream (``Tensor.record_stream``), so that the
caching allocator cannot reuse it before the exchange is done.  On the CPU
(gloo) both are synchronous, in the same order.

:func:`exchange_field` exchanges a Field on the halo'd lattice through its
canonical view and returns a Field in the same layout (in place where the
layout is SoA, whose canonical view is the data); :func:`exchange_boundary`
exchanges only the listed dims.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["axis_perms", "exchange_dim", "exchange", "exchange_padded", "fill_padded",
           "exchange_field", "exchange_boundary", "PendingExchange", "fill_event",
           "start_exchange", "finish_exchange"]


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
    if axis_size == 1:
        # the neighbour is this rank: the periodic wrap, slab to slab in
        # place (the slabs are disjoint, as L >= 3 width), with no buffer
        x.narrow(dim, 0, width).copy_(x.narrow(dim, L - 2 * width, width))
        x.narrow(dim, L - width, width).copy_(x.narrow(dim, width, width))
        return x
    if mesh is None or mesh.shape.get(axis_name) != axis_size:
        raise ValueError(f"exchange along mesh axis {axis_name!r} of {axis_size} ranks "
                         f"needs the mesh that holds it, got {mesh!r}")
    lo_interior = x.narrow(dim, width, width).contiguous()
    hi_interior = x.narrow(dim, L - 2 * width, width).contiguous()
    fwd, bwd = mesh.neighbours(axis_name)
    recv_lo = torch.empty_like(hi_interior)
    recv_hi = torch.empty_like(lo_interior)
    # my high interior -> the forward neighbour's low halo; my low
    # interior -> the backward neighbour's high halo.  Every rank posts the
    # same order (NCCL matches a pair's messages by order, gloo by tag), so
    # an axis of 2, whose two neighbours are one rank, pairs them right.
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
    wrap along the others (:func:`fill_padded`, then :func:`exchange`), so
    edges and corners are those of the global periodic array."""
    return exchange(fill_padded(x, decomposed, width=width), decomposed, width=width, mesh=mesh)


def fill_padded(x: torch.Tensor, decomposed: Sequence[Tuple[int, str, int]], *,
                width: int) -> torch.Tensor:
    """The first half of :func:`exchange_padded`: x (ncomp, *block) copied
    into a new halo'd array (ncomp, *(block + 2 width)) whose halos along
    every site dim that is not in ``decomposed`` hold the periodic wrap.
    The decomposed dims' halos are left for :func:`start_exchange` (they
    hold whatever the allocation held; no launch reads them before the
    exchange has filled them)."""
    site_dims = range(1, x.dim())
    if any(x.shape[d] < width for d in site_dims):
        # a block thinner than the halo wraps more than once: the full wrap-pad
        from .stencil import halo_pad
        return halo_pad(x, width, site_dims)
    out = x.new_empty((x.shape[0],) + tuple(x.shape[d] + 2 * width for d in site_dims))
    inner = (slice(None),) + tuple(slice(width, x.shape[d] + width) for d in site_dims)
    out[inner] = x
    exchanged = {dim for dim, _, _ in decomposed}
    for d in site_dims:
        if d not in exchanged:
            exchange_dim(out, axis_name=None, axis_size=1, dim=d, width=width)
    return out


def exchange_field(f, decomposed: Sequence[Tuple[int, str, int]], *, width: int, mesh=None):
    """Exchange a :class:`~repro_torch.core.field.Field` whose lattice is
    the halo'd local lattice, returning a Field in the same layout: the
    exchange runs on the canonical view, which is packed back into the
    layout (for SoA the canonical view is the data, so the Field is
    exchanged in place).  With ``width`` 0 or no decomposed dims the Field
    is returned as it is."""
    if width < 1 or not decomposed:
        return f
    nd = exchange(f.canonical_nd(), decomposed, width=width, mesh=mesh)
    return f.with_canonical(nd.reshape(f.ncomp, -1))


def exchange_boundary(x: torch.Tensor, decomposed: Sequence[Tuple[int, str, int]], *,
                      width: int, dims: Optional[Sequence[int]] = None,
                      mesh=None) -> torch.Tensor:
    """Fill only the halos of the listed array dims (``dims``; None: every
    decomposed dim, :func:`exchange`), in decomposition order, in place;
    returns ``x``."""
    wanted = None if dims is None else set(dims)
    for dim, axis_name, axis_size in decomposed:
        if wanted is not None and dim not in wanted:
            continue
        exchange_dim(x, axis_name=axis_name, axis_size=axis_size, dim=dim, width=width,
                     mesh=mesh)
    return x


@dataclasses.dataclass(frozen=True)
class PendingExchange:
    """A started exchange (:func:`start_exchange`): the array being filled
    and, on the card, the event recorded on the side stream after its last
    copy (None where the exchange already ran)."""

    array: torch.Tensor
    event: Optional[object] = None


_SIDE_STREAMS = {}


def _side_stream(device: torch.device):
    """The device's side stream, made once: of high priority, so that its
    copies' blocks go ahead of the pending blocks of the kernel running
    beside them, and the same stream every exchange, so that the caching
    allocator, which hands a freed block back only to the stream that
    freed it, reuses its buffers instead of allocating anew (a pool stream
    a call would allocate every time, and an allocation may wait for the
    card)."""
    key = (device.type, device.index if device.index is not None
           else torch.cuda.current_device())
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device=device, priority=-1)
    return _SIDE_STREAMS[key]


def fill_event(x: torch.Tensor):
    """An event recorded on the current stream of a CUDA tensor's device,
    marking the work issued so far (the fill); None on the CPU."""
    if x.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x.device))
    return event


def start_exchange(x: torch.Tensor, decomposed: Sequence[Tuple[int, str, int]], *, width: int,
                   mesh=None, after=None) -> PendingExchange:
    """Begin the dimension-ordered exchange of ``x`` (:func:`exchange`) and
    return its handle; consume it with :func:`finish_exchange` where the
    exchanged halos are read.  On a CUDA tensor the exchange is issued on
    the side stream, which first waits for ``after`` (a :func:`fill_event`;
    None: everything already on the current stream), so that the work on
    the current stream after that event runs beside it; on the CPU it runs
    here."""
    if x.device.type != "cuda" or width < 1 or not decomposed:
        return PendingExchange(exchange(x, decomposed, width=width, mesh=mesh))
    side = _side_stream(x.device)
    if after is None:
        side.wait_stream(torch.cuda.current_stream(x.device))
    else:
        side.wait_event(after)
    with torch.cuda.stream(side):
        exchange(x, decomposed, width=width, mesh=mesh)
        event = torch.cuda.Event()
        event.record(side)
    # x was made on the current stream and is written on the side one
    x.record_stream(side)
    return PendingExchange(x, event)


def finish_exchange(pending: PendingExchange) -> torch.Tensor:
    """The exchanged array of a :func:`start_exchange` handle; on the card
    the current stream first waits for the side stream's copies."""
    if pending.event is not None:
        torch.cuda.current_stream(pending.array.device).wait_event(pending.event)
    return pending.array

"""Domain decomposition of a global lattice over a mesh of ranks.

The paper's applications decompose the lattice across MPI ranks with halo
regions (§2.1).  :class:`Domain` carries that geometry: which lattice dims
map to which mesh axes (``launch.mesh.Mesh``), the local shapes and the
halo width.  The JAX package's ``spec()`` and ``sharding()`` place a global
array on its mesh; a rank of the port holds its own block instead:
:meth:`Domain.scatter` cuts it from a global array every rank holds, and
:meth:`Domain.gather` assembles the global array on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import halo as _halo

__all__ = ["Domain"]


@dataclasses.dataclass(frozen=True)
class Domain:
    """Geometry of a decomposed lattice.

    global_shape   full lattice, e.g. (nx, ny, nz)
    mesh           a ``launch.mesh.Mesh`` (None: one rank)
    dim_axes       per lattice dim: mesh axis name or None (not decomposed)
    halo           halo width (max stencil reach; 1 for D3Q19 & Wilson)
    """

    global_shape: Tuple[int, ...]
    mesh: Optional[object] = None
    dim_axes: Tuple[Optional[str], ...] = ()
    halo: int = 1

    def __post_init__(self):
        if self.dim_axes and len(self.dim_axes) != len(self.global_shape):
            raise ValueError("dim_axes must match lattice rank")

    # -- shapes ----------------------------------------------------------------

    def axis_size(self, name: Optional[str]) -> int:
        if name is None or self.mesh is None:
            return 1
        return self.mesh.shape[name]

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """Per-rank interior shape (no halos)."""
        out = []
        for d, n in enumerate(self.global_shape):
            ax = self.dim_axes[d] if self.dim_axes else None
            size = self.axis_size(ax)
            if n % size:
                raise ValueError(
                    f"lattice dim {d} ({n}) not divisible by mesh axis "
                    f"{ax} ({size})"
                )
            out.append(n // size)
        return tuple(out)

    @property
    def local_shape_halo(self) -> Tuple[int, ...]:
        return tuple(
            n + 2 * self.halo if (self.dim_axes and self.dim_axes[d]) else n
            for d, n in enumerate(self.local_shape)
        )

    @property
    def decomposed(self) -> Tuple[Tuple[int, str, int], ...]:
        """(array_dim_in_canonical_nd, mesh_axis, size) per decomposed dim.

        array dim is offset by 1 for the leading component axis.
        """
        out = []
        for d, ax in enumerate(self.dim_axes or ()):
            if ax is not None:
                out.append((d + 1, ax, self.axis_size(ax)))
        return tuple(out)

    # -- this rank's block -------------------------------------------------------

    def _block(self, coords) -> Tuple[slice, ...]:
        """The global site slices of the block at mesh coordinates coords."""
        loc = self.local_shape
        idx = [slice(None)] * len(self.global_shape)
        for dim, ax, _ in self.decomposed:
            c = coords[self.mesh.axis_index(ax)]
            idx[dim - 1] = slice(c * loc[dim - 1], (c + 1) * loc[dim - 1])
        return (slice(None),) + tuple(idx)

    def scatter(self, global_nd: torch.Tensor) -> torch.Tensor:
        """This rank's block (ncomp, *local_shape) of a global canonical
        (ncomp, *global_shape) array that every rank holds, as a contiguous
        copy."""
        if tuple(global_nd.shape[1:]) != tuple(self.global_shape):
            raise ValueError(f"scatter: array lattice {tuple(global_nd.shape[1:])}, domain "
                             f"{tuple(self.global_shape)}")
        if self.mesh is None:
            return global_nd.clone()
        return global_nd[self._block(self.mesh.coords)].contiguous()

    def gather(self, local_nd: torch.Tensor) -> torch.Tensor:
        """The global (ncomp, *global_shape) array assembled from every
        rank's (ncomp, *local_shape) block, on every rank (an all-gather
        over the mesh)."""
        if tuple(local_nd.shape[1:]) != self.local_shape:
            raise ValueError(f"gather: block lattice {tuple(local_nd.shape[1:])}, local shape "
                             f"{self.local_shape}")
        if self.mesh is None or self.mesh.size == 1:
            return local_nd.clone()
        local_nd = local_nd.contiguous()
        blocks = [torch.empty_like(local_nd) for _ in range(self.mesh.size)]
        dist.all_gather(blocks, local_nd)
        out = local_nd.new_empty((local_nd.shape[0],) + tuple(self.global_shape))
        for r, blk in enumerate(blocks):
            out[self._block(self.mesh.coords_of(r))] = blk
        return out

    # -- halo ops ------------------------------------------------------------------

    def exchange(self, x_local: torch.Tensor) -> torch.Tensor:
        """Fill the halos of a local (ncomp, *local_shape_halo) array (in
        place; returns it)."""
        return _halo.exchange(x_local, self.decomposed, width=self.halo, mesh=self.mesh)

    def add_halo(self, x_local: torch.Tensor) -> torch.Tensor:
        """Interior -> halo'd local array (halo values zero until
        exchange)."""
        pads = []
        for d in reversed(range(1, x_local.ndim)):
            w = self.halo if any(dim == d for dim, _, _ in self.decomposed) else 0
            pads += [w, w]
        return torch.nn.functional.pad(x_local, pads)

    def strip_halo(self, x_local: torch.Tensor) -> torch.Tensor:
        idx = [slice(None)] * x_local.ndim
        for dim, _, _ in self.decomposed:
            idx[dim] = slice(self.halo, x_local.shape[dim] - self.halo)
        return x_local[tuple(idx)]

    @property
    def nsites_local(self) -> int:
        return math.prod(self.local_shape)

    @property
    def nsites_global(self) -> int:
        return math.prod(self.global_shape)

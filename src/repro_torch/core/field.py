"""Field: a multi-valued lattice quantity stored in a configurable Layout.

A Field is ``ncomp`` components at every site of a lattice, physically
stored per its Layout (paper §3.1) in a ``torch.Tensor`` on some device.
Kernels (core.target) consume and produce Fields; a kernel body only ever
sees canonical ``(ncomp, sites)`` tensors.  A :class:`BatchedField` stacks
independent same-shape Fields on a leading batch axis (the serving path's
slots).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from .layout import Layout, SOA

__all__ = ["Field", "BatchedField", "resolve_device", "backend_name"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and no card is
    present: a caller that wants the CPU asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"false; pass device='cpu' (e.g. TargetConfig('torch', "
            f"device='cpu')) to run on the CPU")
    return dev


def backend_name(device) -> str:
    """The backend a launch on ``device`` runs on, as the tune table names
    it: the CUDA device's name (``torch.cuda.get_device_name``, asked once
    a device), or the device type ("cpu")."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return _cuda_device_name(torch.cuda.current_device() if dev.index is None else dev.index)


@functools.lru_cache(maxsize=None)
def _cuda_device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


@dataclasses.dataclass
class Field:
    """ncomp values per site on a lattice, in a given physical layout.

    data      physical tensor, shape == layout.physical_shape(ncomp, nsites)
    lattice   site-space shape, e.g. (nx, ny, nz, nt); nsites = prod(lattice)
    """

    name: str
    ncomp: int
    lattice: Tuple[int, ...]
    layout: Layout
    data: torch.Tensor

    @classmethod
    def from_canonical(cls, name, canonical, lattice, layout=SOA):
        """canonical: (ncomp, *lattice) or (ncomp, nsites) tensor."""
        ncomp = canonical.shape[0]
        flat = canonical.reshape(ncomp, math.prod(lattice))
        return cls(name, ncomp, tuple(lattice), layout, layout.pack(flat))

    @classmethod
    def from_numpy(cls, name, array_cs, lattice, layout=SOA,
                   dtype=torch.float32, device="cpu"):
        """Upload a canonical numpy array to ``device`` in ``layout``."""
        t = torch.from_numpy(np.ascontiguousarray(array_cs)).to(dtype)
        return cls.from_canonical(name, t.to(resolve_device(device)),
                                  lattice, layout)

    @property
    def nsites(self) -> int:
        return math.prod(self.lattice)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def canonical(self) -> torch.Tensor:
        """(ncomp, nsites) logical view (layout-independent)."""
        return self.layout.unpack(self.data)

    def canonical_nd(self) -> torch.Tensor:
        """(ncomp, *lattice) logical view — stencil/geometry operations."""
        return self.canonical().reshape((self.ncomp,) + self.lattice)

    def to_numpy(self) -> np.ndarray:
        return self.canonical_nd().detach().cpu().numpy()

    def with_data(self, data: torch.Tensor) -> "Field":
        """This Field holding ``data``, which must already be in this
        Field's layout: its shape must be ``layout.physical_shape(ncomp,
        nsites)`` (a tensor in another layout raises instead of being
        mislabelled)."""
        want = self.layout.physical_shape(self.ncomp, self.nsites)
        if tuple(data.shape) != want:
            raise ValueError(
                f"Field {self.name!r}: data of shape {tuple(data.shape)} is not "
                f"in its layout {self.layout.name} (physical shape {want})")
        return dataclasses.replace(self, data=data)

    def with_canonical(self, canonical: torch.Tensor) -> "Field":
        flat = canonical.reshape(self.ncomp, self.nsites)
        return dataclasses.replace(self, data=self.layout.pack(flat))

    def as_layout(self, layout: Layout) -> "Field":
        """Relayout (the paper's per-architecture layout switch): the same
        values in ``layout``, repacked with torch ops on the Field's
        device.  Set-up, not a kernel: no launch path calls it."""
        if layout == self.layout:
            return self
        return dataclasses.replace(self, layout=layout, data=layout.pack(self.canonical()))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"Field({self.name!r}, ncomp={self.ncomp}, lattice={self.lattice}, "
            f"layout={self.layout.name}, dtype={self.dtype}, "
            f"device={self.device})"
        )


@dataclasses.dataclass
class BatchedField:
    """A stack of ``batch`` independent same-shape Fields on one leading axis.

    data has shape ``(batch,) + layout.physical_shape(ncomp, nsites)``:
    every batch element is an ordinary Field's physical tensor, so
    ``element(b)`` / ``unstack()`` round-trip bitwise.  The serving layer
    (launch.serve) packs many solves into one of these, and a fused launch
    runs the whole stack through one kernel with the slot as a grid axis
    (core.fuse).  Updates are functional, as in the JAX package: ``with_*``
    return a new BatchedField and never write into ``data``.
    """

    name: str
    batch: int
    ncomp: int
    lattice: Tuple[int, ...]
    layout: Layout
    data: torch.Tensor

    @classmethod
    def stack(cls, fields, name=None):
        """Stack same-(ncomp, lattice, layout) Fields along a new batch axis."""
        fields = list(fields)
        if not fields:
            raise ValueError("BatchedField.stack needs at least one Field")
        f0 = fields[0]
        for f in fields[1:]:
            if (f.ncomp, f.lattice, f.layout) != (f0.ncomp, f0.lattice, f0.layout):
                raise ValueError(
                    f"cannot stack {f!r} with {f0!r}: batch elements must "
                    f"share ncomp, lattice and layout")
        return cls(name or f0.name, len(fields), f0.ncomp, f0.lattice, f0.layout,
                   torch.stack([f.data for f in fields]))

    @classmethod
    def zeros(cls, name, batch, ncomp, lattice, layout=SOA, dtype=torch.float32,
              device="cpu"):
        shape = (batch,) + layout.physical_shape(ncomp, math.prod(lattice))
        return cls(name, batch, ncomp, tuple(lattice), layout,
                   torch.zeros(shape, dtype=dtype, device=resolve_device(device)))

    @classmethod
    def from_canonical(cls, name, canonical, lattice, layout=SOA):
        """canonical: (batch, ncomp, *lattice) or (batch, ncomp, nsites) tensor."""
        batch, ncomp = canonical.shape[:2]
        flat = canonical.reshape(batch, ncomp, math.prod(lattice))
        return cls(name, batch, ncomp, tuple(lattice), layout,
                   torch.stack([layout.pack(c) for c in flat]))

    @property
    def nsites(self) -> int:
        return math.prod(self.lattice)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def element(self, b: int) -> Field:
        """Batch element ``b`` as an ordinary Field (a view of the stacked
        data, bitwise)."""
        return Field(f"{self.name}[{b}]", self.ncomp, self.lattice, self.layout,
                     self.data[b])

    def unstack(self):
        return [self.element(b) for b in range(self.batch)]

    def canonical(self) -> torch.Tensor:
        """(batch, ncomp, nsites) logical values (layout-independent)."""
        return torch.stack([self.layout.unpack(d) for d in self.data])

    def canonical_nd(self) -> torch.Tensor:
        """(batch, ncomp, *lattice) logical values."""
        return self.canonical().reshape((self.batch, self.ncomp) + self.lattice)

    def to_numpy(self) -> np.ndarray:
        return self.canonical_nd().detach().cpu().numpy()

    def with_data(self, data: torch.Tensor) -> "BatchedField":
        """This BatchedField holding ``data``, which must already be in its
        layout: shape ``(batch,) + layout.physical_shape(ncomp, nsites)``."""
        want = (self.batch,) + self.layout.physical_shape(self.ncomp, self.nsites)
        if tuple(data.shape) != want:
            raise ValueError(
                f"BatchedField {self.name!r}: data of shape {tuple(data.shape)} is "
                f"not {self.batch} fields in its layout {self.layout.name} "
                f"(physical shape {want})")
        return dataclasses.replace(self, data=data)

    def with_element(self, b: int, field: Field) -> "BatchedField":
        """Replace batch slot ``b`` with a Field's values (relayout to this
        stack's layout first); every other slot's bits are copied unchanged."""
        if (field.ncomp, field.lattice) != (self.ncomp, self.lattice):
            raise ValueError(
                f"cannot put {field!r} into slot {b} of {self!r}: ncomp and "
                f"lattice must match")
        data = self.data.clone()
        data[b] = field.as_layout(self.layout).data
        return dataclasses.replace(self, data=data)

    def as_layout(self, layout: Layout) -> "BatchedField":
        """The same values in ``layout``, repacked slot by slot with torch
        ops (set-up, not a kernel)."""
        if layout == self.layout:
            return self
        return dataclasses.replace(
            self, layout=layout,
            data=torch.stack([layout.pack(self.layout.unpack(d)) for d in self.data]))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"BatchedField({self.name!r}, batch={self.batch}, ncomp={self.ncomp}, "
            f"lattice={self.lattice}, layout={self.layout.name}, dtype={self.dtype}, "
            f"device={self.device})"
        )

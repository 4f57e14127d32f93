"""Carry Field state between the JAX package and the port.

A Field crosses as plain numpy data: its physical array, lattice, layout
name and ncomp.  Physical shapes are the same in both packages, so the
numbers pass through unchanged (bitwise).  This module does not import the
JAX package: a caller holding a JAX Field passes ``np.asarray(f.data)``,
``f.lattice``, ``f.layout.name`` and ``f.ncomp``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.field import Field, resolve_device
from repro_torch.core.layout import parse_layout

__all__ = ["to_field", "from_field"]


def to_field(name: str, physical: np.ndarray, lattice: Sequence[int],
             layout_name: str, ncomp: int, device="cpu") -> Field:
    """The port's Field holding ``physical`` (bitwise) on ``device``."""
    layout = parse_layout(layout_name)
    lattice = tuple(int(s) for s in lattice)
    want = layout.physical_shape(int(ncomp), math.prod(lattice))
    physical = np.asarray(physical)
    if physical.shape != want:
        raise ValueError(
            f"{name}: physical shape {physical.shape} does not match layout "
            f"{layout.name} with ncomp={ncomp} on lattice {lattice} ({want})")
    data = torch.from_numpy(np.array(physical, copy=True))
    return Field(name, int(ncomp), lattice, layout, data.to(resolve_device(device)))


def from_field(field: Field) -> Tuple[np.ndarray, Tuple[int, ...], str, int]:
    """(physical array, lattice, layout name, ncomp) of a port Field."""
    return (field.data.detach().cpu().numpy(), field.lattice, field.layout.name,
            field.ncomp)

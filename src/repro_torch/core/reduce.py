"""Lattice-wide reductions (paper §3.2.3, ``targetDoubleSum`` et al.).

A per-component sum or max over all sites of a Field.  The torch engine
folds the canonical tensor; the cuda engine runs K2 (``csrc/reduce.cu``),
which replaces ``core/reduce.py::_reduce`` of the JAX package: pass 1
reads the Field in its own layout (SoA, AoS or AoSoA, through INDEX) and
writes per-block partial rows, pass 2 folds them in a fixed order.  A
block folds the same sites in the same order in every layout, so the sums
are bitwise the SoA ones.  The Pallas kernel's "initialise at program 0,
then read-modify-write across the grid" is a race on concurrent CUDA
blocks and is not carried over; there are no atomics, so a fixed plan
gives the same bits on every run, and max is exact.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._cuda import Kernel, check_field, check_tensor
from .layout import resolve_layouts
from .plan import plan_for_launch
from .target import TargetConfig, require_cuda

__all__ = ["target_sum", "target_max", "reduce_sites", "fold_partials",
           "REDUCE_SUM", "REDUCE_MAX", "REDUCE_FOLD"]

_OPS = {"sum": 0, "max": 1}

REDUCE_SUM = Kernel("reduce_sum", "rt_reduce_partials")
REDUCE_MAX = Kernel("reduce_max", "rt_reduce_partials")
REDUCE_FOLD = Kernel("reduce_fold", "rt_reduce_fold")


def reduce_plain(x: torch.Tensor, op: str, dim: int = 1) -> torch.Tensor:
    return x.sum(dim=dim) if op == "sum" else x.amax(dim=dim)


def fold_partials(partials: torch.Tensor, op: str) -> torch.Tensor:
    """K2 pass 2: (nblocks, ncomp) partial rows -> (ncomp,), folded in a
    fixed order."""
    if op not in _OPS:
        raise ValueError(f"unknown reduction op {op!r}; have {list(_OPS)}")
    if partials.device.type == "cpu":
        return reduce_plain(partials, op, dim=0)
    check_tensor("partials", partials, partials.shape, partials.device)
    nblocks, ncomp = partials.shape
    out = torch.empty(ncomp, dtype=partials.dtype, device=partials.device)
    REDUCE_FOLD.launch(partials.device, partials.data_ptr(), out.data_ptr(),
                       nblocks, ncomp, _OPS[op])
    return out


def reduce_sites(x: torch.Tensor, op: str, vvl: int = 128, *, layouts=None) -> torch.Tensor:
    """K2: a field ``x`` (physical, in ``layouts["x"]``, SoA when not
    named) -> per-component sum or max, (ncomp,)."""
    if op not in _OPS:
        raise ValueError(f"unknown reduction op {op!r}; have {list(_OPS)}")
    lay = resolve_layouts(layouts, ("x",), ())["x"]
    if x.device.type == "cpu":
        return reduce_plain(lay.unpack(x), op)
    ncomp, nsites = lay.logical_shape(x.shape)
    lx = check_field("x", x, lay, ncomp, nsites, x.device)
    partials = torch.empty((-(-nsites // vvl), ncomp), dtype=x.dtype, device=x.device)
    kern = REDUCE_SUM if op == "sum" else REDUCE_MAX
    kern.launch(x.device, x.data_ptr(), partials.data_ptr(), ncomp, nsites,
                _OPS[op], lx, vvl)
    return fold_partials(partials, op)


def _reduce(field, config: Optional[TargetConfig], op: str) -> torch.Tensor:
    config = config or TargetConfig()
    plan = plan_for_launch(config, field.nsites, [field.layout])
    if plan.engine == "torch":
        return reduce_plain(field.canonical(), op)
    require_cuda(f"field {field.name!r}", field.data)
    return reduce_sites(field.data, op, plan.vvl, layouts={"x": field.layout})


def target_sum(field, config: Optional[TargetConfig] = None) -> torch.Tensor:
    """targetDoubleSum: per-component sum over all local lattice sites."""
    return _reduce(field, config, "sum")


def target_max(field, config: Optional[TargetConfig] = None) -> torch.Tensor:
    """Per-component max over all local lattice sites."""
    return _reduce(field, config, "max")

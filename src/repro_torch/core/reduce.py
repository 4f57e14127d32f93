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

A BatchedField reduces to ``(batch, ncomp)``, each row bitwise the
single-Field reduction of its slot: on "cuda" through K2B, K2 with the slot
as a grid axis (the same kernels, so the same fold per row); on "torch" by
folding each slot as the single path folds it (the bits of one
``torch.sum`` over a ``(batch, ncomp, nsites)`` tensor are not promised to
equal those of each ``(ncomp, nsites)`` row).

:func:`fold_components` is the fixed-order fold of per-component sums into
one number that every inner product of the solvers uses, single and
batched alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._cuda import Kernel, check_batched_field, check_field, check_tensor
from .field import BatchedField
from .layout import resolve_layouts
from .plan import plan_for_launch
from .target import TargetConfig, require_cuda

__all__ = ["target_sum", "target_max", "reduce_sites", "fold_partials",
           "reduce_sites_batched", "fold_partials_batched", "fold_components",
           "REDUCE_SUM", "REDUCE_MAX", "REDUCE_FOLD", "REDUCE_SUM_B", "REDUCE_MAX_B",
           "REDUCE_FOLD_B"]

_OPS = {"sum": 0, "max": 1}

REDUCE_SUM = Kernel("reduce_sum", "rt_reduce_partials")
REDUCE_MAX = Kernel("reduce_max", "rt_reduce_partials")
REDUCE_FOLD = Kernel("reduce_fold", "rt_reduce_fold")
REDUCE_SUM_B = Kernel("reduce_sum_batched", "rt_reduce_partials_batched")
REDUCE_MAX_B = Kernel("reduce_max_batched", "rt_reduce_partials_batched")
REDUCE_FOLD_B = Kernel("reduce_fold_batched", "rt_reduce_fold_batched")


def reduce_plain(x: torch.Tensor, op: str, dim: int = 1) -> torch.Tensor:
    return x.sum(dim=dim) if op == "sum" else x.amax(dim=dim)


def _check_op(op: str) -> None:
    if op not in _OPS:
        raise ValueError(f"unknown reduction op {op!r}; have {list(_OPS)}")


def fold_components(v: torch.Tensor) -> torch.Tensor:
    """Per-component sums ``(..., ncomp)`` -> ``(...)``, folded in one fixed
    order: halve the last axis pairwise (an odd last element carried) until
    one value is left.  Every step is an elementwise add, so each row's bits
    do not depend on the leading shape.  The single and the batched solvers
    both fold their inner products through it, so a slot's alpha and beta
    are the single solve's bits (``v.sum(-1)`` on a (24,) and on a (B, 24)
    tensor is not promised to agree on CUDA)."""
    while v.shape[-1] > 1:
        n = v.shape[-1]
        h = n // 2
        head = v[..., :h] + v[..., h:2 * h]
        v = torch.cat([head, v[..., 2 * h:]], dim=-1) if n % 2 else head
    return v[..., 0]


def fold_partials(partials: torch.Tensor, op: str) -> torch.Tensor:
    """K2 pass 2: (nblocks, ncomp) partial rows -> (ncomp,), folded in a
    fixed order."""
    _check_op(op)
    if partials.device.type == "cpu":
        return reduce_plain(partials, op, dim=0)
    check_tensor("partials", partials, partials.shape, partials.device)
    nblocks, ncomp = partials.shape
    out = torch.empty(ncomp, dtype=partials.dtype, device=partials.device)
    REDUCE_FOLD.launch(partials.device, partials.data_ptr(), out.data_ptr(),
                       nblocks, ncomp, _OPS[op])
    return out


def fold_partials_batched(partials: torch.Tensor, op: str) -> torch.Tensor:
    """K2B pass 2: (batch, nblocks, ncomp) partial rows -> (batch, ncomp),
    row b folded as :func:`fold_partials` folds slot b's table."""
    _check_op(op)
    if partials.device.type == "cpu":
        return torch.stack([reduce_plain(p, op, dim=0) for p in partials])
    check_tensor("partials", partials, partials.shape, partials.device)
    batch, nblocks, ncomp = partials.shape
    out = torch.empty((batch, ncomp), dtype=partials.dtype, device=partials.device)
    REDUCE_FOLD_B.launch(partials.device, partials.data_ptr(), out.data_ptr(), nblocks, ncomp,
                         batch, _OPS[op])
    return out


def reduce_sites_batched(x: torch.Tensor, op: str, vvl: int = 128, *,
                         layouts=None) -> torch.Tensor:
    """K2B: ``batch`` fields stacked on a leading axis (a BatchedField's
    data, each in ``layouts["x"]``) -> per-slot, per-component sum or max,
    (batch, ncomp), each row bitwise :func:`reduce_sites` of its slot."""
    _check_op(op)
    lay = resolve_layouts(layouts, ("x",), ())["x"]
    if x.device.type == "cpu":
        return torch.stack([reduce_plain(lay.unpack(e), op) for e in x])
    batch = x.shape[0]
    ncomp, nsites = lay.logical_shape(x.shape[1:])
    lx = check_batched_field("x", x, lay, ncomp, nsites, batch, x.device)
    partials = torch.empty((batch, -(-nsites // vvl), ncomp), dtype=x.dtype, device=x.device)
    kern = REDUCE_SUM_B if op == "sum" else REDUCE_MAX_B
    kern.launch(x.device, x.data_ptr(), partials.data_ptr(), ncomp, nsites, batch, _OPS[op],
                lx, vvl)
    return fold_partials_batched(partials, op)


def reduce_sites(x: torch.Tensor, op: str, vvl: int = 128, *, layouts=None) -> torch.Tensor:
    """K2: a field ``x`` (physical, in ``layouts["x"]``, SoA when not
    named) -> per-component sum or max, (ncomp,)."""
    _check_op(op)
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
    batch = isinstance(field, BatchedField)
    # a batched reduction plans per lattice: the slot is one more grid axis
    plan = plan_for_launch(config, field.nsites, [field.layout])
    if plan.engine == "torch":
        if batch:
            return torch.stack([reduce_plain(f.canonical(), op) for f in field.unstack()])
        return reduce_plain(field.canonical(), op)
    require_cuda(f"field {field.name!r}", field.data)
    run = reduce_sites_batched if batch else reduce_sites
    return run(field.data, op, plan.vvl, layouts={"x": field.layout})


def target_sum(field, config: Optional[TargetConfig] = None) -> torch.Tensor:
    """targetDoubleSum: per-component sum over all local lattice sites,
    (ncomp,), or (batch, ncomp) for a BatchedField."""
    return _reduce(field, config, "sum")


def target_max(field, config: Optional[TargetConfig] = None) -> torch.Tensor:
    """Per-component max over all local lattice sites."""
    return _reduce(field, config, "max")

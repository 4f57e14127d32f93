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

Under a DtypePolicy (``TargetConfig.dtypes`` or the plan's) whose
accumulate slot resolves to compensated fp32 (``core.plan.
resolve_accumulate``), a float sum accumulates compensated: on "cuda"
through K2's compensated instance (pass 1 writes a (hi, lo) pair a block
and component, pass 2 folds the pairs in a fixed order); on "torch" in
fp64, rounded once to fp32, the plain version that both the kernel and the
JAX package's Kahan scan are held to.  Max and integer sums ignore the
policy.

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
from .plan import plan_for_launch, resolve_accumulate
from .target import TargetConfig, require_cuda

__all__ = ["target_sum", "target_max", "reduce_sites", "fold_partials",
           "reduce_sites_batched", "fold_partials_batched", "fold_components",
           "compensated_plain", "REDUCE_SUM", "REDUCE_MAX", "REDUCE_FOLD", "REDUCE_SUM_B",
           "REDUCE_MAX_B", "REDUCE_FOLD_B", "REDUCE_SUM_C", "REDUCE_FOLD_C"]

_OPS = {"sum": 0, "max": 1}

REDUCE_SUM = Kernel("reduce_sum", "rt_reduce_partials")
REDUCE_MAX = Kernel("reduce_max", "rt_reduce_partials")
REDUCE_FOLD = Kernel("reduce_fold", "rt_reduce_fold")
REDUCE_SUM_B = Kernel("reduce_sum_batched", "rt_reduce_partials_batched")
REDUCE_MAX_B = Kernel("reduce_max_batched", "rt_reduce_partials_batched")
REDUCE_FOLD_B = Kernel("reduce_fold_batched", "rt_reduce_fold_batched")
# K2's compensated instance, single and batched (one slot a grid row)
REDUCE_SUM_C = Kernel("reduce_sum_comp", "rt_reduce_partials_comp")
REDUCE_FOLD_C = Kernel("reduce_fold_comp", "rt_reduce_fold_comp")


def reduce_plain(x: torch.Tensor, op: str, dim: int = 1) -> torch.Tensor:
    """The plain fold; an integer sum keeps its dtype, as the JAX package's."""
    return x.sum(dim=dim, dtype=x.dtype) if op == "sum" else x.amax(dim=dim)


def compensated_plain(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The plain version of a compensated fp32 sum: accumulate in fp64,
    round once to fp32."""
    return x.to(torch.float64).sum(dim=dim).to(torch.float32)


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


def _fold_pairs(partials: torch.Tensor) -> torch.Tensor:
    """K2's compensated pass 2: (batch, nblocks, ncomp, 2) (hi, lo) pairs ->
    (batch, ncomp)."""
    if partials.device.type == "cpu":
        return partials.to(torch.float64).sum(dim=(1, 3)).to(torch.float32)
    check_tensor("partials", partials, partials.shape, partials.device)
    batch, nblocks, ncomp, _ = partials.shape
    out = torch.empty((batch, ncomp), dtype=torch.float32, device=partials.device)
    REDUCE_FOLD_C.launch(partials.device, partials.data_ptr(), out.data_ptr(), nblocks, ncomp,
                         batch)
    return out


def fold_partials(partials: torch.Tensor, op: str, compensated: bool = False) -> torch.Tensor:
    """K2 pass 2: (nblocks, ncomp) partial rows -> (ncomp,), folded in a
    fixed order; ``compensated``: (nblocks, ncomp, 2) (hi, lo) pairs, folded
    by the compensated instance."""
    _check_op(op)
    if compensated:
        return _fold_pairs(partials[None])[0]
    if partials.device.type == "cpu":
        return reduce_plain(partials, op, dim=0)
    check_tensor("partials", partials, partials.shape, partials.device)
    nblocks, ncomp = partials.shape
    out = torch.empty(ncomp, dtype=partials.dtype, device=partials.device)
    REDUCE_FOLD.launch(partials.device, partials.data_ptr(), out.data_ptr(),
                       nblocks, ncomp, _OPS[op])
    return out


def fold_partials_batched(partials: torch.Tensor, op: str,
                          compensated: bool = False) -> torch.Tensor:
    """K2B pass 2: (batch, nblocks, ncomp) partial rows -> (batch, ncomp),
    row b folded as :func:`fold_partials` folds slot b's table
    (``compensated``: (batch, nblocks, ncomp, 2) pairs)."""
    _check_op(op)
    if compensated:
        return _fold_pairs(partials)
    if partials.device.type == "cpu":
        return torch.stack([reduce_plain(p, op, dim=0) for p in partials])
    check_tensor("partials", partials, partials.shape, partials.device)
    batch, nblocks, ncomp = partials.shape
    out = torch.empty((batch, ncomp), dtype=partials.dtype, device=partials.device)
    REDUCE_FOLD_B.launch(partials.device, partials.data_ptr(), out.data_ptr(), nblocks, ncomp,
                         batch, _OPS[op])
    return out


def _sum_compensated(x: torch.Tensor, lay, vvl: int) -> torch.Tensor:
    """K2's compensated instance over ``batch`` stacked fields (batch,) +
    physical -> (batch, ncomp)."""
    if x.device.type == "cpu":
        return torch.stack([compensated_plain(lay.unpack(e)) for e in x])
    batch = x.shape[0]
    ncomp, nsites = lay.logical_shape(x.shape[1:])
    lx = check_batched_field("x", x, lay, ncomp, nsites, batch, x.device)
    partials = torch.empty((batch, -(-nsites // vvl), ncomp, 2), dtype=x.dtype, device=x.device)
    REDUCE_SUM_C.launch(x.device, x.data_ptr(), partials.data_ptr(), ncomp, nsites, batch, lx,
                        vvl)
    return _fold_pairs(partials)


def reduce_sites_batched(x: torch.Tensor, op: str, vvl: int = 128, *,
                         layouts=None, compensated: bool = False) -> torch.Tensor:
    """K2B: ``batch`` fields stacked on a leading axis (a BatchedField's
    data, each in ``layouts["x"]``) -> per-slot, per-component sum or max,
    (batch, ncomp), each row bitwise :func:`reduce_sites` of its slot.
    ``compensated`` (a sum only): K2's compensated instance."""
    _check_op(op)
    lay = resolve_layouts(layouts, ("x",), ())["x"]
    if compensated:
        return _sum_compensated(x, lay, vvl)
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


def reduce_sites(x: torch.Tensor, op: str, vvl: int = 128, *, layouts=None,
                 compensated: bool = False) -> torch.Tensor:
    """K2: a field ``x`` (physical, in ``layouts["x"]``, SoA when not
    named) -> per-component sum or max, (ncomp,).  ``compensated`` (a sum
    only): K2's compensated instance (one slot of its batch grid)."""
    _check_op(op)
    lay = resolve_layouts(layouts, ("x",), ())["x"]
    if compensated:
        return _sum_compensated(x[None], lay, vvl)[0]
    if x.device.type == "cpu":
        return reduce_plain(lay.unpack(x), op)
    ncomp, nsites = lay.logical_shape(x.shape)
    lx = check_field("x", x, lay, ncomp, nsites, x.device)
    partials = torch.empty((-(-nsites // vvl), ncomp), dtype=x.dtype, device=x.device)
    kern = REDUCE_SUM if op == "sum" else REDUCE_MAX
    kern.launch(x.device, x.data_ptr(), partials.data_ptr(), ncomp, nsites,
                _OPS[op], lx, vvl)
    return fold_partials(partials, op)


def _accumulate(plan, config, field, op: str):
    """(accumulate dtype or None, compensated) of a reduction under the
    plan's policy, else the config's: float sums only, as the JAX package's
    ``_reduce`` (max and integer sums are exempt)."""
    pol = plan.dtypes or config.dtypes
    if not (pol and pol.validate().accumulate and op == "sum" and field.dtype.is_floating_point):
        return None, False
    name, comp = resolve_accumulate(pol.accumulate)
    return (getattr(torch, name) if name else None), comp


def _reduce(field, config: Optional[TargetConfig], op: str) -> torch.Tensor:
    config = config or TargetConfig()
    batch = isinstance(field, BatchedField)
    # a batched reduction plans per lattice: the slot is one more grid axis
    plan = plan_for_launch(config, field.nsites, [field.layout])
    acc_dt, comp = _accumulate(plan, config, field, op)
    if plan.engine == "torch":
        def fold(c):
            if comp:
                return compensated_plain(c)
            return reduce_plain(c if acc_dt is None else c.to(acc_dt), op)

        if batch:
            return torch.stack([fold(f.canonical()) for f in field.unstack()])
        return fold(field.canonical())
    if acc_dt is not None and acc_dt != field.dtype:
        raise ValueError(
            f"cuda engine: a {field.dtype} sum accumulated in {acc_dt} is not yet ported; "
            f"K2 accumulates in the field's fp32, plain or compensated")
    require_cuda(f"field {field.name!r}", field.data)
    run = reduce_sites_batched if batch else reduce_sites
    return run(field.data, op, plan.vvl, layouts={"x": field.layout}, compensated=comp)


def target_sum(field, config: Optional[TargetConfig] = None) -> torch.Tensor:
    """targetDoubleSum: per-component sum over all local lattice sites,
    (ncomp,), or (batch, ncomp) for a BatchedField."""
    return _reduce(field, config, "sum")


def target_max(field, config: Optional[TargetConfig] = None) -> torch.Tensor:
    """Per-component max over all local lattice sites."""
    return _reduce(field, config, "max")

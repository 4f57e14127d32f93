"""Lattice-wide reductions (paper §3.2.3, ``targetDoubleSum`` et al.).

A per-component sum or max over all sites of a Field.  The torch engine
folds the canonical tensor; the cuda engine runs K2 (``csrc/reduce.cu``),
which replaces ``core/reduce.py::_reduce`` of the JAX package: pass 1
reads the Field in its own layout (SoA, AoS or AoSoA) and writes one
partial row per chunk of :data:`CHUNK` sites, pass 2 folds a table of
partial rows.  Both fold in one fixed order, a function of the
(component, site) pairs alone, so a sum's bits depend on ncomp and nsites
and on nothing else: not the layout, the plan's vvl or the run.  The
Pallas kernel's "initialise at program 0, then read-modify-write across
the grid" is a race on concurrent CUDA blocks and is not carried over;
there are no atomics, and max is exact.

:func:`reduce_tree` and :func:`fold_tree` repeat K2's adds in K2's order
as elementwise fp32 tensor adds (exact IEEE arithmetic on either device:
these sums hold no products to contract): the card tests and
``chip_smoke.py`` hold the kernels bitwise to them.  Nothing on the main
path calls them.  :func:`cancel_field` and :func:`fold_pairs` are the
cancellation fixtures built on that tree.

Under a DtypePolicy (``TargetConfig.dtypes`` or the plan's) whose
accumulate slot resolves to compensated fp32 (``core.plan.
resolve_accumulate``), a float sum accumulates compensated: on "cuda"
through K2's compensated instance (the same partition and trees over
(hi, lo) pairs); on "torch" in fp64, rounded once to fp32, the plain
version that both the kernel and the JAX package's Kahan scan are held
to.  Max and integer sums ignore the policy.

A BatchedField reduces to ``(batch, ncomp)``, each row bitwise the
single-Field reduction of its slot: on "cuda" through K2B, K2 with the slot
as a grid axis (the same kernels, so the same fold per row); on "torch" by
folding each slot as the single path folds it (the bits of one
``torch.sum`` over a ``(batch, ncomp, nsites)`` tensor are not promised to
equal those of each ``(ncomp, nsites)`` row).

Split reductions (a plan with ``rsplit`` > 1, the JAX package's
``_reduce`` :74-79 and the fused lowerings' ``_split_specs``): pass 1 and
its partial rows do not change; pass 2 folds the table of R rows in
``rsplit`` segments, segment s the rows [floor(s R / rsplit), floor((s + 1)
R / rsplit)) by K2's fold tree, and combines the segments in index order
(((s0 + s1) + s2) + ...), on the card in one launch of K2S (plain,
compensated over (hi, lo) pairs, batched).  An empty segment is the
monoid's identity.  With ``rsplit`` 1 that is the unsplit fold, bit for
bit.  :func:`fold_tree_split` repeats it in torch ops.  The JAX package's
segment s covers the site blocks [s n / rsplit, (s + 1) n / rsplit) of its
grid of n blocks; the port's segments cover the same sites wherever a row
is a whole number of the reference's blocks and the rows divide evenly:
K3's and K5's rows (one a vvl block, the reference's own blocks) always
under a valid plan, K2's pass-1 rows (CHUNK sites) where nsites / rsplit is
a multiple of CHUNK (milc_small: 512 rows a segment at rsplit 4).  On a
lattice of fewer than ``rsplit`` x CHUNK sites a segment falls inside a
row, so the segments are other sites than the reference's (at (4, 4, 8),
128 sites are one row and all segments but the last are empty).  Field
outputs never change with ``rsplit``; max and integer sums stay exact.

Dtypes on "cuda": K2 reduces fp32, int32 and bf16 fields.  An int32 sum
adds in uint32 and is reinterpreted, so a sum past 2^31 wraps as the JAX
package's int32 sum does (x64 off), and max starts at INT32_MIN; both are
exact, so their bits are those of any order.  A bf16 field's values are
widened to fp32 as they load and go through the fp32 trees (pass 1, fold),
and the result is rounded once to bf16: ``reduce_tree`` of the widened
field, rounded, is its bitwise oracle.  (The JAX package accumulates a
bf16 sum in bf16 across its grid, ROADMAP queue 3.)

:func:`fold_components` is the fixed-order fold of per-component sums into
one number that every inner product of the solvers uses, single and
batched alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._cuda import (Kernel, check_batched_field, check_field, check_tensor, csrc_define,
                     reduce_dtype)
from .field import BatchedField
from .layout import resolve_layouts
from .plan import plan_for_launch, resolve_accumulate
from .target import TargetConfig, require_cuda

__all__ = ["target_sum", "target_max", "reduce_sites", "fold_partials",
           "reduce_sites_batched", "fold_partials_batched", "fold_components",
           "compensated_plain", "partial_rows", "fold_scratch", "partials_tree", "fold_tree",
           "fold_tree_split", "reduce_tree", "segments", "split_plain",
           "cancel_field", "fold_pairs", "CHUNK", "REDUCE_SUM", "REDUCE_MAX", "REDUCE_FOLD",
           "REDUCE_SUM_B", "REDUCE_MAX_B", "REDUCE_FOLD_B", "REDUCE_SUM_C", "REDUCE_FOLD_C",
           "REDUCE_FOLD_S", "REDUCE_FOLD_SB", "REDUCE_FOLD_SC", "REDUCE_SUM_I32",
           "REDUCE_MAX_I32", "REDUCE_FOLD_I32", "REDUCE_SUM_BF16", "REDUCE_MAX_BF16",
           "REDUCE_FOLD_BF16"]

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
# K2S, the split fold (rsplit > 1): single, batched, compensated
REDUCE_FOLD_S = Kernel("reduce_fold_split", "rt_reduce_fold_split")
REDUCE_FOLD_SB = Kernel("reduce_fold_split_batched", "rt_reduce_fold_split")
REDUCE_FOLD_SC = Kernel("reduce_fold_split_comp", "rt_reduce_fold_split")
# K2's int32 and bf16 instances (pass 1 single or batched; the fold any split)
REDUCE_SUM_I32 = Kernel("reduce_sum_i32", "rt_reduce_partials_i32")
REDUCE_MAX_I32 = Kernel("reduce_max_i32", "rt_reduce_partials_i32")
REDUCE_FOLD_I32 = Kernel("reduce_fold_i32", "rt_reduce_fold_split")
REDUCE_SUM_BF16 = Kernel("reduce_sum_bf16", "rt_reduce_partials_bf16")
REDUCE_MAX_BF16 = Kernel("reduce_max_bf16", "rt_reduce_partials_bf16")
REDUCE_FOLD_BF16 = Kernel("reduce_fold_bf16", "rt_reduce_fold_split")
# rt_reduce_fold_split's table kinds (RT_FOLD_* in csrc/reduce.cu)
_FOLD_F32, _FOLD_COMP, _FOLD_I32, _FOLD_BF16 = 0, 1, 2, 3

# K2's geometry, read from the #defines of csrc/reduce.cu (the library
# reports its chunk at load and _cuda.library() refuses a mismatch)
CHUNK = csrc_define("reduce.cu", "RT_REDUCE_CHUNK")          # sites a pass-1 row folds
_THREADS = csrc_define("reduce.cu", "RT_REDUCE_THREADS")     # virtual threads a chunk
_STEPS = CHUNK // (4 * _THREADS)                             # float4 steps a thread
_FOLD_THREADS = csrc_define("reduce.cu", "RT_FOLD_THREADS")  # pass 2, level 1
_FOLD_THREADS_ONE = csrc_define("reduce.cu", "RT_FOLD_THREADS_ONE")   # level 2
_FOLD_ITERS = csrc_define("reduce.cu", "RT_FOLD_ITERS")
_FOLD_ITERS_ONE = csrc_define("reduce.cu", "RT_FOLD_ITERS_ONE")


def partial_rows(nsites: int) -> int:
    """The rows of pass 1's partial table for ``nsites`` sites."""
    return -(-nsites // CHUNK)


def reduce_plain(x: torch.Tensor, op: str, dim: int = 1) -> torch.Tensor:
    """The plain fold; an integer sum keeps its dtype, as the JAX package's."""
    return x.sum(dim=dim, dtype=x.dtype) if op == "sum" else x.amax(dim=dim)


def segments(nrows: int, rsplit: int):
    """The row ranges [lo, hi) of a split fold's segments: segment s is
    [floor(s nrows / rsplit), floor((s + 1) nrows / rsplit))."""
    return [(s * nrows // rsplit, (s + 1) * nrows // rsplit) for s in range(rsplit)]


def _identity(op: str, dtype: torch.dtype):
    """The monoid's identity in ``dtype``: 0, -inf, or iinfo.min for an
    integer max."""
    if op == "sum":
        return 0
    return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def split_plain(partials: torch.Tensor, op: str, rsplit: int, dim: int = 0) -> torch.Tensor:
    """The plain split fold along ``dim``: each segment folded by
    :func:`reduce_plain` (an empty one is the identity), the segments
    combined in index order."""
    parts = torch.movedim(partials, dim, 0)
    acc = None
    for lo, hi in segments(parts.shape[0], rsplit):
        v = (reduce_plain(parts[lo:hi], op, dim=0) if hi > lo else
             torch.full(parts.shape[1:], _identity(op, parts.dtype), dtype=parts.dtype,
                        device=parts.device))
        acc = v if acc is None else (acc + v if op == "sum" else torch.maximum(acc, v))
    return acc


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


# -- K2's trees, emulated ------------------------------------------------------------
#
# A value is a tensor with a trailing word axis: one word (plain) or two,
# (hi, lo) (compensated, comp.cuh's rt_pair_add).

def _pair_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """comp.cuh's rt_pair_add: TwoSum of the his, the error into the los."""
    ah, al, bh, bl = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    s = ah + bh
    bv = s - ah
    av = s - bv
    e = (ah - av) + (bh - bv)
    lo = (al + bl) + e
    hi = s + lo
    return torch.stack([hi, lo - (hi - s)], dim=-1)


class _Monoid:
    def __init__(self, op: str, compensated: bool):
        _check_op(op)
        if compensated and op != "sum":
            raise ValueError("a compensated reduction is a sum")
        self.comp, self.op = compensated, op

    def pad(self, dtype: torch.dtype):
        """The identity's value in ``dtype``."""
        return _identity(self.op, dtype)

    def add(self, a, b):
        if self.comp:
            return _pair_add(a, b)
        return torch.maximum(a, b) if self.op == "max" else a + b

    def of(self, v):
        """Values -> words (v, 0) or (v,)."""
        return torch.stack([v, torch.zeros_like(v)], -1) if self.comp else v[..., None]


def _warp_fold(m: _Monoid, x: torch.Tensor) -> torch.Tensor:
    """rt_fold_warp over the lane axis (-2, 32 lanes): lane l adds lane
    l + off (its own value where that is past 31), off = 16, 8, 4, 2, 1;
    returns lane 0."""
    lanes = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        x = m.add(x, x[..., torch.where(lanes + off < 32, lanes + off, lanes), :])
    return x[..., 0, :]


def partials_tree(x: torch.Tensor, op: str = "sum", compensated: bool = False) -> torch.Tensor:
    """K2's pass 1 on canonical fields ``x`` (..., ncomp, nsites) fp32:
    the partial table (..., partial_rows(nsites), ncomp), or (..., rows,
    ncomp, 2) (hi, lo) pairs where ``compensated``."""
    m = _Monoid(op, compensated)
    *lead, ncomp, nsites = x.shape
    rows = partial_rows(nsites)
    v = torch.nn.functional.pad(x, (0, rows * CHUNK - nsites), value=m.pad(x.dtype))
    v = m.of(v.reshape(*lead, ncomp, rows, _STEPS, _THREADS, 4))
    q = m.add(m.add(v[..., 0, :], v[..., 1, :]), m.add(v[..., 2, :], v[..., 3, :]))
    a0, a1 = q[..., 0, :, :], q[..., 1, :, :]
    for j in range(2, _STEPS, 2):
        a0 = m.add(a0, q[..., j, :, :])
        a1 = m.add(a1, q[..., j + 1, :, :])
    w = _warp_fold(m, m.add(a0, a1).reshape(*lead, ncomp, rows, _THREADS // 32, 32, -1))
    part = m.add(w[..., 0, :], w[..., 1, :]).transpose(-3, -2)   # (..., rows, ncomp, words)
    return part if compensated else part[..., 0]


def _fold_level(m: _Monoid, p: torch.Tensor, r: int, slab_rows: int) -> torch.Tensor:
    """One launch of pass 2: (..., nrows, ncomp, words) -> (..., nslabs,
    ncomp, words).  Thread (r, c) folds rows r, r + R, ... of its slab from
    the identity, the slab and the table padded with it; then the R
    threads of a column fold in the tree n -> h = ceil(n / 2)."""
    *lead, nrows, ncomp, words = p.shape
    nslabs = max(1, -(-nrows // slab_rows))
    nit = -(-slab_rows // r)
    ident = m.of(torch.full((), m.pad(p.dtype), dtype=p.dtype, device=p.device))
    p = torch.cat([p, ident.expand(*lead, nslabs * slab_rows - nrows, ncomp, words)], dim=-3)
    p = p.reshape(*lead, nslabs, slab_rows, ncomp, words)
    p = torch.cat([p, ident.expand(*lead, nslabs, nit * r - slab_rows, ncomp, words)], dim=-3)
    p = p.reshape(*lead, nslabs, nit, r, ncomp, words)
    acc = ident.expand(*lead, nslabs, r, ncomp, words)
    for it in range(nit):
        acc = m.add(acc, p[..., it, :, :, :])
    n = r
    while n > 1:
        h = (n + 1) // 2
        acc = torch.cat([m.add(acc[..., :n - h, :, :], acc[..., h:n, :, :]),
                         acc[..., n - h:h, :, :]], dim=-3)
        n = h
    return acc[..., 0, :, :]


def _fold_plan(nrows: int, ncomp: int):
    """Pass 2's plan for a table of nrows x ncomp (rt_fold_plan of
    csrc/reduce.cu): (R1, R2, level 1's slab rows, 0 where one launch of
    level 2 folds the table)."""
    if ncomp > _FOLD_THREADS_ONE:
        raise ValueError(f"K2's fold takes at most {_FOLD_THREADS_ONE} components, got {ncomp}")
    r1, r2 = max(1, _FOLD_THREADS // ncomp), max(1, _FOLD_THREADS_ONE // ncomp)
    return r1, r2, (0 if nrows <= r2 * _FOLD_ITERS_ONE else r1 * _FOLD_ITERS)


def fold_scratch(nrows: int, ncomp: int, rsplit: int = 1) -> int:
    """The values (pairs, where compensated) of pass 2's scratch a slot:
    level 1's rows of each segment, at the largest segment's slab count, x
    ncomp (rt_reduce_fold_split_scratch of csrc/reduce.cu)."""
    slabs = 0
    for lo, hi in segments(nrows, rsplit):
        slab = _fold_plan(hi - lo, ncomp)[2]
        slabs = max(slabs, -(-(hi - lo) // slab) if slab else 0)
    return rsplit * slabs * ncomp


def _fold_words(m: _Monoid, p: torch.Tensor) -> torch.Tensor:
    """K2's fold tree on one table or segment (..., nrows, ncomp, words) ->
    (..., ncomp, words): level 1 on slabs of RT_FOLD_ITERS x R1 rows where
    the table has more than RT_FOLD_ITERS_ONE x R2 rows, then level 2, one
    slab."""
    r1, r2, slab = _fold_plan(p.shape[-3], p.shape[-2])
    if slab:
        p = _fold_level(m, p, r1, slab)
    return _fold_level(m, p, r2, max(p.shape[-3], 1))[..., 0, :, :]


def fold_tree_split(partials: torch.Tensor, op: str = "sum", compensated: bool = False,
                    rsplit: int = 1) -> torch.Tensor:
    """K2S, the split fold, on a partial table (..., nrows, ncomp) (fp32 or
    int32), or (..., nrows, ncomp, 2) pairs where ``compensated`` -> (...,
    ncomp): each of the ``rsplit`` :func:`segments` by K2's fold tree, the
    segments combined in index order (pairs by TwoSum).  ``rsplit`` 1 is
    :func:`fold_tree`."""
    m = _Monoid(op, compensated)
    p = partials if compensated else partials[..., None]
    acc = None
    for lo, hi in segments(p.shape[-3], rsplit):
        v = _fold_words(m, p[..., lo:hi, :, :])
        acc = v if acc is None else m.add(acc, v)
    return acc[..., 0]


def fold_tree(partials: torch.Tensor, op: str = "sum", compensated: bool = False) -> torch.Tensor:
    """K2's pass 2 on a partial table (..., nrows, ncomp) fp32 or int32, or
    (..., nrows, ncomp, 2) pairs where ``compensated`` -> (..., ncomp)."""
    return fold_tree_split(partials, op, compensated)


def reduce_tree(x: torch.Tensor, op: str = "sum", compensated: bool = False,
                rsplit: int = 1) -> torch.Tensor:
    """K2, both passes, on canonical fields (..., ncomp, nsites) ->
    (..., ncomp): the kernel's bits (``compensated``: its compensated
    instance's; ``rsplit``: its split fold's).  A bf16 field goes through
    the fp32 trees and is rounded once, as the kernel's bf16 instance."""
    if x.dtype == torch.bfloat16:
        return reduce_tree(x.float(), op, compensated, rsplit).to(torch.bfloat16)
    return fold_tree_split(partials_tree(x, op, compensated), op, compensated, rsplit)


# -- the cancellation fixtures ---------------------------------------------------------

CANCEL_BIG, CANCEL_FILL = 2.0 ** 26 + 8, 3.9375


def cancel_field(ncomp: int, nsites: int, device=None) -> torch.Tensor:
    """The cancellation fixture (ncomp, nsites), nsites a multiple of
    CHUNK.  In every chunk, +CANCEL_BIG at virtual thread 0's first site and
    -CANCEL_BIG at thread 32's, and CANCEL_FILL at each site pass 1 adds to
    one of them on its own before the two meet in the last add (w0 + w1):
    the thread's second and third site, its first site of steps 1 (a1's
    only value) and 2, 4, ..., 14 (added to a0), and the first site of
    threads 1, 2, 4, 8, 16 (the shuffle tree's partners of lane 0), each in
    both warps; every other site is 0.
    CANCEL_FILL is under half an ulp of CANCEL_BIG (8), so the plain K2 adds
    each to a big value and loses it: every chunk's partial is 0 while the
    sum is 30 x 3.9375 a chunk, 3.52 x the oracle bound at any size.  A
    compensated fold keeps every filler in its los."""
    if nsites % CHUNK:
        raise ValueError(f"cancel_field: nsites {nsites} is not a multiple of {CHUNK}")
    x = torch.zeros((ncomp, nsites // CHUNK, _STEPS, _THREADS, 4), device=device)
    for t0, sign in ((0, 1.0), (32, -1.0)):
        x[:, :, 0, t0, 0] = sign * CANCEL_BIG
        x[:, :, 0, t0, 1:3] = CANCEL_FILL
        x[:, :, 1, t0, 0] = CANCEL_FILL      # a1's only filler
        x[:, :, 2::2, t0, 0] = CANCEL_FILL   # a0's, one at a time
        x[:, :, 0, [t0 + 1, t0 + 2, t0 + 4, t0 + 8, t0 + 16], 0] = CANCEL_FILL
    return x.reshape(ncomp, nsites)


def fold_pairs(nrows: int, ncomp: int, device=None) -> torch.Tensor:
    """(nrows, ncomp, 2) (hi, lo) pairs for K2's compensated pass 2: hi an
    integer whose sign alternates over the rows, so the his cancel, and lo
    a multiple of 2^-10 that does not cancel.  Every partial sum is exact in
    fp32 in any order, so the fold is exact, and a fold that dropped lo
    would return at most 4, about 2^-10 x nrows from the fp64 sum, far
    beyond the oracle bound."""
    k = torch.arange(nrows, device=device)[:, None]
    c = torch.arange(ncomp, device=device)[None, :]
    hi = (1.0 - 2.0 * (k % 2)) * (1 + c % 4)
    lo = (1 + (k + c) % 3) * 2.0 ** -10
    return torch.stack([hi.float(), lo.float()], dim=-1)


# -- the kernel wrappers ----------------------------------------------------------------

def _fold_cuda(partials: torch.Tensor, op: str, compensated: bool, batched: bool = True,
               rsplit: int = 1, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K2's pass 2 on the card: (batch, nrows, ncomp[, 2]) -> (batch, ncomp);
    ``batched`` False: K2's single fold, (nrows, ncomp[, 2]) -> (ncomp,).
    The table is fp32 (pairs where ``compensated``) or int32; ``out_dtype``
    bf16 rounds an fp32 fold once (the bf16 instance).  ``rsplit`` > 1, an
    int32 table or a bf16 result run K2S (rt_reduce_fold_split), the rest
    the unsplit entry points, the same tree.  One allocation holds the
    result and the scratch."""
    tdt = torch.int32 if partials.dtype == torch.int32 else torch.float32
    check_tensor("partials", partials, partials.shape, partials.device, tdt)
    rank = 2 + batched + compensated
    if partials.dim() != rank or (compensated and partials.shape[-1] != 2):
        raise ValueError(f"partials: shape {tuple(partials.shape)}, expected "
                         f"{'(batch, ' if batched else '('}nrows, ncomp"
                         f"{', 2)' if compensated else ')'}")
    if rsplit < 1:
        raise ValueError(f"rsplit must be >= 1, got {rsplit}")
    bf16 = out_dtype == torch.bfloat16
    if (compensated or tdt == torch.int32) and bf16:
        raise ValueError("a bf16 result rounds a plain fp32 fold")
    batch = partials.shape[0] if batched else 1
    nrows, ncomp = partials.shape[1:3] if batched else partials.shape[:2]
    words = 2 if compensated else 1
    nout = -(-batch * ncomp // 2) if bf16 else batch * ncomp   # table words of the result
    buf = torch.empty(nout + batch * words * fold_scratch(nrows, ncomp, rsplit), dtype=tdt,
                      device=partials.device)
    out = buf[:nout].view(torch.bfloat16)[:batch * ncomp] if bf16 else buf[:nout]
    out = out.view((batch, ncomp) if batched else (ncomp,))
    args = (partials.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * nout, nrows, ncomp)
    if tdt == torch.int32 or bf16:
        kern, kind = (REDUCE_FOLD_I32, _FOLD_I32) if tdt == torch.int32 else (REDUCE_FOLD_BF16,
                                                                               _FOLD_BF16)
        kern.launch(partials.device, *args, batch, rsplit, _OPS[op], kind)
    elif rsplit > 1:
        kern = REDUCE_FOLD_SC if compensated else (REDUCE_FOLD_SB if batched else REDUCE_FOLD_S)
        kern.launch(partials.device, *args, batch, rsplit, _OPS[op],
                    _FOLD_COMP if compensated else _FOLD_F32)
    elif compensated:
        REDUCE_FOLD_C.launch(partials.device, *args, batch)
    elif not batched:
        REDUCE_FOLD.launch(partials.device, *args, _OPS[op])
    else:
        REDUCE_FOLD_B.launch(partials.device, *args, batch, _OPS[op])
    return out


def _fold_pairs(partials: torch.Tensor, batched: bool = True, rsplit: int = 1) -> torch.Tensor:
    """K2's compensated pass 2: (batch, nrows, ncomp, 2) (hi, lo) pairs ->
    (batch, ncomp); ``batched`` False: (nrows, ncomp, 2) -> (ncomp,).  The
    plain version (a CPU table) is the fp64 sum, whatever the split."""
    if partials.device.type == "cpu":
        return partials.to(torch.float64).sum(dim=(-3, -1)).to(torch.float32)
    return _fold_cuda(partials, "sum", True, batched, rsplit)


def fold_partials(partials: torch.Tensor, op: str, compensated: bool = False,
                  rsplit: int = 1, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K2 pass 2: (nrows, ncomp) partial rows (fp32 or int32) -> (ncomp,),
    folded in a fixed order, in ``rsplit`` segments combined in index order
    (K2S where > 1); ``compensated``: (nrows, ncomp, 2) (hi, lo) pairs,
    folded by the compensated instance; ``out_dtype`` bf16: an fp32 table
    folded and rounded once."""
    _check_op(op)
    if compensated:
        return _fold_pairs(partials, batched=False, rsplit=rsplit)
    if partials.device.type == "cpu":
        out = split_plain(partials, op, rsplit)
        return out if out_dtype is None else out.to(out_dtype)
    return _fold_cuda(partials, op, False, batched=False, rsplit=rsplit, out_dtype=out_dtype)


def fold_partials_batched(partials: torch.Tensor, op: str, compensated: bool = False,
                          rsplit: int = 1,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K2B pass 2: (batch, nrows, ncomp) partial rows -> (batch, ncomp),
    row b folded as :func:`fold_partials` folds slot b's table
    (``compensated``: (batch, nrows, ncomp, 2) pairs)."""
    _check_op(op)
    if compensated:
        return _fold_pairs(partials, rsplit=rsplit)
    if partials.device.type == "cpu":
        out = torch.stack([split_plain(p, op, rsplit) for p in partials])
        return out if out_dtype is None else out.to(out_dtype)
    return _fold_cuda(partials, op, False, rsplit=rsplit, out_dtype=out_dtype)


def _sum_compensated(x: torch.Tensor, lay, rsplit: int = 1) -> torch.Tensor:
    """K2's compensated instance over ``batch`` stacked fields (batch,) +
    physical -> (batch, ncomp)."""
    if x.device.type == "cpu":
        return torch.stack([compensated_plain(lay.unpack(e)) for e in x])
    batch = x.shape[0]
    ncomp, nsites = lay.logical_shape(x.shape[1:])
    lx = check_batched_field("x", x, lay, ncomp, nsites, batch, x.device)
    partials = torch.empty((batch, partial_rows(nsites), ncomp, 2), dtype=x.dtype,
                           device=x.device)
    REDUCE_SUM_C.launch(x.device, x.data_ptr(), partials.data_ptr(), ncomp, nsites, batch, lx)
    return _fold_pairs(partials, rsplit=rsplit)


def _pass1(x: torch.Tensor, op: str, lay, batch: int):
    """K2's pass 1 on the card over ``batch`` stacked fields in their dtype
    (``batch`` 0: one field): (partial table, the fold's result dtype)."""
    dt = reduce_dtype("x", x)
    ncomp, nsites = lay.logical_shape(x.shape[1:] if batch else x.shape)
    if batch:
        lx = check_batched_field("x", x, lay, ncomp, nsites, batch, x.device, dt)
    else:
        lx = check_field("x", x, lay, ncomp, nsites, x.device, dt)
    tdt = torch.int32 if dt == torch.int32 else torch.float32
    partials = torch.empty(((batch,) if batch else ()) + (partial_rows(nsites), ncomp),
                           dtype=tdt, device=x.device)
    args = (x.data_ptr(), partials.data_ptr(), ncomp, nsites)
    if dt == torch.float32 and not batch:
        (REDUCE_SUM if op == "sum" else REDUCE_MAX).launch(x.device, *args, _OPS[op], lx)
    elif dt == torch.float32:
        (REDUCE_SUM_B if op == "sum" else REDUCE_MAX_B).launch(x.device, *args, batch,
                                                                _OPS[op], lx)
    elif dt == torch.int32:
        (REDUCE_SUM_I32 if op == "sum" else REDUCE_MAX_I32).launch(x.device, *args,
                                                                    max(batch, 1), _OPS[op], lx)
    else:
        (REDUCE_SUM_BF16 if op == "sum" else REDUCE_MAX_BF16).launch(x.device, *args,
                                                                      max(batch, 1), _OPS[op],
                                                                      lx)
    return partials, dt


def reduce_sites_batched(x: torch.Tensor, op: str, vvl: int = 128, *, layouts=None,
                         compensated: bool = False, rsplit: int = 1) -> torch.Tensor:
    """K2B: ``batch`` fields stacked on a leading axis (a BatchedField's
    data, each in ``layouts["x"]``) -> per-slot, per-component sum or max,
    (batch, ncomp), each row bitwise :func:`reduce_sites` of its slot.
    ``compensated`` (an fp32 sum only): K2's compensated instance;
    ``rsplit``: the split fold.  ``vvl`` does not shape K2 (its chunk is
    :data:`CHUNK`); the wrappers of every lattice kernel take the plan's.
    See :func:`reduce_sites` for the dtypes."""
    _check_op(op)
    lay = resolve_layouts(layouts, ("x",), ())["x"]
    if compensated:
        return _sum_compensated(x, lay, rsplit)
    if x.device.type == "cpu":
        return torch.stack([reduce_plain(lay.unpack(e), op) for e in x])
    partials, dt = _pass1(x, op, lay, x.shape[0])
    return fold_partials_batched(partials, op, rsplit=rsplit, out_dtype=_result_dtype(dt))


def _result_dtype(dt: torch.dtype) -> Optional[torch.dtype]:
    """The fold's result dtype for a field of ``dt`` (None: the table's)."""
    return torch.bfloat16 if dt == torch.bfloat16 else None


def reduce_sites(x: torch.Tensor, op: str, vvl: int = 128, *, layouts=None,
                 compensated: bool = False, rsplit: int = 1) -> torch.Tensor:
    """K2: a field ``x`` (physical, in ``layouts["x"]``, SoA when not
    named) -> per-component sum or max, (ncomp,), in x's dtype: fp32, int32
    (a wrapping sum) or bf16 (fp32 trees, rounded once).  ``compensated``
    (an fp32 sum only): K2's compensated instance (one slot of its batch
    grid).  ``rsplit``: the split fold (K2S).  ``vvl`` as
    :func:`reduce_sites_batched`."""
    _check_op(op)
    lay = resolve_layouts(layouts, ("x",), ())["x"]
    if compensated:
        return _sum_compensated(x[None], lay, rsplit)[0]
    if x.device.type == "cpu":
        return reduce_plain(lay.unpack(x), op)
    partials, dt = _pass1(x, op, lay, 0)
    return fold_partials(partials, op, rsplit=rsplit, out_dtype=_result_dtype(dt))


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
            f"K2 accumulates an fp32 field's sum under a policy in fp32, plain or "
            f"compensated (a bf16 field's sum accumulates in fp32 without one)")
    require_cuda(f"field {field.name!r}", field.data)
    run = reduce_sites_batched if batch else reduce_sites
    return run(field.data, op, plan.vvl, layouts={"x": field.layout}, compensated=comp,
               rsplit=plan.rsplit)


def target_sum(field, config: Optional[TargetConfig] = None) -> torch.Tensor:
    """targetDoubleSum: per-component sum over all local lattice sites,
    (ncomp,), or (batch, ncomp) for a BatchedField."""
    return _reduce(field, config, "sum")


def target_max(field, config: Optional[TargetConfig] = None) -> torch.Tensor:
    """Per-component max over all local lattice sites."""
    return _reduce(field, config, "max")

"""Lowering plans: every launch decision as one explicit, hashable value.

A :class:`LoweringPlan` names the engine, the block size and, for stencil
graphs, the tiles:

  engine "torch"  whole-lattice torch ops (the counterpart of the JAX
                  package's "jnp" engine, and the oracle);
  engine "cuda"   the hand-written kernels under ``repro_torch/csrc``.
  vvl             sites per CUDA block of the untiled kernels (one thread
                  per site).  Unused by the torch engine and by tiled plans.
                  A whole number of warps, and, as on the JAX package's
                  pallas engine, a multiple of every AoSoA SAL the launch
                  touches (:func:`sal_alignment`), so a block holds whole
                  short arrays.
  bx, by, bz      the tiled stencil lowering: each tile is bx x-planes by
                  by y-rows by bz z-sites (0 = the whole axis); every further
                  lattice dim is whole.  A plan with by or bz set is *tiled*:
                  the cuda engine runs the graph's tiled kernel, which walks
                  the tiles in the reference's grid order.  A plan without
                  them runs the untiled kernel, which ignores bx.

Every layout (SoA, AoS, AoSoA) runs untiled and tiled: the tiled kernels
(K9, K5T) address every field through INDEX, as the untiled ones do.

A batched launch (BatchedField inputs) plans per lattice: the slot is one
more grid axis of the same kernel, so vvl and the tiles describe one batch
element, untiled or tiled.

The shared-memory budget (``TargetConfig.smem_bytes`` or
``$TARGETDP_TORCH_SMEM_BYTES``) makes :func:`default_plan` tile a stencil
launch whose whole-lattice staging would exceed it.  The footprint model
(:func:`estimate_smem_bytes`) and the planners (:func:`choose_slab`,
:func:`choose_tiles`) are the JAX package's VMEM ones, so both packages pick
the same tiles from the same budget.  Without a budget every plan is the
untiled one.

A :class:`DtypePolicy` (``LoweringPlan.dtypes`` or ``TargetConfig.dtypes``)
makes precision a lowering decision: the storage dtype fields are staged
in and written in, the compute dtype of the arithmetic, and the accumulate
dtype of terminal sums.  The footprint model prices a policy's launch at
its storage itemsize.  The cuda engine has policy instances of the
wilson_normal and ludwig_lb_step kernels, untiled and tiled, of the flat
chains cg_update, ludwig_chem_stress and ludwig_lc_update, and of K2's sum
(``cuda_policy`` says which policies they take); a policy on any other
graph raises.

``rsplit`` splits a launch's terminal reductions: the stage-1 partial rows
fold in ``rsplit`` segments, each by K2's fold tree, and a stage-2 combine
adds the segments in index order (``core.reduce``, K2S).  Field outputs and
the partial rows themselves do not change with it; max and integer sums
stay exact.  The torch engine has no grid to split and refuses it, as the
JAX package's jnp engine does.

``view`` is the JAX package's canonical-view axis of a stencil launch:
"staged-nd" stages canonical views around the kernel, "block" the native
AoSoA tiles (:func:`block_view_ok` states the alignment it needs), "auto"
resolves per launch (:func:`adapt_plan`).  The cuda kernels read every
layout in place through INDEX, so on the card a block-view launch runs the
same kernels as a staged-nd one; the view is validated exactly as the JAX
package validates it, and a misaligned explicit "block" raises.

The plan autotuner (``core.tune``) sweeps :func:`candidate_plans`, the JAX
package's candidate set on the cuda engine: block sizes (site-local) or
x-slabs (stencil), ``view="block"``, ``rsplit``, tiled and dtype-policy
twins, pruned by the shared-memory budget.  Under ``plan_policy="tuned"`` a
LaunchGraph launch runs the persisted winner for its :func:`graph_plan_key`;
site-local launches and standalone reductions carry no graph key and plan
with the default heuristics.

``halo`` is the JAX package's halo-strategy axis: "periodic" (one
device), "pre" (the sharded path's pre-exchanged halos) or "overlap" (the
same inputs under the interior/boundary split of ``core.overlap``, whose
sub-launches are "pre" launches on sub-lattices, :func:`sub_lattice_plan`).
The call site's strategy is authoritative, except that a plan which chose
"overlap" upgrades a "pre" launch (:func:`adapt_plan`); the tuner proposes
two "overlap" twins of a sharded "pre" launch on more than one rank.  Under
"pre" and "overlap" every plan axis runs: tiles (the graph's "pre" and
box kernels walk them), ``rsplit`` (no "pre" kernel folds partial rows, so it
leaves the field outputs as they are) and the block view (checked on the
halo'd lattices, then the same kernels, which read every layout in place).
What the cuda engine's "pre" and box kernels do not take raises at launch,
naming ROADMAP: a DtypePolicy, a batch, a reduction output, and
wilson_normal off SoA (``core.fuse``).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

from .layout import Layout, LayoutKind

__all__ = ["LoweringPlan", "DtypePolicy", "ACCUM_COMPENSATED", "dtype_itemsize",
           "resolve_accumulate", "cuda_policy", "CudaPolicy", "divisors", "choose_vvl", "sal_alignment", "choose_slab",
           "choose_tiles", "block_view_ok", "adapt_plan", "sub_lattice_plan", "plan_tile",
           "HALOS", "VIEW_AUTO",
           "VIEW_BLOCK", "VIEW_STAGED_ND",
           "tile_extents", "estimate_smem_bytes", "resolved_smem_bytes",
           "default_plan", "plan_for_launch", "policy_plan", "candidate_plans",
           "graph_plan_key", "ENGINES", "WARP",
           "MAX_BLOCK", "SMEM_ENV", "SMEM_PER_BLOCK_OPTIN"]

log = logging.getLogger(__name__)

ENGINES = ("torch", "cuda")
HALOS = ("periodic", "pre", "overlap")
WARP = 32          # a CUDA block is a whole number of warps
MAX_BLOCK = 1024   # the most threads one CUDA block may hold
# the port's own shared-memory budget variable ($TARGETDP_VMEM_BYTES is the
# JAX package's); unset or empty means unbounded
SMEM_ENV = "TARGETDP_TORCH_SMEM_BYTES"
# the most shared memory one block may opt in to on the H100
# (cudaDevAttrMaxSharedMemoryPerBlockOptin); the tiled kernels check the
# device's own value again at their first launch
SMEM_PER_BLOCK_OPTIN = 232448

VIEW_BLOCK = "block"
VIEW_STAGED_ND = "staged-nd"
# the dataclass default, resolved per launch by adapt_plan (site-local ->
# block, stencil -> staged-nd); the native AoSoA stencil view is always an
# explicit view=VIEW_BLOCK
VIEW_AUTO = "auto"


# -- dtype policy (the mixed-precision lowering axis) ------------------------------

# itemsizes of the dtype names a policy may carry, a plain table so that
# planning never needs a tensor
_DTYPE_ITEMSIZE = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "int64": 8, "int32": 4, "int16": 2, "int8": 1,
}
# short names of DtypePolicy.tag()
_DTYPE_SHORT = {
    "float64": "f64", "float32": "f32", "float16": "f16", "bfloat16": "bf16",
    "compensated": "kf32",
}
# the accumulate slot also takes the explicit compensated request
ACCUM_COMPENSATED = "compensated"


def dtype_itemsize(name: str, fallback: int = 4) -> int:
    """Itemsize in bytes of a policy dtype name ('' -> ``fallback``)."""
    return _DTYPE_ITEMSIZE.get(name, fallback) if name else fallback


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """The precision triple of a launch (storage, compute, accumulate), each
    a dtype *name*, '' for inherit:

      storage      the dtype field data is staged in and field outputs are
                   written in ('' = the input's).  Float inputs are rounded
                   to it (round to nearest even) before the arithmetic.
      compute      the dtype the arithmetic runs in ('' = the storage
                   dtype, or the input's): rounded inputs are widened to it.
      accumulate   the dtype terminal float sums (fused reductions and
                   ``target_sum``) accumulate in ('' = the output dtype).
                   'float64' resolves to compensated fp32 (see
                   :func:`resolve_accumulate`); 'compensated' asks for it
                   by name.  Max and integer reductions ignore the policy
                   and stay bitwise.

    The empty policy (every slot '') and ``dtypes=None`` lower exactly as
    the policy-free code on every path."""

    storage: str = ""
    compute: str = ""
    accumulate: str = ""

    def __bool__(self) -> bool:
        return bool(self.storage or self.compute or self.accumulate)

    def tag(self) -> str:
        """Short label, e.g. ``bf16:f32:f64``."""
        return ":".join(_DTYPE_SHORT.get(s, s) if s else "-"
                        for s in (self.storage, self.compute, self.accumulate))

    def storage_itemsize(self, fallback: int) -> int:
        return dtype_itemsize(self.storage, fallback)

    def validate(self) -> "DtypePolicy":
        for slot, name in (("storage", self.storage),
                           ("compute", self.compute)):
            if name and name not in _DTYPE_ITEMSIZE:
                raise ValueError(
                    f"DtypePolicy.{slot}={name!r} is not a known dtype "
                    f"name; use one of {sorted(_DTYPE_ITEMSIZE)}")
        acc = self.accumulate
        if acc and acc != ACCUM_COMPENSATED and (
                acc not in _DTYPE_ITEMSIZE or not acc.startswith("float")):
            raise ValueError(
                f"DtypePolicy.accumulate={acc!r} must be '', a float dtype "
                f"name, or {ACCUM_COMPENSATED!r}")
        return self


def resolve_accumulate(name: str) -> Tuple[str, bool]:
    """An accumulate request as ``(dtype name, compensated)``.

    'compensated' and 'float64' both resolve to ``("float32", True)``:
    compensated (Kahan) fp32.  The JAX package keeps fp64 only where jax's
    x64 mode is on, which nothing in this repository turns on, so it too
    runs 'float64' as compensated fp32.  The H100 has fp64 units, but a
    port that accumulated in fp64 would run other kernels on the main path
    than the reference's.  '' and any other float name pass through
    uncompensated."""
    if not name:
        return "", False
    if name in (ACCUM_COMPENSATED, "float64"):
        return "float32", True
    return name, False


class CudaPolicy(NamedTuple):
    """What a policy asks of the cuda engine's policy instances: round float
    inputs to bf16 at load and write float fields in bf16 (``bf16``), and
    fold float sums compensated (``compensated``)."""

    bf16: bool
    compensated: bool


def cuda_policy(pol: Optional[DtypePolicy]) -> CudaPolicy:
    """The cuda engine's reading of ``pol`` for fp32 inputs.  Its kernels
    store in fp32 or bf16 and compute in fp32; sums accumulate in fp32,
    plain or compensated.  Any other policy raises ("not yet ported")."""
    if not pol:
        return CudaPolicy(False, False)
    pol.validate()
    storage, compute = pol.storage or "float32", pol.compute or pol.storage or "float32"
    acc, comp = resolve_accumulate(pol.accumulate)
    if storage not in ("float32", "bfloat16") or compute != "float32" or acc not in ("", "float32"):
        raise ValueError(
            f"cuda engine: dtype policy {pol.tag()} is not yet ported; the kernels' "
            f"policy instances store in float32 or bfloat16, compute in float32 and "
            f"accumulate in float32 (plain or compensated)")
    return CudaPolicy(storage == "bfloat16", comp)


@functools.lru_cache(maxsize=4096)
def divisors(n: int) -> Tuple[int, ...]:
    """All divisors of n, ascending."""
    if n < 1:
        raise ValueError(f"divisors of n >= 1 only, got {n}")
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return tuple(small + large[::-1])


@functools.lru_cache(maxsize=4096)
def choose_vvl(nsites: int, preferred: int = 128, multiple_of: int = 1) -> int:
    """Largest divisor of nsites that is <= preferred and a multiple of
    ``multiple_of``.  When none exists, falls back to ``multiple_of``
    itself, and raises only when even that cannot divide the lattice."""
    best = 0
    for v in divisors(nsites):
        if v > preferred:
            break
        if v % multiple_of == 0:
            best = v
    if best:
        return best
    if multiple_of <= nsites and nsites % multiple_of == 0:
        return multiple_of
    raise ValueError(
        f"no vvl <= {preferred} divides nsites={nsites} and is a multiple "
        f"of {multiple_of}"
    )


def sal_alignment(layouts: Sequence[Layout]) -> int:
    """lcm of the AoSoA short-array lengths a launch touches (1 for none)."""
    align = 1
    for lay in layouts:
        if lay.kind is LayoutKind.AOSOA:
            align = align * lay.sal // math.gcd(align, lay.sal)
    return align


def block_view_ok(in_views: Sequence[Tuple[Layout, int]], out_layouts: Sequence[Layout],
                  interior_inner: int) -> bool:
    """Whether a stencil launch can lower natively on AoSoA blocks
    (``view="block"``), the JAX package's rule.

    in_views        (layout, halo'd inner-plane site count) per external
                    input: ``prod(halo'd lattice[1:])``.
    out_layouts     layout per field output.
    interior_inner  ``prod(lattice[1:])``.

    True iff at least one input is AoSoA and every AoSoA layout in play is
    block-aligned: an input's SAL divides its halo'd inner-plane count, an
    output's SAL the interior one."""
    if not any(lay.kind is LayoutKind.AOSOA for lay, _ in in_views):
        return False
    for lay, halo_inner in in_views:
        if lay.kind is LayoutKind.AOSOA and halo_inner % lay.sal:
            return False
    for lay in out_layouts:
        if lay.kind is LayoutKind.AOSOA and interior_inner % lay.sal:
            return False
    return True


@functools.lru_cache(maxsize=4096)
def choose_slab(x_dim: int, inner_sites: int, vvl: int, site_bytes: int = 0,
                smem_bytes: Optional[int] = None) -> int:
    """The largest divisor ``bx`` of the leading lattice dim whose slab
    (bx * inner_sites sites) stays within ``max(vvl, inner_sites)`` sites,
    further capped at ``smem_bytes // site_bytes`` sites when a byte budget
    is given (``site_bytes``: the launch's input + output bytes a site).
    A single x-plane (bx = 1) is always valid."""
    budget = max(int(vvl), inner_sites)
    if smem_bytes and site_bytes:
        budget = min(budget, max(smem_bytes // site_bytes, 1))
    best = 1
    for bx in divisors(x_dim):
        if bx * inner_sites <= budget:
            best = bx
    return best


def tile_extents(lattice: Sequence[int], bx: int, by: int = 0,
                 bz: int = 0) -> Tuple[int, ...]:
    """Per-dim tile extents: ``bx`` planes on the leading dim, ``by``/``bz``
    on the next two when set (0 = whole axis), every further dim whole."""
    ext = [bx or lattice[0]]
    if len(lattice) > 1:
        ext.append(by or lattice[1])
    if len(lattice) > 2:
        ext.append(bz or lattice[2])
    ext.extend(lattice[3:])
    return tuple(ext)


def resolved_smem_bytes(config) -> Optional[int]:
    """The shared-memory byte budget in effect: an explicit
    ``TargetConfig.smem_bytes`` wins, else ``$TARGETDP_TORCH_SMEM_BYTES``,
    else None (unbounded).  0 means unbounded; a non-integer variable is
    ignored with a warning."""
    sb = getattr(config, "smem_bytes", None)
    if sb is not None:
        return int(sb) or None
    env = os.environ.get(SMEM_ENV, "")
    if env:
        try:
            return int(env) or None
        except ValueError:
            log.warning("ignoring non-integer $%s=%r", SMEM_ENV, env)
    return None


def estimate_smem_bytes(plan: "LoweringPlan", *, lattice: Sequence[int],
                        in_views: Sequence[Tuple[int, int, int]],
                        out_views: Sequence[Tuple[int, int]] = ()) -> int:
    """The JAX package's per-program footprint model of a stencil launch,
    in bytes.

    in_views    (ncomp, halo ring, itemsize) per external input
    out_views   (ncomp, itemsize) per field output

    Untiled plans stage every input whole (the halo'd lattice) plus one
    output slab.  Tiled plans hold two halo'd tile windows per input (the
    double-buffered copy slots) plus one output tile.  With no
    ``out_views`` the tiled figure is the two window slots alone, the
    plan-time check of a tiled cuda launch (K9 itself holds no window and
    no shared memory: ``csrc/lb_tiled.cu``).  A plan with a storage
    :class:`DtypePolicy` is priced at the storage itemsize, as the JAX
    package prices it."""
    bx = plan.bx or lattice[0]
    tiled = bool(plan.by or plan.bz)
    if plan.dtypes is not None and plan.dtypes.storage:
        in_views = [(nc, ring, plan.dtypes.storage_itemsize(isz)) for nc, ring, isz in in_views]
        out_views = [(nc, plan.dtypes.storage_itemsize(isz)) for nc, isz in out_views]
    total = 0
    for ncomp, ring, isz in in_views:
        if tiled:
            win = [s + 2 * ring for s in tile_extents(lattice, bx, plan.by, plan.bz)]
            total += 2 * ncomp * math.prod(win) * isz
        else:
            total += ncomp * math.prod(s + 2 * ring for s in lattice) * isz
    tile_sites = math.prod(tile_extents(lattice, bx, plan.by, plan.bz))
    for ncomp, isz in out_views:
        total += ncomp * tile_sites * isz
    return total


def choose_tiles(lattice: Sequence[int], bx: int, *,
                 in_views: Sequence[Tuple[int, int, int]],
                 out_views: Sequence[Tuple[int, int]],
                 smem_bytes: int,
                 dtypes: Optional[DtypePolicy] = None) -> Tuple[int, int]:
    """The largest (by, bz) tile whose estimated footprint fits the budget,
    preferring to keep the minor (z) axis whole on ties.  (0, 0) when the
    untiled staging already fits; the finest tile when nothing fits.
    ``dtypes`` prices the probe at the policy's storage itemsize."""

    def fp(by, bz):
        probe = LoweringPlan("cuda", bx=bx, by=by, bz=bz, dtypes=dtypes)
        return estimate_smem_bytes(probe, lattice=lattice, in_views=in_views,
                                   out_views=out_views)

    if fp(0, 0) <= smem_bytes:
        return (0, 0)
    bys = list(divisors(lattice[1])) if len(lattice) > 1 else [0]
    bzs = list(divisors(lattice[2])) if len(lattice) > 2 else [0]
    pairs = [(by, bz) for by in bys for bz in bzs]
    pairs.sort(key=lambda p: ((p[0] or 1) * (p[1] or 1), p[1] or 1), reverse=True)
    for by, bz in pairs:
        by_eff = 0 if (len(lattice) > 1 and by == lattice[1]) else by
        bz_eff = 0 if (len(lattice) > 2 and bz == lattice[2]) else bz
        if not (by_eff or bz_eff):
            continue  # the untiled probe already failed
        if fp(by_eff, bz_eff) <= smem_bytes:
            return (by_eff, bz_eff)
    return (1 if len(lattice) > 1 and lattice[1] > 1 else 0,
            1 if len(lattice) > 2 and lattice[2] > 1 else 0)


@dataclasses.dataclass(frozen=True)
class LoweringPlan:
    """One launch's lowering decisions: the engine, the block size and the
    stencil tiles (0 = whole axis)."""

    engine: str = "torch"
    vvl: int = 0
    bx: int = 0
    by: int = 0
    bz: int = 0
    # the mixed-precision policy (None: the policy-free lowering)
    dtypes: Optional[DtypePolicy] = None
    # the canonical-view strategy of a stencil launch (see the module
    # docstring); "auto" resolves per launch (adapt_plan)
    view: str = VIEW_AUTO
    # the split-reduction factor: terminal reductions fold their partial
    # rows in rsplit segments, combined in index order (cuda engine only)
    rsplit: int = 1
    # the halo strategy of a stencil launch (see the module docstring)
    halo: str = "periodic"

    @property
    def tiled(self) -> bool:
        return bool(self.by or self.bz)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "LoweringPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if isinstance(d.get("dtypes"), dict):
            d["dtypes"] = DtypePolicy(**{k: v for k, v in d["dtypes"].items()
                                         if k in ("storage", "compute", "accumulate")})
        return cls(**d)

    def describe(self, footprint: Optional[int] = None) -> str:
        """Short label; ``footprint`` (bytes, from
        :func:`estimate_smem_bytes`) appends the shared memory a block
        needs."""
        fp = f" [~{footprint / 1024:.0f}KiB/block]" if footprint else ""
        dt = ("/overlap" if self.halo == "overlap" else "") + (
            f"/dt={self.dtypes.tag()}" if self.dtypes else "")
        if self.engine != "cuda":
            return self.engine + dt + fp
        knob = f"bx={self.bx}" if self.bx else f"vvl={self.vvl}"
        tile = (f"/ty{self.by}" if self.by else "") + (f"/tz{self.bz}" if self.bz else "")
        # the view is named on stencil (bx) plans, the split whenever it is
        # in play, as in the JAX package's labels
        view = "/block" if (self.bx and self.view == VIEW_BLOCK) else ""
        rs = f"/rs{self.rsplit}" if self.rsplit > 1 else ""
        return f"cuda/{knob}{tile}{view}{rs}{dt}{fp}"

    def validate(
        self,
        *,
        nsites: Optional[int] = None,
        lattice: Optional[Tuple[int, ...]] = None,
        layouts: Sequence[Layout] = (),
        stencil: bool = False,
    ) -> "LoweringPlan":
        """Check this plan against a concrete launch (one lattice of it, for
        a batched launch); raises ValueError with the violated rule.
        Returns self (chainable)."""
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; have {ENGINES}")
        if self.view not in (VIEW_AUTO, VIEW_BLOCK, VIEW_STAGED_ND):
            raise ValueError(f"unknown canonical-view strategy {self.view!r}")
        if self.halo not in HALOS:
            raise ValueError(f"halo must be 'periodic', 'pre' or 'overlap', got {self.halo!r}")
        if self.halo == "overlap" and not stencil:
            raise ValueError(
                "halo='overlap' applies only to stencil graphs: a site-local graph has no "
                "halo exchange to overlap (add a stencil stage or use the default halo)")
        if self.rsplit < 1:
            raise ValueError(f"rsplit must be >= 1, got {self.rsplit}")
        if self.dtypes is not None:
            self.dtypes.validate()
        if min(self.bx, self.by, self.bz) < 0:
            raise ValueError(
                f"tile extents must be >= 0 (0 = whole axis), got bx={self.bx} "
                f"by={self.by} bz={self.bz}")
        if self.engine == "torch":
            if self.rsplit > 1:
                raise ValueError(
                    "rsplit > 1 splits the cuda reduction grid into stage-1 partial "
                    "segments; the torch engine folds whole-lattice tensors and has "
                    "no grid to split")
            if self.tiled:
                raise ValueError(
                    "by/bz tile the cuda stencil grid; the torch engine runs "
                    "whole-lattice ops and has no grid to tile")
            return self
        if not stencil:
            if self.bx:
                raise ValueError(f"site-local lowering takes no x-slab (bx={self.bx})")
            if self.tiled:
                raise ValueError(
                    f"site-local lowering takes no y/z tiles (by={self.by}, "
                    f"bz={self.bz}); tiles partition the halo'd stencil grid")
            if self.view not in (VIEW_AUTO, VIEW_BLOCK):
                raise ValueError(
                    "site-local lowering packs/unpacks per-block inside the "
                    "kernel (view='block')")
        else:
            self._validate_tiles(lattice)
            if (self.rsplit > 1 and self.bx and lattice is not None
                    and (lattice[0] // self.bx) % self.rsplit):
                raise ValueError(
                    f"rsplit={self.rsplit} must divide the x-slab count "
                    f"{lattice[0] // self.bx} (bx={self.bx} over lattice[0]="
                    f"{lattice[0]}) so every stage-1 partial covers a whole "
                    f"number of slabs")
            if self.view == VIEW_BLOCK and layouts and not any(
                    lay.kind is LayoutKind.AOSOA for lay in layouts):
                raise ValueError(
                    "view='block' lowers stencil graphs natively on AoSoA tiles, "
                    "but no launch layout is AoSoA; use view='staged-nd' (the "
                    "per-input block alignment is checked at launch, where halo "
                    "rings are known)")
        if self.tiled:
            return self  # the tiled kernels choose their own block size
        if self.vvl < WARP or self.vvl % WARP or self.vvl > MAX_BLOCK:
            raise ValueError(
                f"vvl={self.vvl} sites per CUDA block must be a multiple of "
                f"{WARP} in [{WARP}, {MAX_BLOCK}]")
        if nsites is not None and nsites % self.vvl:
            raise ValueError(f"vvl={self.vvl} must divide nsites={nsites}")
        # an untiled stencil plan without an x-slab splits the kernels'
        # site blocks, as a site-local one does
        if (self.rsplit > 1 and nsites is not None and not (stencil and self.bx)
                and (nsites // self.vvl) % self.rsplit):
            raise ValueError(
                f"rsplit={self.rsplit} must divide the site-block count "
                f"{nsites // self.vvl} (vvl={self.vvl} over nsites={nsites}) so "
                f"every stage-1 partial covers a whole number of blocks")
        for lay in layouts:
            if lay.kind is LayoutKind.AOSOA and self.vvl % lay.sal:
                raise ValueError(
                    f"vvl={self.vvl} must be a multiple of AoSoA sal={lay.sal}")
        return self

    def _validate_tiles(self, lattice: Optional[Tuple[int, ...]]) -> None:
        for d, name, ext in ((1, "by", self.by), (2, "bz", self.bz)):
            if not ext or lattice is None:
                continue
            if len(lattice) <= d:
                raise ValueError(
                    f"{name}={ext} tiles lattice dim {d}, but the lattice "
                    f"{lattice} has no {'yz'[d - 1]} axis")
            if lattice[d] % ext:
                raise ValueError(
                    f"{name}={ext} must divide the {'yz'[d - 1]} lattice dim "
                    f"{lattice[d]} so the tile cover is exact and disjoint")
        if self.tiled and self.bx < 1:
            raise ValueError(
                f"a tiled stencil plan needs an x-slab bx >= 1, got plan "
                f"{self.describe()}")
        if self.bx and lattice is not None and lattice[0] % self.bx:
            raise ValueError(
                f"bx={self.bx} must divide the leading lattice dim {lattice[0]}")


def adapt_plan(plan: LoweringPlan, *, stencil: bool, halo: str = "periodic") -> LoweringPlan:
    """Fit an explicit plan to a concrete launch.  ``halo`` is the call
    site's strategy, which is authoritative, as in the JAX package, with one
    exception: "pre" and "overlap" take the same inputs, so a plan that
    chose "overlap" (a tuned winner) upgrades a stencil launch called under
    "pre" to the split schedule; under "overlap" the sub-launches are
    planned by :func:`sub_lattice_plan`.  The view follows the JAX package's
    ``adapt_plan``: a site-local launch is always "block"; a stencil launch
    keeps an explicit view on the cuda engine (an explicit "block" that
    cannot lower fails loudly at launch), and "auto", or any view on the
    torch engine, resolves to "staged-nd".

    One difference: an untiled plan's x-slab ``bx`` is dropped for a
    site-local launch, so one explicit stencil plan (``bx`` set) can drive
    every launch of a solve or a step.  The JAX package's site-local
    validation raises on it; the port's untiled kernels ignore ``bx``
    anyway.  A tiled plan keeps it and still raises there."""
    if halo not in HALOS:
        raise ValueError(f"halo must be 'periodic', 'pre' or 'overlap', got {halo!r}")
    eff = "overlap" if (halo == "pre" and plan.halo == "overlap" and stencil) else halo
    if not stencil:
        view = VIEW_BLOCK
    elif plan.engine != "cuda" or plan.view == VIEW_AUTO:
        view = VIEW_STAGED_ND
    else:
        view = plan.view
    bx = plan.bx if (stencil or plan.tiled) else 0
    if (view, bx, eff) != (plan.view, plan.bx, plan.halo):
        plan = dataclasses.replace(plan, view=view, bx=bx, halo=eff)
    return plan


def plan_tile(plan: Optional[LoweringPlan]) -> Optional[Tuple[int, int, int]]:
    """A plan's tile (bx, by, bz; 0 a whole axis) where it is tiled, else
    None: what the tiled "pre" kernels take."""
    return (plan.bx, plan.by, plan.bz) if plan is not None and plan.tiled else None


def sub_lattice_plan(plan: LoweringPlan, config, lattice: Tuple[int, ...], *,
                     halo: str = "pre") -> LoweringPlan:
    """Fit a stencil plan to a sub-lattice, the JAX package's rule: how
    ``core.overlap`` plans its interior and boundary sub-launches.  The
    engine, block size and policy stay; ``bx`` stays where it divides the
    sub-lattice's leading extent, else the largest conforming slab is
    chosen again; the view drops to "staged-nd" (the sub-launches' windows
    are SoA) and ``rsplit`` to 1 (the split combines per-box partials
    itself).  The y/z tiles are kept where they still divide the
    sub-lattice, else dropped to the whole axis (a thin slab, usually); the
    cuda engine's box kernels walk a box's sites in the tiles its sub-plan
    keeps."""

    def _tiles(lat):
        by = plan.by if (plan.by and len(lat) > 1 and lat[1] % plan.by == 0) else 0
        bz = plan.bz if (plan.bz and len(lat) > 2 and lat[2] % plan.bz == 0) else 0
        return by, bz

    if plan.engine != "cuda":
        return dataclasses.replace(plan, halo=halo, rsplit=1)
    by, bz = _tiles(lattice)
    if plan.bx >= 1 and lattice[0] % plan.bx == 0:
        return dataclasses.replace(plan, halo=halo, view=VIEW_STAGED_ND, rsplit=1, by=by, bz=bz)
    bx = choose_slab(lattice[0], int(math.prod(lattice[1:])),
                     max(int(getattr(config, "vvl", 128)), 1))
    return dataclasses.replace(plan, halo=halo, bx=bx, view=VIEW_STAGED_ND, rsplit=1, by=by,
                               bz=bz)


def _rsplit_factors(nblocks: int, cap: int = 16, k: int = 2):
    """Split-reduction factors worth sweeping for a grid of ``nblocks``
    blocks: up to ``k`` divisors > 1, preferring those <= ``cap``, evenly
    spread; empty for a single block (the JAX package's rule)."""
    rs = [r for r in divisors(nblocks) if r > 1]
    capped = [r for r in rs if r <= cap]
    return _spread(capped or rs[:1], k)


def _spread(values, k: int):
    """A deterministic evenly spaced subset of size <= k (both ends kept)."""
    if len(values) <= k:
        return list(values)
    if k <= 1:
        return [values[-1]]
    idx = {round(i * (len(values) - 1) / (k - 1)) for i in range(k)}
    return [values[i] for i in sorted(idx)]


def _site_bytes(smem_views) -> int:
    """Input + output bytes a site, from a (in_views, out_views)
    footprint descriptor (see :func:`estimate_smem_bytes`)."""
    in_views, out_views = smem_views
    return (sum(ncomp * isz for ncomp, _ring, isz in in_views)
            + sum(ncomp * isz for ncomp, isz in out_views))


def default_plan(config, *, nsites: int, layouts: Sequence[Layout],
                 stencil: bool = False, lattice: Optional[Tuple[int, ...]] = None,
                 smem_views=None, bounded: bool = False,
                 halo: str = "periodic") -> LoweringPlan:
    """The heuristic plan.  The torch engine lowers whole-lattice; the cuda
    engine takes the largest block size <= ``config.vvl`` that divides the
    lattice and is a multiple of a warp and of every AoSoA SAL the launch
    touches (falling back to that multiple itself, as the JAX package's
    ``resolve_vvl`` does).  ``bounded``: the launch's kernels check the
    bounds of their last block (the ``halo="pre"`` kernels), so where no
    such multiple divides the lattice the block is ``config.vvl`` rounded
    down to one.  A cuda stencil launch with a shared-memory budget
    and its footprint descriptor ``smem_views = (in_views, out_views)``
    also gets bx from :func:`choose_slab` and (by, bz) from
    :func:`choose_tiles`; without a budget the plan is the untiled one.  A
    batched launch plans one lattice.  The plan carries the launch's
    ``halo`` strategy, as the JAX package's does."""
    if config.engine == "torch":
        return LoweringPlan("torch", halo=halo)
    if config.engine != "cuda":
        raise ValueError(f"unknown engine {config.engine!r}; have {ENGINES}")
    align = sal_alignment(layouts)
    mult = align * WARP // math.gcd(align, WARP)
    if bounded and nsites % mult:
        vvl = max(mult, min(config.vvl, MAX_BLOCK) // mult * mult)
    else:
        vvl = choose_vvl(nsites, max(config.vvl, WARP), multiple_of=mult)
    checked = None if bounded else nsites
    budget = resolved_smem_bytes(config) if stencil else None
    if budget and smem_views:
        if lattice is None:
            raise ValueError("stencil plans need the lattice shape")
        bx = choose_slab(lattice[0], math.prod(lattice[1:]), config.vvl,
                         _site_bytes(smem_views), budget)
        by, bz = choose_tiles(lattice, bx, in_views=smem_views[0],
                              out_views=smem_views[1], smem_bytes=budget)
        return LoweringPlan("cuda", vvl=vvl, bx=bx, by=by, bz=bz, halo=halo).validate(
            nsites=checked, lattice=lattice, layouts=layouts, stencil=True)
    return LoweringPlan("cuda", vvl=vvl, halo=halo).validate(nsites=checked, layouts=layouts,
                                                            stencil=stencil)


def policy_plan(config) -> Optional[LoweringPlan]:
    """The explicit plan of ``config.plan_policy``, or None for "default"
    and "tuned" (a LaunchGraph launch looks "tuned" up in the table,
    ``core.tune``; every other launch plans with the default heuristics,
    as in the JAX package)."""
    policy = getattr(config, "plan_policy", "default")
    if isinstance(policy, LoweringPlan):
        return policy
    if policy not in ("default", "tuned"):
        raise ValueError(
            f"unknown plan_policy {policy!r}; use 'default', 'tuned' or an "
            f"explicit LoweringPlan")
    return None


def launch_policy(config, plan: Optional[LoweringPlan] = None) -> Tuple[str, Optional[DtypePolicy]]:
    """The engine and DtypePolicy of a launch under ``config`` on ``plan``
    (by default the explicit plan of ``config.plan_policy``, if any): the
    plan's engine, and its policy where it carries one, else the config's."""
    if plan is None:
        plan = policy_plan(config)
    if plan is None:
        return config.engine, config.dtypes
    return plan.engine, plan.dtypes if plan.dtypes is not None else config.dtypes


def plan_for_launch(config, nsites: int, layouts: Sequence[Layout],
                    bounded: bool = False) -> LoweringPlan:
    """Plan one site-local launch: the explicit plan of
    ``config.plan_policy`` (validated) or :func:`default_plan` (also under
    "tuned": a single launch has no graph signature to key the table on).
    ``bounded`` as :func:`default_plan`'s: vvl need not divide nsites."""
    plan = policy_plan(config)
    if plan is not None:
        if plan.bx and not plan.tiled:   # adapt_plan's site-local fit
            plan = dataclasses.replace(plan, bx=0)
        return plan.validate(nsites=None if bounded else nsites, layouts=layouts)
    return default_plan(config, nsites=nsites, layouts=layouts, bounded=bounded)


# -- the autotuner's candidate set --------------------------------------------------

def _dtype_twin_policies(in_dtype: Optional[str]):
    """Dtype-policy twins worth sweeping for a launch whose float inputs
    share ``in_dtype`` (the JAX package's rule): narrower storage, fp32
    compute and float64 accumulation (compensated fp32, resolve_accumulate).
    The tuner's accuracy gate rejects any twin that drifts past it."""
    if in_dtype == "float32":
        return [DtypePolicy(storage="bfloat16", compute="float32", accumulate="float64")]
    if in_dtype == "float64":
        return [DtypePolicy(storage="float32", compute="float32", accumulate="float64")]
    return []


def _world_size() -> int:
    """The ranks of the default process group (a mesh's), 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def candidate_plans(config, *, nsites: int, layouts: Sequence[Layout],
                    stencil: bool = False, lattice: Optional[Tuple[int, ...]] = None,
                    halo: str = "periodic", max_candidates: int = 8,
                    devices: Optional[int] = None, block_view: Optional[bool] = None,
                    batch: int = 0, reduce: bool = False, smem_views=None,
                    in_dtype: Optional[str] = None) -> Tuple[LoweringPlan, ...]:
    """The autotuner's sweep set for one launch, deterministically: the JAX
    package's ``candidate_plans`` on the cuda engine, the default plan
    first.  The torch engine has nothing to sweep: its one candidate is the
    default plan.

    Site-local: vvl over the divisors of nsites that are whole warps and
    multiples of every AoSoA SAL in play, up to 8x the heuristic budget
    (and a block's 1024 threads), evenly spread.  Stencil: bx over the
    divisors of the leading lattice dim, up to 8x the slab budget, on the
    default's vvl.  The untiled kernels run vvl blocks whatever bx says, so
    the untiled bx candidates launch the default's kernel (the min_gain
    hysteresis keeps the default among them); they stay in the set, which
    is the reference's.  For the same reason an untiled default stencil
    plan carries the reference's slab ``choose_slab(lattice[0], ...)``
    here, the bx its split and view twins derive from.

    Twins, as in the reference: two ``view="block"`` ones (the default slab
    and the widest swept) where ``block_view`` (None: an AoSoA layout is in
    play); ``rsplit`` ones on a launch with a terminal reduction
    (``reduce``); up to two tiled ones on a stencil lattice with a y (and
    z) axis; and the dtype-policy twins of ``in_dtype``
    (:func:`_dtype_twin_policies`).  A sharded stencil launch (``halo=
    "pre"``, more than one rank and no ``batch``) also gets two
    ``halo="overlap"`` twins, the default slab and the widest swept one;
    ``devices`` defaults to the world size of the default process group
    (the mesh's), so one card proposes none.  Every candidate carries the
    launch's ``halo``.  With a shared-memory budget and the launch's
    footprint descriptor ``smem_views``, a stencil candidate whose
    estimated footprint exceeds the budget is dropped and logged; if no
    untiled slab fits, the set is tiled only."""
    # the "pre" kernels check their last block's bounds, as the launch plans
    bounded = halo in ("pre", "overlap")
    default = default_plan(config, nsites=nsites, layouts=layouts, stencil=stencil,
                           lattice=lattice, smem_views=smem_views, bounded=bounded, halo=halo)
    if default.engine != "cuda":
        return (default,)
    if stencil:
        inner = math.prod(lattice[1:])
        budget = max(int(config.vvl), inner)
        smem_budget = resolved_smem_bytes(config)
        if not default.bx:
            default = dataclasses.replace(
                default, bx=choose_slab(lattice[0], inner, config.vvl))
        untiled_default = (dataclasses.replace(default, by=0, bz=0) if default.tiled
                           else default)

        def over_budget(c):
            if not (smem_budget and smem_views):
                return False
            fp = estimate_smem_bytes(c, lattice=lattice, in_views=smem_views[0],
                                     out_views=smem_views[1])
            if fp <= smem_budget:
                return False
            log.info("candidate %s skipped: estimated per-block shared memory %d B "
                     "exceeds budget %d B", c.describe(footprint=fp), fp, smem_budget)
            return True

        bxs = [bx for bx in divisors(lattice[0])
               if bx * inner <= 8 * budget
               and not over_budget(dataclasses.replace(untiled_default, bx=bx))]
        bxs = bxs or ([] if default.tiled else [default.bx])
        if devices is None:
            devices = _world_size()
        with_overlap = halo == "pre" and devices > 1 and not batch
        if block_view is None:
            block_view = any(lay.kind is LayoutKind.AOSOA for lay in layouts)
        # split twins off the default geometry (or the narrowest swept slab
        # when the default lowers the whole extent as one slab)
        red_twins = []
        if reduce:
            base = default
            if bxs and lattice[0] // base.bx < 2 and min(bxs) < base.bx:
                base = dataclasses.replace(default, bx=min(bxs))
            red_twins = [dataclasses.replace(base, rsplit=r)
                         for r in _rsplit_factors(lattice[0] // base.bx)]
        # tiled twins: the default slab with y split, and with y and z split
        tile_twins = []
        if len(lattice) > 1 and len(divisors(lattice[1])) > 1:
            t1 = dataclasses.replace(default, by=divisors(lattice[1])[-2], bz=0)
            tile_twins.append(t1)
            if len(lattice) > 2 and len(divisors(lattice[2])) > 1:
                tile_twins.append(dataclasses.replace(t1, bz=divisors(lattice[2])[-2]))
        tile_twins = [t for t in tile_twins if t != default and not over_budget(t)]
        dtype_twins = [dataclasses.replace(default, dtypes=p)
                       for p in _dtype_twin_policies(in_dtype)]
        dtype_twins = [t for t in dtype_twins if not over_budget(t)]
        n_twins = ((2 if with_overlap else 0) + (2 if block_view else 0) + len(red_twins)
                   + len(tile_twins) + len(dtype_twins))
        spread_bxs = _spread(bxs, max(1, max_candidates - n_twins))
        cands = [dataclasses.replace(untiled_default, bx=bx) for bx in spread_bxs]
        twin_bxs = sorted({default.bx, *spread_bxs[-1:]})[:2]
        if with_overlap:
            cands += [dataclasses.replace(default, bx=bx, halo="overlap") for bx in twin_bxs]
        if block_view:
            cands += [dataclasses.replace(default, bx=bx, view=VIEW_BLOCK) for bx in twin_bxs]
        cands += red_twins + tile_twins + dtype_twins
    else:
        align = sal_alignment(layouts)
        align = align * WARP // math.gcd(align, WARP)
        cap = min(8 * max(int(config.vvl), 128), MAX_BLOCK)
        vs = [v for v in divisors(nsites) if v % align == 0 and v <= cap] or [default.vvl]
        red_twins = []
        if reduce:
            base = default
            if nsites // base.vvl < 2 and vs[0] < base.vvl:
                base = dataclasses.replace(default, vvl=vs[0])
            red_twins = [dataclasses.replace(base, rsplit=r)
                         for r in _rsplit_factors(nsites // base.vvl)]
        dtype_twins = [dataclasses.replace(default, dtypes=p)
                       for p in _dtype_twin_policies(in_dtype)]
        k = max(1, max_candidates - len(red_twins) - len(dtype_twins))
        cands = [dataclasses.replace(default, vvl=v) for v in _spread(vs, k)]
        cands += red_twins + dtype_twins
    out = [default]
    for c in cands:
        if c not in out:
            out.append(c)
    for c in out:
        c.validate(nsites=None if bounded else nsites, lattice=lattice, layouts=layouts,
                   stencil=stencil)
    return tuple(out[:max_candidates + 1])


def graph_plan_key(signature, *, engine: str, halo: str, outputs: Sequence[str], inputs,
                   lattice: Tuple[int, ...], backend: str, batch=0) -> str:
    """The tune table's key of one launch: (graph signature, input names,
    widths, dtypes, layouts and lattices, lattice, engine, halo, outputs,
    backend, batch) hashed, behind a readable prefix.  The signature must be
    process-stable: kernel names and wiring, never function objects
    (``LaunchGraph.plan_signature``).  ``batch`` is the batched launch's
    (batch size, per-input batched flags); 0 for a single launch."""
    parts = (signature, engine, halo, tuple(outputs), tuple(inputs), tuple(lattice), backend)
    if batch:
        parts = parts + (batch,)
    digest = hashlib.sha256(repr(parts).encode()).hexdigest()[:16]
    name = signature[0] if isinstance(signature, tuple) and signature else "g"
    return f"{name}|{backend}|{engine}|{digest}"

"""Lowering plans: every launch decision as one explicit, hashable value.

The subset the single-device MILC solve needs.  A :class:`LoweringPlan`
names the engine and the block size:

  engine "torch"  whole-lattice torch ops (the counterpart of the JAX
                  package's "jnp" engine, and the oracle);
  engine "cuda"   the hand-written kernels under ``repro_torch/csrc``.
  vvl             sites per CUDA block (one thread per site).  Unused by
                  the torch engine.

The TPU-only decisions of the JAX package (interpret mode, the VMEM budget
and its tiles, x-slabs, canonical views, split reductions, dtype policies)
have no meaning here or are not yet ported, and so are explicit and
autotuned plan policies.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

from .layout import Layout, LayoutKind

__all__ = ["LoweringPlan", "divisors", "choose_vvl", "default_plan",
           "plan_for_launch", "ENGINES", "WARP", "MAX_BLOCK"]

ENGINES = ("torch", "cuda")
WARP = 32          # a CUDA block is a whole number of warps
MAX_BLOCK = 1024   # the most threads one CUDA block may hold


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


@dataclasses.dataclass(frozen=True)
class LoweringPlan:
    """One launch's lowering decisions: the engine and the block size."""

    engine: str = "torch"
    vvl: int = 0

    def validate(
        self,
        *,
        nsites: Optional[int] = None,
        layouts: Sequence[Layout] = (),
    ) -> "LoweringPlan":
        """Check this plan against a concrete launch; raises ValueError with
        the violated rule.  Returns self (chainable)."""
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; have {ENGINES}")
        if self.engine == "torch":
            return self
        if self.vvl < WARP or self.vvl % WARP or self.vvl > MAX_BLOCK:
            raise ValueError(
                f"vvl={self.vvl} sites per CUDA block must be a multiple of "
                f"{WARP} in [{WARP}, {MAX_BLOCK}]")
        if nsites is not None and nsites % self.vvl:
            raise ValueError(f"vvl={self.vvl} must divide nsites={nsites}")
        for lay in layouts:
            if lay.kind is not LayoutKind.SOA:
                raise ValueError(
                    f"the cuda engine's kernels take SoA fields only; layout "
                    f"{lay.name} is not yet ported")
        return self


def default_plan(config, *, nsites: int, layouts: Sequence[Layout]) -> LoweringPlan:
    """The heuristic plan: the torch engine lowers whole-lattice; the cuda
    engine takes the largest whole-warp block size <= ``config.vvl`` that
    divides the lattice."""
    if config.engine == "torch":
        return LoweringPlan("torch")
    if config.engine != "cuda":
        raise ValueError(f"unknown engine {config.engine!r}; have {ENGINES}")
    vvl = choose_vvl(nsites, max(config.vvl, WARP), multiple_of=WARP)
    return LoweringPlan("cuda", vvl=vvl).validate(nsites=nsites, layouts=layouts)


def plan_for_launch(config, nsites: int, layouts: Sequence[Layout]) -> LoweringPlan:
    """Plan one launch: :func:`default_plan` (explicit and autotuned plan
    policies are not yet ported)."""
    return default_plan(config, nsites=nsites, layouts=layouts)

"""Data-layout abstraction: the PyTorch analogue of the targetDP ``INDEX()`` macro.

The paper (Gray & Stratford 2016, §3.1) abstracts the linearization of
multi-valued lattice data — ``ncomp`` numerical components stored at each of
``nsites`` lattice sites — behind a macro so the layout can be switched per
architecture without touching application code:

  AoS    |rgb|rgb|rgb|rgb|          index = site*ncomp + comp
  SoA    |rrrr|gggg|bbbb|           index = comp*nsites + site
  AoSoA  ||rr|gg|bb|||rr|gg|bb||    index = (site/SAL)*ncomp*SAL
                                            + comp*SAL + (site - (site/SAL)*SAL)

A layout is the axis *order* of a contiguous (row-major) ``torch.Tensor``:

  SoA    physical shape (ncomp, nsites)
  AoS    physical shape (nsites, ncomp)
  AoSoA  physical shape (nsites//SAL, ncomp, SAL)

The canonical (logical) view every kernel body sees is ``(ncomp, nsites)``.
``pack`` always returns a contiguous tensor, so the flat memory order of the
physical array is the paper's linearization; ``unpack`` returns a view.

The hand-written CUDA kernels take every layout: each kernel receives a
tensor's layout as one int (:meth:`Layout.descriptor`) and addresses
component c of site s through INDEX (``rt_index`` in ``csrc/common.cuh``),
one thread per site (or element) in every layout.  On the GPU, SoA (and
AoSoA with SAL >= 32) puts neighbouring sites of one component at
neighbouring addresses, so a warp's loads coalesce; under AoS they lie
ncomp floats apart.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

__all__ = ["LayoutKind", "Layout", "AOS", "SOA", "aosoa", "tileable_layout",
           "parse_layout", "resolve_layouts"]

# Layout.descriptor()'s kind codes (RT_SOA, RT_AOS, RT_AOSOA in csrc/common.cuh)
_KIND_CODE = {"soa": 0, "aos": 1, "aosoa": 2}


class LayoutKind(enum.Enum):
    AOS = "aos"
    SOA = "soa"
    AOSOA = "aosoa"


@dataclasses.dataclass(frozen=True)
class Layout:
    """A concrete data layout: kind + short-array length (AoSoA only)."""

    kind: LayoutKind
    sal: int = 1

    def __post_init__(self):
        if self.kind is LayoutKind.AOSOA and self.sal < 1:
            raise ValueError(f"AoSoA needs sal >= 1, got {self.sal}")

    def physical_shape(self, ncomp: int, nsites: int) -> Tuple[int, ...]:
        if self.kind is LayoutKind.SOA:
            return (ncomp, nsites)
        if self.kind is LayoutKind.AOS:
            return (nsites, ncomp)
        if nsites % self.sal:
            raise ValueError(
                f"AoSoA(sal={self.sal}) requires sal | nsites, got nsites={nsites}"
            )
        return (nsites // self.sal, ncomp, self.sal)

    @property
    def physical_ndim(self) -> int:
        """The rank of a field's physical tensor in this layout (AoSoA's
        short arrays add one axis)."""
        return 3 if self.kind is LayoutKind.AOSOA else 2

    def logical_shape(self, physical_shape) -> Tuple[int, int]:
        """(ncomp, nsites) of a physical tensor of this layout's shape."""
        shape = tuple(int(n) for n in physical_shape)
        want = self.physical_ndim
        if len(shape) != want or (want == 3 and shape[2] != self.sal):
            raise ValueError(f"shape {shape} is not a {self.name} physical shape")
        if self.kind is LayoutKind.SOA:
            return shape
        if self.kind is LayoutKind.AOS:
            return shape[1], shape[0]
        return shape[1], shape[0] * shape[2]

    def descriptor(self) -> int:
        """This layout as the CUDA kernels take it: ``kind | sal << 2``
        with kind 0 SoA, 1 AoS, 2 AoSoA (``rt_make_layout`` in
        ``csrc/common.cuh`` decodes it)."""
        code = _KIND_CODE[self.kind.value]
        return code | (self.sal << 2) if self.kind is LayoutKind.AOSOA else code

    def fits(self, nsites: int) -> bool:
        """Whether this layout can tile ``nsites`` sites (AoSoA needs
        SAL | nsites; SoA/AoS always fit)."""
        return self.kind is not LayoutKind.AOSOA or nsites % self.sal == 0

    def flat_index(self, comp, site, ncomp: int, nsites: int):
        """The paper's INDEX(comp, site) linearization (scalars or integer
        arrays); matches the flat memory order of :meth:`pack`'s output."""
        if self.kind is LayoutKind.SOA:
            return comp * nsites + site
        if self.kind is LayoutKind.AOS:
            return site * ncomp + comp
        sal = self.sal
        return (site // sal) * ncomp * sal + comp * sal + (site - (site // sal) * sal)

    def pack(self, canonical):
        """(ncomp, nsites) canonical -> contiguous physical tensor."""
        ncomp, nsites = canonical.shape
        if self.kind is LayoutKind.SOA:
            return canonical.contiguous()
        if self.kind is LayoutKind.AOS:
            return canonical.T.contiguous()
        sal = self.sal
        if nsites % sal:
            raise ValueError(f"AoSoA(sal={sal}): sal must divide nsites={nsites}")
        return (canonical.reshape(ncomp, nsites // sal, sal)
                .permute(1, 0, 2).contiguous())

    def unpack(self, physical):
        """Physical tensor in this layout -> canonical (ncomp, nsites) view."""
        if self.kind is LayoutKind.SOA:
            return physical
        if self.kind is LayoutKind.AOS:
            return physical.T
        nblk, ncomp, sal = physical.shape
        return physical.permute(1, 0, 2).reshape(ncomp, nblk * sal)

    # -- site blocks (the JAX package's pallas BlockSpec support) --------------
    #
    # A block covers ``vvl`` consecutive sites of every component.  The CUDA
    # kernels address a field through INDEX and need none of these; the
    # block view's validation and the tests use them to hold the port's
    # layouts to the JAX package's blocks bitwise.

    def block_shape(self, ncomp: int, vvl: int) -> Tuple[int, ...]:
        """Physical shape of one block of ``vvl`` sites x all components;
        AoSoA needs sal | vvl, so a block is a whole number of short
        arrays."""
        if self.kind is LayoutKind.SOA:
            return (ncomp, vvl)
        if self.kind is LayoutKind.AOS:
            return (vvl, ncomp)
        if vvl % self.sal:
            raise ValueError(f"AoSoA(sal={self.sal}): sal must divide vvl={vvl}")
        return (vvl // self.sal, ncomp, self.sal)

    def block_index_map(self):
        """Block i of a 1-D site-block grid, in units of :meth:`block_shape`."""
        if self.kind is LayoutKind.SOA:
            return lambda i: (0, i)
        if self.kind is LayoutKind.AOS:
            return lambda i: (i, 0)
        return lambda i: (i, 0, 0)

    def block_to_canonical(self, block, ncomp: int, vvl: int):
        """A physical block -> its canonical (ncomp, vvl) chunk."""
        if self.kind is LayoutKind.SOA:
            return block
        if self.kind is LayoutKind.AOS:
            return block.T
        return block.permute(1, 0, 2).reshape(ncomp, vvl)

    def canonical_to_block(self, chunk, ncomp: int, vvl: int):
        """A canonical (ncomp, vvl) chunk -> its physical block."""
        if self.kind is LayoutKind.SOA:
            return chunk
        if self.kind is LayoutKind.AOS:
            return chunk.T
        if vvl % self.sal:
            raise ValueError(f"AoSoA(sal={self.sal}): sal must divide vvl={vvl}")
        return chunk.reshape(ncomp, vvl // self.sal, self.sal).permute(1, 0, 2)

    @property
    def name(self) -> str:
        if self.kind is LayoutKind.AOSOA:
            return f"aosoa{self.sal}"
        return self.kind.value

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Layout({self.name})"


AOS = Layout(LayoutKind.AOS)
SOA = Layout(LayoutKind.SOA)


def aosoa(sal: int) -> Layout:
    """AoSoA with short-array length ``sal``."""
    return Layout(LayoutKind.AOSOA, sal)


def tileable_layout(layout: Layout, lattice) -> Layout:
    """``layout`` when it can tile this lattice, else SOA (the drivers'
    fallback for halo'd temporaries)."""
    nsites = 1
    for s in lattice:
        nsites *= int(s)
    return layout if layout.fits(nsites) else SOA


def resolve_layouts(layouts, inputs, outputs) -> dict:
    """Name -> Layout of a kernel wrapper's tensors: ``layouts`` (None or a
    mapping) for each name it holds, else SOA for an input and the first
    input's layout for an output."""
    layouts = dict(layouts or {})
    unknown = sorted(set(layouts) - set(inputs) - set(outputs))
    if unknown:
        raise ValueError(f"layouts for unknown tensors {unknown}; the kernel takes "
                         f"{list(inputs) + list(outputs)}")
    out = {n: layouts.get(n, SOA) for n in inputs}
    first = out[inputs[0]]
    out.update({n: layouts.get(n, first) for n in outputs})
    return out


def parse_layout(spec: str) -> Layout:
    """Parse 'aos' | 'soa' | 'aosoa<N>' — the config-file entry point."""
    s = spec.strip().lower()
    if s == "aos":
        return AOS
    if s == "soa":
        return SOA
    if s.startswith("aosoa"):
        return aosoa(int(s[len("aosoa"):] or 128))
    raise ValueError(f"unknown layout spec {spec!r}")

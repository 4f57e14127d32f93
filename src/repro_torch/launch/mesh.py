"""A mesh of ranks over ``torch.distributed``: the decomposed lattice's
device mesh.

The JAX package shards a lattice over a named device mesh under
``shard_map`` (``launch/mesh.py``, ``core/compat.py::make_mesh``).  The
port runs one process a rank, each on its own device, and a :class:`Mesh`
names the ranks' layout: axis names and sizes, ranks numbered row-major
over the axes (the last axis fastest), this rank's coordinates, its
neighbour ranks along each axis (the periodic line of
``core.halo.axis_perms``) and one process group for each set of axes a
solver sums over.

A mesh of one rank needs no process group and starts none.  A larger mesh
joins the default process group: NCCL where its device is a CUDA device,
gloo on the CPU, chosen by the device and never the one in place of the
other; an already initialised group must have that backend.  The rank, the
world size and the local rank come from the arguments or from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); the rendezvous from
``init_method`` (default ``env://``, torchrun's ``MASTER_ADDR`` and
``MASTER_PORT``).  Each rank's device is ``cuda:LOCAL_RANK`` unless the
caller asks for the CPU.

    torchrun --nproc-per-node 4 script.py      # Mesh((2, 2), ("mx", "my"), device="cpu")
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_production_mesh", "batch_axes", "dp_size"]


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None or v == "" else int(v)


class Mesh:
    """A row-major mesh of ``prod(shape)`` ranks with named axes.

    shape        the axis sizes, e.g. (2, 2).
    axis_names   one name an axis, e.g. ("mx", "my").
    rank, world_size, local_rank
                 this process's; default from torchrun's environment (0, 1
                 and 0 when unset).  world_size must be prod(shape).
    device       "cuda" (this rank's ``cuda:local_rank``) or "cpu".
    init_method  the rendezvous of a multi-rank mesh (default "env://").
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None, world_size: Optional[int] = None,
                 local_rank: Optional[int] = None, device: str = "cuda",
                 init_method: Optional[str] = None):
        shape = tuple(int(n) for n in shape)
        names = tuple(str(a) for a in axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names) or min(shape, default=1) < 1:
            raise ValueError(f"mesh shape {shape} and axis names {names} must match, "
                             f"names distinct, sizes >= 1")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.size = math.prod(shape)
        self.rank = _env_int("RANK", 0) if rank is None else int(rank)
        world = _env_int("WORLD_SIZE", 1) if world_size is None else int(world_size)
        if world != self.size:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks, the world has {world}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is outside the mesh's {self.size} ranks")
        self.local_rank = _env_int("LOCAL_RANK", 0) if local_rank is None else int(local_rank)
        if torch.device(device).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Mesh(device='cuda') but torch.cuda.is_available() is false; "
                                   "pass device='cpu' to run the ranks on the CPU")
            self.device = torch.device("cuda", self.local_rank)
            torch.cuda.set_device(self.device)
        else:
            self.device = torch.device(device)
        self.backend = "nccl" if self.device.type == "cuda" else "gloo"
        self.coords: Tuple[int, ...] = self.coords_of(self.rank)
        self._groups: Dict[Tuple[str, ...], object] = {}
        if self.size > 1:
            if dist.is_initialized():
                if dist.get_backend() != self.backend or dist.get_world_size() != self.size:
                    raise RuntimeError(
                        f"the default process group is {dist.get_backend()} over "
                        f"{dist.get_world_size()} ranks; this mesh needs {self.backend} over "
                        f"{self.size}")
            else:
                dist.init_process_group(self.backend, init_method=init_method or "env://",
                                        rank=self.rank, world_size=self.size)

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"

    # -- geometry ----------------------------------------------------------------

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        """The row-major coordinates of ``rank``."""
        out = []
        for n in reversed(tuple(self.shape.values())):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        """The rank at ``coords`` (each taken modulo its axis: periodic)."""
        r = 0
        for c, n in zip(coords, self.shape.values()):
            r = r * n + int(c) % n
        return r

    def axis_index(self, name: str) -> int:
        return self.axis_names.index(name)

    def neighbours(self, name: str) -> Tuple[int, int]:
        """(forward, backward) neighbour ranks along axis ``name``: the
        ranks one step up and down its periodic line
        (``core.halo.axis_perms``), this rank on an axis of size 1."""
        k = self.axis_index(name)
        fwd, bwd = list(self.coords), list(self.coords)
        fwd[k] += 1
        bwd[k] -= 1
        return self.rank_of(fwd), self.rank_of(bwd)

    # -- reductions ----------------------------------------------------------------

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that share this rank's coordinates
        off ``axes``: the ranks a sum over ``axes`` adds.  None where that
        is this rank alone; the default group where it is every rank.  The
        groups of a new set of axes are created on first use, a collective
        call: every rank asks for the same sets in the same order."""
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not mesh axes {self.axis_names}")
        axes = tuple(a for a in self.axis_names if a in set(axes))
        n = math.prod(self.shape[a] for a in axes)
        if n == 1:
            return None
        if n == self.size:
            return dist.group.WORLD
        if axes not in self._groups:
            ks = [self.axis_index(a) for a in axes]
            others = [k for k in range(len(self.axis_names)) if k not in ks]
            sizes = tuple(self.shape.values())
            mine = None
            # every slice's group, created in one order on every rank
            for off in itertools.product(*(range(sizes[k]) for k in others)):
                ranks = []
                for on in itertools.product(*(range(sizes[k]) for k in ks)):
                    c = [0] * len(sizes)
                    for k, v in zip(others, off):
                        c[k] = v
                    for k, v in zip(ks, on):
                        c[k] = v
                    ranks.append(self.rank_of(c))
                g = dist.new_group(ranks=sorted(ranks), backend=self.backend)
                if self.rank in ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axes`` (the JAX package's
        ``lax.psum``), as a new tensor; ``t`` itself where the sum is over
        this rank alone.  The result has the same bits on every rank of
        the group."""
        g = self.group(axes)
        if g is None:
            return t
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
        return out


def make_production_mesh(*, multi_pod: bool = False, **kw) -> Mesh:
    """The JAX package's production mesh: 16 x 16 ranks ("data", "model"),
    or 2 x 16 x 16 with a "pod" axis; ``kw`` as :class:`Mesh`'s."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, **kw)


def batch_axes(mesh: Mesh) -> tuple:
    """Mesh axes that compose the data-parallel (batch) dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_size(mesh: Mesh) -> int:
    n = 1
    for ax in batch_axes(mesh):
        n *= mesh.shape[ax]
    return n

"""Carry Field state, lowering plans and LM parameters between the JAX
package and the port.

A Field crosses as plain numpy data: its physical array, lattice, layout
name and ncomp.  Physical shapes are the same in both packages, so the
numbers pass through unchanged (bitwise).  This module does not import the
JAX package: a caller holding a JAX Field passes ``np.asarray(f.data)``,
``f.lattice``, ``f.layout.name`` and ``f.ncomp`` (a BatchedField likewise,
its physical array carrying the leading batch axis); for a Ludwig state, the
physical arrays of its ``dist`` and ``q`` with their shared lattice and
layout name.  A plan crosses as the JAX package's
``LoweringPlan.to_json()`` dictionary (:func:`to_plan`).  LM parameters
cross as the reference's parameter pytree of numpy arrays
(:func:`to_lm_params`).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.apps.ludwig.driver import LudwigState
from repro_torch.core.field import BatchedField, Field, resolve_device
from repro_torch.core.layout import parse_layout
from repro_torch.core.plan import VIEW_AUTO, DtypePolicy, LoweringPlan

__all__ = ["to_field", "from_field", "to_batched_field", "from_batched_field",
           "to_ludwig_state", "from_ludwig_state", "to_plan", "to_lm_params"]

_ENGINES = {"pallas": "cuda", "jnp": "torch"}


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


def to_batched_field(name: str, physical: np.ndarray, lattice: Sequence[int],
                     layout_name: str, ncomp: int, device="cpu") -> BatchedField:
    """The port's BatchedField holding ``physical`` (bitwise), whose leading
    axis is the batch, on ``device``."""
    physical = np.asarray(physical)
    if physical.ndim < 1:
        raise ValueError(f"{name}: a batched physical array needs a leading batch axis")
    slots = [to_field(f"{name}[{b}]", e, lattice, layout_name, ncomp, device)
             for b, e in enumerate(physical)]
    if not slots:
        raise ValueError(f"{name}: a batch of no fields")
    return BatchedField.stack(slots, name=name)


def from_batched_field(field: BatchedField) -> Tuple[np.ndarray, Tuple[int, ...], str, int]:
    """(physical array with its leading batch axis, lattice, layout name,
    ncomp) of a port BatchedField."""
    return (field.data.detach().cpu().numpy(), field.lattice, field.layout.name,
            field.ncomp)


def to_ludwig_state(dist_phys: np.ndarray, q_phys: np.ndarray, lattice: Sequence[int],
                    layout_name: str, device="cpu") -> LudwigState:
    """The port's LudwigState holding a Ludwig state's physical dist (19
    components) and q (5 components) arrays (bitwise) on ``device``."""
    return LudwigState(dist=to_field("dist", dist_phys, lattice, layout_name, 19, device),
                       q=to_field("q", q_phys, lattice, layout_name, 5, device))


def from_ludwig_state(state: LudwigState) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...], str]:
    """(dist physical array, q physical array, lattice, layout name) of a
    port LudwigState — the inverse of :func:`to_ludwig_state`."""
    dist, lattice, layout_name, _ = from_field(state.dist)
    q, _, _, _ = from_field(state.q)
    return dist, q, lattice, layout_name


def to_plan(ref: Mapping) -> LoweringPlan:
    """The port's plan for a JAX package ``LoweringPlan.to_json()``: engine
    "pallas" -> "cuda" and "jnp" -> "torch"; vvl, bx, by, bz, the view, the
    split factor, the dtype policy and the halo strategy kept; interpret
    dropped."""
    engine = ref.get("engine", "jnp")
    if engine not in _ENGINES:
        raise ValueError(f"unknown reference engine {engine!r}; have {list(_ENGINES)}")
    dt = ref.get("dtypes")
    dtypes = None if dt is None else DtypePolicy(
        **{k: str(dt.get(k, "")) for k in ("storage", "compute", "accumulate")}).validate()
    return LoweringPlan(_ENGINES[engine], vvl=int(ref.get("vvl", 0)), bx=int(ref.get("bx", 0)),
                        by=int(ref.get("by", 0)), bz=int(ref.get("bz", 0)), dtypes=dtypes,
                        view=str(ref.get("view", VIEW_AUTO)), rsplit=int(ref.get("rsplit", 1)),
                        halo=str(ref.get("halo", "periodic")))


def _lm_leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the bits
        bits = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _lm_tree(tree: Mapping, fn):
    return {k: _lm_tree(v, fn) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def to_lm_params(tree: Mapping, device="cpu"):
    """The port's LM parameters for the JAX package's parameter pytree given
    as nested dictionaries of numpy arrays (``jax.tree.map(np.asarray,
    params)``): every leaf bitwise, on ``device``.  The reference stacks the
    layers' leaves on a leading (L,) axis; the port keeps a list of one
    dictionary a layer, so the stacked leaves are split."""
    out = {k: _lm_tree(v, lambda a: _lm_leaf(a, device)) for k, v in tree.items()
           if k != "layers"}
    stacked = _lm_tree(tree["layers"], lambda a: _lm_leaf(a, device))
    first = stacked
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    out["layers"] = [_lm_tree(stacked, lambda t, i=i: t[i].clone())
                     for i in range(first.shape[0])]
    return out

"""The decomposed lattice (``lattice.domain.Domain``)."""

from .domain import Domain  # noqa: F401

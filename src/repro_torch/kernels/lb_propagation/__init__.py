from .ops import propagate, propagate_halo  # noqa: F401

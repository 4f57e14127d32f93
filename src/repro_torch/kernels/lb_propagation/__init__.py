from .ops import propagate  # noqa: F401

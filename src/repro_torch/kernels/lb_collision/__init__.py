from .ops import collide  # noqa: F401

from .ops import dslash, wilson_matvec  # noqa: F401

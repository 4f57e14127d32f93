from .ops import dslash, dslash_halo, wilson_matvec  # noqa: F401

from .driver import MilcConfig, init_problem, residual_check, solve  # noqa: F401

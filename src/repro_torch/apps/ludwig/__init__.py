from .driver import LudwigConfig, LudwigState, init_state, step, step_timed  # noqa: F401

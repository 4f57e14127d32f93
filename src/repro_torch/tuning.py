"""Run-time knobs of the LM path.

  rwkv_chunk   WKV chunk length (K10 takes 1 to 64)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Tuning:
    rwkv_chunk: int = 64


_TUNING = Tuning()


def get() -> Tuning:
    return _TUNING


def set_tuning(**kw) -> Tuning:
    global _TUNING
    _TUNING = dataclasses.replace(_TUNING, **kw)
    return _TUNING


def reset() -> None:
    global _TUNING
    _TUNING = Tuning()

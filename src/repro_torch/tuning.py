"""Run-time knobs of the LM path.

  rwkv_chunk   WKV chunk length (K10 takes 1 to 64)
  q_block /    blockwise-attention tiles of the long-sequence branch's torch
  kv_block     engine.  K12 takes kv tiles of the largest divisor of S up to
               min(kv_block, 64) (flash_attention.kernel.kv_tile), so it
               sums in the reference's order only where kv_block <= 64; at
               the default 1024 its tiles are 64 keys, the reference's 1024
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Tuning:
    rwkv_chunk: int = 64
    q_block: int = 1024
    kv_block: int = 1024


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

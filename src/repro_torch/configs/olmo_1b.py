"""olmo-1b [dense] — non-parametric LN [arXiv:2402.00838; hf]."""

from .base import ArchConfig

FULL = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,   # MHA (kv == heads)
    d_ff=8192,
    vocab=50304,
    norm="nonparam_ln",
    act="silu",
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="olmo-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    norm="nonparam_ln",
    act="silu",
    tie_embeddings=True,
)

"""deepseek-67b [dense] — llama-arch, 95 layers [arXiv:2401.02954; hf].

FULL is 134 GB in bf16: registered, but more than one H100 holds."""

from .base import ArchConfig

FULL = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="deepseek-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=256,
    tie_embeddings=False,
)

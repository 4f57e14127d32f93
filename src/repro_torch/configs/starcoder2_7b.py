"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173; hf].

LayerNorm + plain (non-gated) GELU MLP per the StarCoder2 architecture.
Its attention runs through repro_torch.kernels.flash_attention (K11 below
BLOCKWISE_MIN_SEQ, K12 from it, on the card)."""

from .base import ArchConfig

FULL = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=72,
    n_heads=6,
    n_kv_heads=2,
    d_ff=144,
    vocab=256,
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    tie_embeddings=True,
)

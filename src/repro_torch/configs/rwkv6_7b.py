"""rwkv6-7b [ssm]: Finch, data-dependent decay, attention-free
[arXiv:2404.05892].  The WKV recurrence runs through
repro_torch.kernels.rwkv6_scan (K10 on the card)."""

from .base import ArchConfig

FULL = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_head=64,            # wkv head size
    d_ff=14336,
    vocab=65536,
    norm="layernorm",
    act="silu",
    attn_free=True,
    tie_embeddings=False,
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="rwkv6-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_head=16,
    d_ff=128,
    vocab=256,
    norm="layernorm",
    attn_free=True,
    tie_embeddings=False,
    subquadratic=True,
)

from .ops import rwkv6, rwkv6_decode_step  # noqa: F401

"""The LM model zoo of the port: ``init_params(cfg, generator, device)`` ->
plain dictionaries of tensors; forward passes are functions of them.  The
dense family (starcoder2-7b, granite-3-2b, olmo-1b, deepseek-67b) and the
attention-free family (rwkv6-7b) are ported."""

from .model_factory import init_params, forward, decode_step, init_cache  # noqa: F401

"""The LM model zoo of the port: ``init_params(cfg, generator, device)`` ->
plain dictionaries of tensors; forward passes are functions of them.  Only
the attention-free family (rwkv6-7b) is ported."""

from .model_factory import init_params, forward, decode_step, init_cache  # noqa: F401

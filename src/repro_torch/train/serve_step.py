"""Serving steps: prefill and batched autoregressive decode.

``build_serve_step`` is the decode unit: one new token a sequence against
the cache (the recurrent state, or the dense family's k/v cache).  ``generate`` drives it over a batch of requests:
the prompt goes in token by token, then greedy or temperature sampling.

``build_cg_serve_step`` is the lattice solver's counterpart: the unit of
work the request scheduler (``launch/serve.py``) replays between admission
and drain, one convergence-masked batched CG iteration over a fixed
(lattice, slots) bucket.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode_step, forward, init_cache


def build_serve_step(cfg: ArchConfig):
    """(params, cache, tokens (B,)) -> (logits (B, vocab), cache)."""

    def step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)

    return step


def build_prefill(cfg: ArchConfig, *, wkv_engine: str = "auto", attn_engine: str = "auto"):
    """(params, batch) -> logits: the prefill unit.  On parameters on the
    card ``"auto"`` runs K10 (RWKV6) or K11/K12 (the dense family's
    attention) in every layer."""

    def prefill(params, batch):
        with torch.inference_mode():
            logits, _ = forward(params, cfg, batch, wkv_engine=wkv_engine,
                                attn_engine=attn_engine)
        return logits

    return prefill


def build_cg_serve_step(u, kappa: float, config, *, tol: float, max_iter: int,
                        refine_every: int = 0, config_hi=None):
    """The masked-iteration step of batched CG serving: BatchedCGState ->
    BatchedCGState, one fused operator launch and one fused masked-update
    launch for the whole slot batch.  Converged and empty slots ride along
    bitwise frozen, so the scheduler can drain and refill them between calls
    without perturbing in-flight solves.  A plain function: PyTorch runs
    eagerly, so there is nothing to compile.

    A dtype policy on ``config`` applies to the operator launch; the update
    chain runs without it, as in ``driver.solve_batched`` (the JAX package's
    step runs every launch under the config's policy).  ``refine_every >
    0`` returns the reliable-update step ``step(state, rhs)``: every that
    many active iterations a slot's residual is recomputed as ``rhs - A x``
    through the ``config_hi`` operator (default: ``config`` without its
    policy) and its search direction restarted (``cg.batched_cg_refresh``).
    The test for a due restart is one more host synchronisation a call."""
    from repro_torch.apps.milc.cg import (batched_cg_iteration, batched_cg_refresh,
                                          make_fused_normal, refresh_due)

    plain = dataclasses.replace(config, dtypes=None) if config.dtypes else config
    apply_a_dot = make_fused_normal(u, float(kappa), config)
    kw = dict(tol=tol, max_iter=max_iter)

    if refine_every <= 0:
        def step(state):
            return batched_cg_iteration(state, apply_a_dot, config=plain, **kw)

        return step

    apply_a_dot_hi = make_fused_normal(u, float(kappa), config_hi or plain)

    def step_refined(state, rhs):
        state = batched_cg_iteration(state, apply_a_dot, config=plain, **kw)
        if refresh_due(state, refine_every=refine_every, **kw):
            state = batched_cg_refresh(state, rhs, apply_a_dot_hi, refine_every=refine_every,
                                       **kw)
        return state

    return step_refined


def generate(params, cfg: ArchConfig, prompt_tokens, *, steps: int, s_max: int,
             temperature: float = 0.0, generator: torch.Generator = None):
    """Greedy or sampled generation.  prompt_tokens: (B, P) integers on the
    parameters' device.  Returns (B, P + steps) int64 tokens.

    ``generator`` is only consulted when ``temperature > 0``; it defaults to
    one seeded 0 on the tokens' device, so sampling is reproducible out of
    the box (its bits are not the reference's ``jax.random``)."""
    B, P = prompt_tokens.shape
    dev = prompt_tokens.device
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    step = build_serve_step(cfg)
    with torch.inference_mode():
        cache = init_cache(cfg, B, s_max, device=dev)
        out = [prompt_tokens[:, i].long() for i in range(P)]
        logits = None
        for tok in out[:P]:
            logits, cache = step(params, cache, tok)
        for _ in range(steps):
            if temperature > 0.0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            out.append(nxt)
            logits, cache = step(params, cache, nxt)
    return torch.stack(out, dim=1)

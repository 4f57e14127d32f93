"""Architecture configuration schema shared by all the LM architectures.

The port's copy of the JAX package's ``configs/base.py``: the same
dataclasses and shapes, with ``ArchConfig.dtype`` a torch dtype."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_d_ff: int = 0          # arctic: parallel dense-residual MLP width


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    swa_window: int = 1024
    global_every: int = 8        # every k-th layer uses global attention
    meta_tokens: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"            # silu | gelu
    mlp_gated: bool = True       # False: plain 2-matrix MLP (starcoder2, seamless)
    qk_norm: bool = False        # qwen3
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid: Optional[HybridCfg] = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    attn_free: bool = False      # rwkv6
    tie_embeddings: bool = True
    dtype: object = torch.bfloat16
    # shape-support metadata
    subquadratic: bool = False   # supports long_500k
    has_decoder: bool = True

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a multiple of 256."""
        return ((self.vocab + 255) // 256) * 256

    def param_count(self) -> int:
        """Approximate total parameters (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim
        if not self.attn_free:
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        else:
            attn = 6 * d * d  # rwkv time-mix r,k,v,g,o + decay
        if self.moe:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
            ff += 3 * d * self.moe.dense_d_ff
        else:
            ff = 3 * d * self.d_ff
        if self.ssm is not None and self.hybrid is not None:
            di = self.ssm.expand * d
            ff_ssm = d * di * 2 + di * d + di * (2 * self.ssm.d_state + 1)
            attn += ff_ssm
        blocks = L * (attn + ff)
        if self.enc_dec:
            blocks += self.n_enc_layers * (attn + ff) + L * attn  # cross-attn
        return int(n + blocks)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeCfg("train_4k", 4096, 256, "train"),
    ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    ShapeCfg("decode_32k", 32768, 128, "decode"),
    ShapeCfg("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeCfg:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def shape_supported(arch: "ArchConfig", shape: ShapeCfg) -> Tuple[bool, str]:
    """(supported, reason-if-not). long_500k needs sub-quadratic attention;
    decode shapes need a decoder."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "pure full-attention arch: 524k-token decode requires sub-quadratic attention"
    if shape.kind == "decode" and not arch.has_decoder:
        return False, "encoder-only arch has no decode step"
    return True, ""

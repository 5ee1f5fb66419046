"""Config schema: model architecture (the dense, MoE and hybrid families'
fields)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"          # "dense", "moe" (non-MLA) and "hybrid"
    #                                (zamba2) are ported

    # trunk
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 256
    vocab_pad_multiple: int = 128
    qkv_bias: bool = False
    mlp_type: str = "gated_silu"    # gated_silu | relu2 | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # sliding-window attention (None = full)
    window: Optional[int] = None

    # MoE
    n_experts: int = 0
    top_k: int = 2
    n_shared_experts: int = 0
    moe_ff: Optional[int] = None     # expert intermediate (defaults d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    moe_groups: int = 1              # dispatch groups (1 on one card)

    # Mamba2 / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    shared_attn_every: int = 0       # zamba2: shared attn block cadence

    # numerics
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.d_model // self.n_heads
        if self.moe_ff is None:
            self.moe_ff = self.d_ff

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Parameter count from the dense, MoE or hybrid family's shapes."""
        if self.family not in ("dense", "moe", "hybrid"):
            raise NotImplementedError(
                f"n_params covers the dense, moe and hybrid families, not "
                f"{self.family}")
        d, h, kh, hd = self.d_model, self.n_heads, self.n_kv_heads, \
            self.head_dim
        attn = d * h * hd + 2 * d * kh * hd + h * hd * d
        if self.qkv_bias:
            attn += h * hd + 2 * kh * hd
        if self.family == "moe":
            ffn = d * self.n_experts + 3 * self.n_experts * d * self.moe_ff
            ffn += 3 * d * self.moe_ff * self.n_shared_experts
        else:
            n_mats = 3 if self.mlp_type == "gated_silu" else 2
            ffn = n_mats * d * self.d_ff
        block = 2 * d + attn + ffn
        tables = 1 if self.tie_embeddings else 2
        head = tables * self.padded_vocab * d + d
        if self.family != "hybrid":
            return head + self.n_layers * block
        # zamba2: a stack of Mamba2 blocks plus one shared dense block
        d_inner = self.ssm_expand * d
        nheads = d_inner // self.ssm_headdim
        conv_ch = d_inner + 2 * self.ssm_state
        mamba = (d + d * (2 * d_inner + 2 * self.ssm_state + nheads)
                 + (self.ssm_conv + 1) * conv_ch + 3 * nheads + d_inner
                 + d_inner * d)
        return head + self.n_layers * mamba + block

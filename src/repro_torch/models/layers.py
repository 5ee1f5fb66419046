"""Shared layer primitives: norms, MLPs, RoPE, embeddings, initializers."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused


def dense_init(generator, shape, in_axis_size=None, device=None,
               dtype=torch.float32):
    """Truncated-normal fan-in init: N(0, 1) cut at ±2, times fan_in^-½.

    Drawn on ``generator``'s device, then moved to ``device``.
    """
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = (1.0 / fan_in) ** 0.5
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(device=device, dtype=dtype)


# --------------------------------------------------------------------- #
# RMSNorm
# --------------------------------------------------------------------- #

def init_rmsnorm(d, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps=1e-5):
    """Through the fused kernel on the card, its plain version on the CPU."""
    return rmsnorm_fused(x, params["scale"], eps=eps)


# --------------------------------------------------------------------- #
# MLP (gated-SiLU llama-style, relu^2 nemotron-style, or tanh-GELU)
# --------------------------------------------------------------------- #

def init_mlp(generator, d_model, d_ff, mlp_type="gated_silu", device=None,
             dtype=torch.float32):
    def init(shape, fan_in):
        return dense_init(generator, shape, fan_in, device, dtype)

    if mlp_type not in ("gated_silu", "relu2", "gelu"):
        raise ValueError(mlp_type)
    p = {"w_in": init((d_model, d_ff), d_model)}
    if mlp_type == "gated_silu":
        p["w_gate"] = init((d_model, d_ff), d_model)
    p["w_out"] = init((d_ff, d_model), d_ff)
    return p


def mlp(params, cfg, x):
    """x: (..., d_model) -> (..., d_model)."""
    dt = x.dtype
    h = x @ params["w_in"].to(dt)
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"].to(dt)) * h
    elif cfg.mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    else:
        h = torch.square(F.relu(h))
    return h @ params["w_out"].to(dt)


# --------------------------------------------------------------------- #
# Rotary position embeddings
# --------------------------------------------------------------------- #

def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta=10000.0):
    """x: (B, S, H, D); positions: (B, S) or (S,) int.

    Rotates interleaved pairs (x[..., ::2], x[..., 1::2]); the angles are
    fp32, so the rotation runs in fp32 before the cast back to x's type.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)             # (d/2,)
    ang = positions.float()[..., None] * freqs         # (B,S,d/2) or (S,d/2)
    if ang.ndim == 2:                                  # (S, d/2) -> (1,S,1,d/2)
        ang = ang[None, :, None, :]
    else:                                              # (B,S,d/2) -> (B,S,1,d/2)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------- #

def init_embed(generator, vocab, d_model, device=None, dtype=torch.float32):
    t = torch.randn((vocab, d_model), generator=generator,
                    device=generator.device) * 0.02
    return {"table": t.to(device=device, dtype=dtype)}


def embed(params, cfg, tokens):
    return params["table"].to(cfg.act_dtype)[tokens]


def unembed(params, cfg, x, table=None):
    """Logits over the padded vocab. ``table`` reuses tied embeddings."""
    t = table if table is not None else params["table"]
    return x @ t.to(x.dtype).T

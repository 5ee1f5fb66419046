"""Mamba2 (state-space duality) block: the prefill path through the SSD
scan kernel and the O(1)-state single-step decode path.

Shapes follow the Mamba2 paper: d_inner = expand·d_model, heads = d_inner /
headdim, scalar decay per head (A), shared B/C of size ssm_state
(n_groups=1, zamba2's choice), short causal conv over (x,B,C).  The prefill
runs the scan through ``kernels/mamba2_ssd`` where the JAX model runs its
XLA twin ``ssd_chunked`` and adds D·x (``src/repro/models/ssm.py:171-172``;
the port's ``ssd_chunked`` is the kernel's plain version, in
``kernels/mamba2_ssd/ref.py``); decode is one plain recurrence step, as
in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd
from repro_torch.models.layers import dense_init


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_ch = d_inner + 2 * cfg.ssm_state
    return d_inner, nheads, conv_ch


def init_mamba2(generator, cfg, device=None, dtype=torch.float32):
    """The JAX package's distributions.  ``w_in``, ``w_out`` and the conv
    weights are held in ``dtype``; ``A_log``, ``D``, ``dt_bias`` and
    ``norm_scale`` stay fp32."""
    d = cfg.d_model
    d_inner, nheads, conv_ch = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=generator,
                         device=generator.device) * 0.1
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        "w_in": dense_init(generator,
                           (d, 2 * d_inner + 2 * cfg.ssm_state + nheads),
                           d, device, dtype),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "D": torch.ones((nheads,), **f32),
        "dt_bias": torch.full((nheads,), math.log(math.expm1(0.01)), **f32),
        "norm_scale": torch.ones((d_inner,), **f32),
        "w_out": dense_init(generator, (d_inner, d), d_inner, device, dtype),
    }


def _split_proj(cfg, proj):
    d_inner, nheads, _ = dims(cfg)
    n = cfg.ssm_state
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * n]
    dt = proj[..., -nheads:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, state):
    """Depthwise causal conv, kernel k. xbc: (B,S,C); state: (B,k-1,C),
    the previous inputs (zeros before a prefill)."""
    k = w.shape[0]
    xp = torch.cat([state.to(xbc.dtype), xbc], dim=1)   # (B, S+k-1, C)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0].to(xbc.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i].to(xbc.dtype)
    new_state = xp[:, -(k - 1):]
    return F.silu(out + b.to(xbc.dtype)), new_state


def ssd_decode_step(h, xh, dt, A, B, C):
    """Single-token state update. h: (b,H,P,N); xh: (b,H,P); dt: (b,H);
    B,C: (b,N). Returns (y (b,H,P), h')."""
    dA = torch.exp(dt * A)                                   # (b,H)
    h32 = h.float()
    upd = (dt[:, :, None] * xh.float())[..., None] \
        * B.float()[:, None, None, :]                        # (b,H,P,N)
    h_new = h32 * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, C.float())
    return y.to(xh.dtype), h_new


def _gated_norm(scale, y, z, eps=1e-5):
    """RMS norm of y·silu(z) in fp32 with an fp32 scale (not the rmsnorm
    kernel's function: the gate comes first)."""
    y32 = y.float() * F.silu(z.float())
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale).to(y.dtype)


def mamba2_forward(params, cfg, x, state):
    """Prefill. x: (B,S,d); state: {conv (B,k-1,C), ssd (B,H,P,N)} (the
    cache's zeros before a prompt).  Returns (y, new_state); the scan runs
    through the ``mamba2_ssd`` kernel on the card, from ``state["ssd"]``."""
    d_inner, nheads, _ = dims(cfg)
    n = cfg.ssm_state
    proj = x @ params["w_in"].to(x.dtype)
    z, xbc, dtp = _split_proj(cfg, proj)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 state["conv"])
    xh = xbc[..., :d_inner].unflatten(-1, (nheads, cfg.ssm_headdim))
    B = xbc[..., d_inner:d_inner + n]
    C = xbc[..., d_inner + n:]
    dtv = F.softplus(dtp.float() + params["dt_bias"])        # (B,S,H)
    A = -torch.exp(params["A_log"])
    y, h_final = mamba2_ssd(xh, dtv, B, C, A, params["D"], h0=state["ssd"])
    y = y.reshape(*y.shape[:2], d_inner)
    y = _gated_norm(params["norm_scale"], y, z, cfg.norm_eps)
    out = y @ params["w_out"].to(x.dtype)
    return out, {"conv": new_conv.to(state["conv"].dtype), "ssd": h_final}


def mamba2_decode(params, cfg, x, state):
    """One token. x: (B,1,d); state: {conv (B,k-1,C), ssd (B,H,P,N)}."""
    d_inner, nheads, _ = dims(cfg)
    n = cfg.ssm_state
    proj = x @ params["w_in"].to(x.dtype)                    # (B,1,·)
    z, xbc, dtp = _split_proj(cfg, proj)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 state["conv"])
    xh = xbc[:, 0, :d_inner].reshape(-1, nheads, cfg.ssm_headdim)
    B = xbc[:, 0, d_inner:d_inner + n]
    C = xbc[:, 0, d_inner + n:]
    dtv = F.softplus(dtp[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, h_new = ssd_decode_step(state["ssd"], xh, dtv, A, B, C)
    y = y + params["D"].to(y.dtype)[None, :, None] * xh
    y = y.reshape(x.shape[0], 1, d_inner)
    y = _gated_norm(params["norm_scale"], y, z, cfg.norm_eps)
    out = y @ params["w_out"].to(x.dtype)
    return out, {"conv": new_conv.to(state["conv"].dtype), "ssd": h_new}

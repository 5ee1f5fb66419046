"""Mixture-of-experts FFN with group-local, capacity-bounded gather dispatch.

Tokens are split into ``cfg.moe_groups`` groups (1 on one card), and within
each group every expert gathers its top-C tokens: an (E, C) index matrix
drives a gather, the expert matmuls and a scatter-add combine.  Tokens
beyond an expert's per-group capacity C = ceil(Tg·k/E·capacity_factor) are
dropped (their combine weight is zero).

The three expert matmuls go through the grouped-matmul kernel
(``kernels.moe_gmm``): with one group the gathered tokens are already
(E, C, d), and each expert's rows past its count of kept tokens are never
read; with more groups the group axis is folded into C.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models.layers import dense_init, mlp


def init_moe(generator, cfg, device=None, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts

    def init(shape, fan_in):
        return dense_init(generator, shape, fan_in, device, dtype)

    p = {"router": init((d, e), d), "w_in": init((e, d, f), d),
         "w_gate": init((e, d, f), d), "w_out": init((e, f, d), f)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_in": init((d, fs), d), "w_gate": init((d, fs), d),
                       "w_out": init((fs, d), fs)}
    return p


def capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    c = min(max(8, -(-c // 8) * 8), tokens_per_group)  # 8-aligned, <= Tg
    return c


def _top_k(x, k):
    """The k largest along the last axis, in descending order, the lower
    index first among equal values (as ``jax.lax.top_k``; ``torch.topk``
    breaks ties otherwise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params, cfg, x):
    """x: (B, S, d) -> (y, aux_loss)."""
    dt = x.dtype
    b, s, d = x.shape
    t = b * s
    g = max(1, min(cfg.moe_groups, t))
    while t % g:
        g -= 1
    tg = t // g
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(tg, cfg)
    xt = x.reshape(g, tg, d)

    # --- route (per group) ---------------------------------------------
    logits = torch.einsum("gtd,de->gte", xt, params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                      # (G,Tg,k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # Switch aux loss: E * sum_e mean-prob_e * mean-assignment_e
    me = probs.mean(dim=1)                                      # (G,E)
    ce = torch.zeros((g, e), dtype=torch.float32, device=x.device)
    ce = ce.scatter_add_(1, gate_idx.reshape(g, -1),
                         torch.ones((g, tg * k), device=x.device)) / (tg * k)
    aux = e * torch.sum(me.mean(0) * ce.mean(0)) * cfg.router_aux_coef

    # --- per-expert token selection (capacity C, within group) ---------
    sel = torch.zeros((g, tg, e), dtype=torch.float32, device=x.device)
    sel.scatter_(2, gate_idx, gate_vals)                        # (G,Tg,E)
    scores = torch.where(sel > 0, sel, -1.0).transpose(1, 2)    # (G,E,Tg)
    top_scores, token_idx = _top_k(scores, c)                   # (G,E,C)
    keep = (top_scores > 0).to(dt)

    # --- gather -> expert matmuls -> scatter-add combine ---------------
    xs = xt[torch.arange(g, device=x.device)[:, None, None], token_idx]
    if g == 1:
        # the kept tokens are each expert's first rows (descending top-k)
        xs, n_valid = xs[0], (top_scores[0] > 0).sum(-1, dtype=torch.int32)
    else:
        xs, n_valid = xs.transpose(0, 1).reshape(e, g * c, d), None
    h = moe_gmm(xs, params["w_in"], n_valid)
    gg = moe_gmm(xs, params["w_gate"], n_valid)
    ys = moe_gmm(F.silu(gg) * h, params["w_out"], n_valid)
    ys = ys.reshape(e, g, c, d).transpose(0, 1)                 # (G,E,C,d)
    w = (top_scores.to(dt) * keep)[..., None]                   # (G,E,C,1)
    combined = torch.zeros((g, tg, d), dtype=dt, device=x.device)
    for gi in range(g):
        combined[gi].index_add_(0, token_idx[gi].reshape(-1),
                                (ys[gi] * w[gi]).reshape(-1, d))

    # --- shared experts (dense path, deepseek) -------------------------
    if "shared" in params:
        combined = combined + mlp(params["shared"], cfg, xt)

    return combined.reshape(b, s, d), aux

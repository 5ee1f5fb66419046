"""Attention: GQA (optionally sliding-window, optionally biased).

Layouts: activations (B, S, d_model); q (B, S, H, D); k/v (B, T, KH, D).
Softmax in fp32.  Caches and the paged pool are updated in place.  The
continuous-batch decode step attends through the decode attention kernel
(``kernels/decode_attention``).  Prefill of S·T >= 2048² score elements
attends through the flash attention kernel (``kernels/flash_attention``),
where the JAX package runs its XLA twin ``blockwise_sdpa``; shorter
prefills and the paged chunked prefill attend through the plain
:func:`_sdpa`, as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import cache as cache_lib
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -2.0 ** 30  # large-negative in fp32, safe under bf16 casts

# naive-vs-blockwise dispatch threshold (elements of the S×T score matrix)
_BLOCKWISE_MIN_SCORES = 2048 * 2048


def init_gqa(generator, cfg, device=None, dtype=torch.float32):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def init(shape, fan_in):
        return dense_init(generator, shape, fan_in, device, dtype)

    p = {
        "wq": init((d, h, hd), d),
        "wk": init((d, kh, hd), d),
        "wv": init((d, kh, hd), d),
        "wo": init((h, hd, d), h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kh, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kh, hd), dtype=dtype, device=device)
    return p


def _qkv(params, cfg, x, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, n_kv_heads):
    """Grouped scaled-dot-product attention. mask: broadcastable to
    (B, KH, G, S, T)."""
    b, s, h, d = q.shape
    dv = v.shape[-1]
    kh = n_kv_heads
    g = h // kh
    qg = q.reshape(b, s, kh, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits / math.sqrt(d)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v)
    return o.reshape(b, s, h, dv)


def causal_mask(s, t_offset=0, window=None, device=None):
    """(S, T) mask for queries at positions t_offset..t_offset+s-1 over keys
    at 0..t_offset+s-1 (prefill: t_offset=0, square)."""
    t = t_offset + s
    qi = torch.arange(s, device=device)[:, None] + t_offset
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= (qi - kj) < window
    return m


def _self_attention(cfg, q, k, v):
    """Dispatch: the flash attention kernel for long sequences, naive for
    short ones."""
    s, t = q.shape[1], k.shape[1]
    if s * t >= _BLOCKWISE_MIN_SCORES:
        return flash_attention(q, k, v, n_kv_heads=cfg.n_kv_heads,
                               window=cfg.window)
    mask = causal_mask(s, window=cfg.window, device=q.device)[None, None, None]
    return _sdpa(q, k, v, mask, cfg.n_kv_heads)


def _out_proj(params, o, dt):
    return torch.einsum("bshk,hkd->bsd", o, params["wo"].to(dt))


def gqa_prefill(params, cfg, x, positions, kv_cache_layer):
    """Prefill that also fills the layer's KV cache in place
    (window-aware).  Returns (y, kv_cache_layer)."""
    q, k, v = _qkv(params, cfg, x, positions)
    s = x.shape[1]
    y = _out_proj(params, _self_attention(cfg, q, k, v), x.dtype)

    ck, cv = kv_cache_layer["k"], kv_cache_layer["v"]
    slot = kv_cache_layer["slot_pos"]
    cache_len = ck.shape[1]  # (B, S_c, KH, D) per-layer slice
    pos = (positions if positions.ndim == 1 else positions[0]).to(torch.int32)
    slot.fill_(-1)
    if cfg.window is None or s <= cache_len:
        n = min(s, cache_len)
        ck[:, :n] = k[:, :n]
        cv[:, :n] = v[:, :n]
        slot[:n] = pos[:n]
    else:  # SWA ring: last `window` keys, each at slot (position % window)
        pos_last = pos[-cache_len:]
        idx = (pos_last % cache_len).long()
        ck.zero_()
        cv.zero_()
        ck[:, idx] = k[:, -cache_len:]
        cv[:, idx] = v[:, -cache_len:]
        slot[idx] = pos_last
    return y, kv_cache_layer


def gqa_decode(params, cfg, x, t, kv_cache_layer):
    """One-token decode against the cache. x: (B, 1, d); t: int position.
    Returns (y, kv_cache_layer) with the cache updated in place."""
    b = x.shape[0]
    pos = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, cfg, x, pos)

    ck, cv = kv_cache_layer["k"], kv_cache_layer["v"]
    slot = kv_cache_layer["slot_pos"]
    w = cache_lib.slot_write_index(slot, t, cfg.window)
    w = min(w, ck.shape[1] - 1)       # clamped as dynamic_update_slice does
    ck[:, w:w + 1] = k
    cv[:, w:w + 1] = v
    slot[w] = t
    mask = cache_lib.valid_mask(slot, t, cfg.window)  # (S_c,)
    o = _sdpa(q, ck, cv, mask[None, None, None, None, :], cfg.n_kv_heads)
    return _out_proj(params, o, x.dtype), kv_cache_layer


def _gather_rows(pool, gather):
    """(B, S) pool rows -> (B, S, KH, D) contiguous K or V."""
    b, s = gather.shape
    return pool.index_select(0, gather.reshape(-1)).view(
        b, s, *pool.shape[1:])


def gqa_decode_paged(params, cfg, x, step, pool_layer):
    """Continuous-batch decode: one token per slot against the paged pool.

    x: (B, 1, d) with B = max_slots (idle slots carry garbage rows);
    pool_layer: {"k","v"} of shape (P, KH, D) — the flat token-row pool,
    updated in place.  ``step`` carries per-sequence bookkeeping:
      pos    (B,)   int — this slot's decode position t (-1 = idle);
      write  (B,)   int64 — flat pool row for the new K/V (idle → scratch);
      gather (B, S) int64 — pool rows in position order per slot's table;
      mask   (B, S) bool  — paged_valid_mask(pos, S, window).
    Attention runs through the decode attention kernel on the card (its
    plain version on the CPU).
    """
    pos = step["pos"].clamp(min=0)[:, None]               # (B, 1)
    q, k, v = _qkv(params, cfg, x, pos)
    pool_layer["k"].index_copy_(0, step["write"], k[:, 0])
    pool_layer["v"].index_copy_(0, step["write"], v[:, 0])
    kg = _gather_rows(pool_layer["k"], step["gather"])
    vg = _gather_rows(pool_layer["v"], step["gather"])
    o = decode_attention(q, kg, vg, step["mask"], n_kv_heads=cfg.n_kv_heads)
    return _out_proj(params, o, x.dtype), pool_layer


def gqa_prefill_paged(params, cfg, x, step, pool_layer):
    """Batched chunked prefill into the paged pool (in place).

    x: (B, C, d) — one fixed-size chunk per prefilling request; ``step``:
      pos    (B, C)    int — absolute position per chunk row (-1 = pad);
      write  (B, C)    int64 — flat pool row per chunk row (pad → scratch);
      gather (B, S)    int64 — each sequence's pool rows in position order;
      mask   (B, C, S) bool  — causal/window validity per chunk row.
    The whole batch's K/V scatters into the pool before the per-sequence
    gathers; row (b, i) attends exactly its own prefix 0..pos[b, i].
    """
    pos = step["pos"].clamp(min=0)                        # (B, C)
    q, k, v = _qkv(params, cfg, x, pos)
    kh, hd = k.shape[-2], k.shape[-1]
    flat = step["write"].reshape(-1)
    pool_layer["k"].index_copy_(0, flat, k.reshape(-1, kh, hd))
    pool_layer["v"].index_copy_(0, flat, v.reshape(-1, kh, hd))
    kg = _gather_rows(pool_layer["k"], step["gather"])
    vg = _gather_rows(pool_layer["v"], step["gather"])
    o = _sdpa(q, kg, vg, step["mask"][:, None, None], cfg.n_kv_heads)
    return _out_proj(params, o, x.dtype), pool_layer

"""Decode-time caches: GQA KV (full-length or SWA ring), the paged pool,
and the Mamba2 state.

Caches are dicts of tensors that the attention layers update in place.
Slot bookkeeping uses an explicit ``slot_pos`` array ((S_cache,) int32,
-1 = empty slot) so sliding-window ring buffers and linear caches share one
masking rule:
valid  =  slot_pos >= 0  &  slot_pos <= t  &  (window is None or t - slot_pos < window).
"""

from __future__ import annotations

import torch


def init_kv_cache(cfg, batch, max_len, dtype=None, device=None,
                  n_layers=None):
    """Full-length (or SWA ring) KV cache for one attention layer stack,
    with a leading layer dim (``n_layers``, default ``cfg.n_layers``)."""
    dt = dtype or cfg.act_dtype
    nl = n_layers if n_layers is not None else cfg.n_layers
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    s = max_len if cfg.window is None else min(cfg.window, max_len)
    return {
        "k": torch.zeros((nl, batch, s, kh, hd), dtype=dt, device=device),
        "v": torch.zeros((nl, batch, s, kh, hd), dtype=dt, device=device),
        "slot_pos": torch.full((nl, s), -1, dtype=torch.int32,
                               device=device),
    }


def init_ssm_state(cfg, batch, n_layers=None, dtype=None, device=None):
    """Mamba2 state with a leading layer dim: the causal conv's last
    ``ssm_conv - 1`` inputs in the activation type, and the SSD state
    (B, H, P, N) in fp32."""
    dt = dtype or cfg.act_dtype
    nl = n_layers if n_layers is not None else cfg.n_layers
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_ch = d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((nl, batch, cfg.ssm_conv - 1, conv_ch), dtype=dt,
                            device=device),
        "ssd": torch.zeros((nl, batch, nheads, cfg.ssm_headdim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }


def init_paged_kv_cache(cfg, n_blocks, block_size, dtype=None, device=None):
    """Paged KV pool for one attention layer stack (continuous batching).

    ``n_blocks * block_size`` flat token rows per layer, shared by every
    in-flight sequence and handed out in blocks by the host-side allocator
    (``serve/paged_cache.py``).  Block 0 is the scratch block: writes from
    idle decode slots and prefill padding land there and are never
    attended.  Validity is positional, see :func:`paged_valid_mask`.
    """
    dt = dtype or cfg.act_dtype
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    p = int(n_blocks) * int(block_size)
    return {
        "k": torch.zeros((cfg.n_layers, p, kh, hd), dtype=dt, device=device),
        "v": torch.zeros((cfg.n_layers, p, kh, hd), dtype=dt, device=device),
    }


def paged_valid_mask(pos, s_max, window=None):
    """(..., s_max) bool mask for paged attention rows gathered in position
    order.

    ``pos`` is an int tensor of any shape — the query position per row;
    ``pos < 0`` marks an idle/pad row and masks everything.  Gathered key
    row ``j`` holds position ``j``: ``j <= pos`` and (SWA)
    ``pos - j < window``.
    """
    j = torch.arange(s_max, dtype=pos.dtype, device=pos.device)
    p = pos[..., None]
    m = (j <= p) & (p >= 0)
    if window is not None:
        m &= (p - j) < window
    return m


def slot_write_index(slot_pos_row, t, window):
    """Where position t lands: t (linear cache) or t % window (ring)."""
    del slot_pos_row
    return t if window is None else t % window


def valid_mask(slot_pos, t, window):
    """(S_cache,) bool — which slots a query at position t may attend to."""
    m = (slot_pos >= 0) & (slot_pos <= t)
    if window is not None:
        m &= (t - slot_pos) < window
    return m

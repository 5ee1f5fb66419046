"""Plain PyTorch version of the decode attention kernel."""

from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def decode_attention_ref(q, k, v, valid_mask, *, scale=None):
    """q: (B,KH,G,D); k/v: (B,KH,S,D); valid_mask: (S,) shared across the
    batch, or (B,S) per sequence (continuous batching)."""
    d = q.shape[-1]
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k.float()) * sc
    vm = valid_mask[None] if valid_mask.ndim == 1 else valid_mask
    s = torch.where(vm[:, None, None, :] != 0, s, NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True)
    o = torch.einsum("bkgt,bktd->bkgd", w, v.float())
    return o.to(q.dtype)

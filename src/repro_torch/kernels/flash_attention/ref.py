"""Plain PyTorch version of the flash attention kernel."""

from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30
# Score elements (fp32) one chunk of query rows may hold: 2^26 is 256 MiB,
# so S = T = 8192 at danube's 32 heads stays within a few GB on the card.
CHUNK_SCORES = 2 ** 26


def attention_ref(q, k, v, *, n_kv_heads, window=None, scale=None):
    """q: (B,H,S,D); k/v: (B,KH,T,D) — naive masked softmax attention.

    Query head h reads KV head h // G; query row i sits at position
    (T - S) + i and attends keys kpos <= qpos (and qpos - kpos < window
    where given); masked logits are -2^30.  fp32 math, output in q's type.
    The query rows are taken in chunks of at most ``CHUNK_SCORES`` score
    elements; each row's result does not depend on the chunking.
    """
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // n_kv_heads
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    kf = k.float()
    vf = v.float()
    kpos = torch.arange(t, device=q.device)
    rows = max(1, CHUNK_SCORES // max(1, b * h * t))
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    for i0 in range(0, s, rows):
        i1 = min(s, i0 + rows)
        qg = q[:, :, i0:i1].reshape(b, kh, g, i1 - i0, d).float()
        logits = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * sc
        qpos = (t - s) + torch.arange(i0, i1, device=q.device)[:, None]
        mask = kpos[None, :] <= qpos
        if window is not None:
            mask &= (qpos - kpos[None, :]) < window
        logits = torch.where(mask, logits, NEG_INF)
        w = torch.exp(logits - logits.amax(-1, keepdim=True))
        w = w / w.sum(-1, keepdim=True)
        o = torch.einsum("bkgst,bktd->bkgsd", w, vf)
        out[:, :, i0:i1] = o.reshape(b, h, i1 - i0, d).to(q.dtype)
    return out

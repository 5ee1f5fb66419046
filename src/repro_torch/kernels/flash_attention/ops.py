"""Wrapper for the flash attention kernel (model layout).

On CPU tensors it computes the plain version (``ref.attention_ref``); on
CUDA tensors it launches ``csrc/flash_attention.cu`` on the current stream,
or raises.  The kernel reads q, k and v through their strides in the model
layout, so no transposed copy is made on the card.
``flash_attention.launches`` counts the kernel launches;
``flash_attention.events`` times them when it is a list (see
``kernels/_events.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._events import recorded
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
# Query heads per KV head the kernel takes: a CTA holds 64 (position, head)
# rows, at least one position of every head of the group.
MAX_GROUP = 64


@functools.cache
def _kernel():
    fn = _build.library("flash_attention").flash_attention_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ll, ll, ll, ll, ll, ll, i,
                   ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, n_kv_heads, window=None):
    """q: (B,S,H,D); k/v: (B,T,KH,D) with S <= T. Returns (B,S,H,D) in
    q's type: causal attention with diagonal offset T - S, optionally
    within a sliding window.

    Raises:
        ValueError / TypeError: shapes the contract does not cover (S > T
            among them), a device other than cpu or cuda, and on CUDA
            tensors what the kernel does not take.
        RuntimeError: the launch failed.
    """
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q (B,S,H,D) and k/v "
                         f"(B,T,KH,D); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], n_kv_heads
    if (tuple(k.shape) != (b, t, kh, d) or h % kh or s == 0 or s > t):
        raise ValueError(f"flash attention takes q (B,S,H,D) and k/v "
                         f"(B,T,KH,D) with KH = {kh} dividing H and "
                         f"0 < S <= T; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        o = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), n_kv_heads=kh, window=window)
        return o.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32/bfloat16 q, "
                        f"k, v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d > MAX_HEAD_DIM or h // kh > MAX_GROUP:
        raise ValueError(f"flash attention kernel takes D <= {MAX_HEAD_DIM} "
                         f"and at most {MAX_GROUP} query heads per KV head; "
                         f"got D={d}, H={h}, KH={kh}")
    if q.stride(-1) != 1 or k.stride() != v.stride() or k.stride(-1) != 1:
        raise ValueError("flash attention takes q, k and v with a unit last "
                         "stride and k, v of equal strides")
    if {k.device, v.device} != {q.device}:
        raise ValueError("q, k and v must share one device")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device), recorded(flash_attention):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            t, kh, h // kh, d, q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            0 if window is None else int(window), 1.0 / (d ** 0.5),
            _DTYPE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.events = None

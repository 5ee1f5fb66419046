"""Wrapper for the decode attention kernel (model cache layout).

On CPU tensors it computes the plain version (``ref.decode_attention_ref``);
on CUDA tensors it launches ``csrc/decode_attention.cu`` on the current
stream, or raises.  ``decode_attention.launches`` counts the launches (one
per call, which may run the split kernel and its combine pass).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# Keys one pass of the kernel covers (its kWarps warps at kKB keys each);
# the entry point refuses a split_len that is not a multiple of it.
MIN_SPLIT = 16
# The split policy aims for this many CTAs per SM.
CTAS_PER_SM = 2


@functools.cache
def _kernel():
    fn = _build.library("decode_attention").decode_attention_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, i, i,
                   i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _n_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(b, s, kh, g, n_sms):
    """Launch geometry (rows_per_cta, n_splits, split_len) of the kernel.

    This is the one place the geometry is decided; the kernel takes it as
    given.  A CTA holds GT <= 8 query rows of a group (GT a power of two,
    the least >= min(G, 8)), so a group takes ceil(G / GT) CTAs per split.
    The S keys are cut into n_splits splits of split_len keys (a multiple
    of MIN_SPLIT) so that the grid reaches CTAS_PER_SM CTAs per SM.
    """
    gt = 8 if g >= 8 else 1 << (g - 1).bit_length()
    ctas = b * kh * -(-g // gt)
    want = max(1, -(-CTAS_PER_SM * n_sms // ctas))
    split_len = -(-max(MIN_SPLIT, -(-s // want)) // MIN_SPLIT) * MIN_SPLIT
    return gt, -(-s // split_len), split_len


def decode_attention(q, k, v, valid_mask, *, n_kv_heads):
    """q: (B,1,H,D) single new token; k/v cache: (B,S,KH,D);
    valid_mask: (S,) shared across the batch, or (B,S) per sequence, bool
    or uint8. Returns (B,1,H,D) in q's type.

    Raises:
        ValueError / TypeError: on CUDA tensors the kernel does not take.
        RuntimeError: the launch failed.
    """
    b, _, h, d = q.shape
    kh = n_kv_heads
    g = h // kh
    if q.device.type == "cpu":
        o = decode_attention_ref(q[:, 0].reshape(b, kh, g, d),
                                 k.transpose(1, 2), v.transpose(1, 2),
                                 valid_mask)
        return o.reshape(b, 1, h, d)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    s = k.shape[1]
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode attention kernel takes float32/bfloat16 "
                        f"q, k, v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if (q.shape[1] != 1 or h % kh or d > MAX_HEAD_DIM
            or tuple(k.shape) != (b, s, kh, d) or v.shape != k.shape):
        raise ValueError(f"decode attention takes q (B,1,H,D) with D <= "
                         f"{MAX_HEAD_DIM} and k/v (B,S,KH,D); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, KH={kh}")
    if not q.is_contiguous() or k.stride() != v.stride() or k.stride(-1) != 1:
        raise ValueError("decode attention takes contiguous q and k/v of "
                         "equal strides with a unit last stride")
    if valid_mask.dtype == torch.bool:
        valid_mask = valid_mask.view(torch.uint8)
    if (valid_mask.dtype != torch.uint8 or valid_mask.shape[-1] != s
            or valid_mask.shape not in ((s,), (b, s))
            or not valid_mask.is_contiguous()):
        raise ValueError(f"valid_mask must be contiguous bool/uint8 ({s},) "
                         f"or ({b}, {s}), got {valid_mask.dtype} "
                         f"{tuple(valid_mask.shape)}")
    if {k.device, v.device, valid_mask.device} != {q.device}:
        raise ValueError("q, k, v and valid_mask must share one device")
    gt, n_splits, split_len = split_plan(b, s, kh, g,
                                         _n_sms(q.device.index))
    out = torch.empty_like(q)
    ws_rows = b * h * n_splits if n_splits > 1 else 0
    ws_acc = torch.empty((ws_rows, d), dtype=torch.float32, device=q.device)
    ws_ml = torch.empty((ws_rows, 2), dtype=torch.float32, device=q.device)
    m_sb = s if valid_mask.ndim == 2 else 0
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_mask.data_ptr(),
            out.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(), b, s, kh, g,
            d, k.stride(0), k.stride(1), k.stride(2), m_sb, gt, n_splits,
            split_len, 1.0 / (d ** 0.5), _DTYPE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

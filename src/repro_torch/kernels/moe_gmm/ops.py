"""Wrapper for the grouped (per-expert) matmul kernel.

On CPU tensors it computes the plain version (``ref.moe_gmm_ref``); on
CUDA tensors it launches ``csrc/moe_gmm.cu`` on the current stream, or
raises.  ``moe_gmm.launches`` counts the kernel launches; ``moe_gmm.events``
times them when it is a list (see ``kernels/_events.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._events import recorded
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    fn = _build.library("moe_gmm").moe_gmm_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def moe_gmm(x, w, n_valid=None):
    """y[e] = x[e] @ w[e] with fp32 accumulation, rows c >= n_valid[e]
    zeroed, in x's type.

    Args:
        x: (E, C, D) float32 or bfloat16.
        w: (E, D, F), x's type.
        n_valid: (E,) int32 valid rows per expert, or None (all rows).
    Returns:
        (E, C, F) in x's type.
    Raises:
        ValueError / TypeError: shapes the contract does not cover, a
            device other than cpu or cuda, and on CUDA tensors what the
            kernel does not take.
        RuntimeError: the launch failed.
    """
    if x.ndim != 3 or w.ndim != 3 or w.shape[:2] != (x.shape[0],
                                                      x.shape[2]):
        raise ValueError(f"moe_gmm takes x (E,C,D) and w (E,D,F); got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    e, c, d = x.shape
    f = w.shape[2]
    if n_valid is not None and tuple(n_valid.shape) != (e,):
        raise ValueError(f"n_valid must be ({e},), got "
                         f"{tuple(n_valid.shape)}")
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w, n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm kernel takes float32/bfloat16 x and w of "
                        f"one type, got {x.dtype}, {w.dtype}")
    if n_valid is not None and n_valid.dtype != torch.int32:
        raise TypeError(f"n_valid must be int32, got {n_valid.dtype}")
    if {w.device} | ({n_valid.device} if n_valid is not None
                     else set()) != {x.device}:
        raise ValueError("x, w and n_valid must share one device")
    if not (x.is_contiguous() and w.is_contiguous()
            and (n_valid is None or n_valid.is_contiguous())):
        raise ValueError("moe_gmm kernel takes contiguous x, w and n_valid")
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device), recorded(moe_gmm):
        err = _kernel()(x.data_ptr(), w.data_ptr(),
                        0 if n_valid is None else n_valid.data_ptr(),
                        out.data_ptr(), e, c, d, f, _DTYPE[x.dtype],
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {err}")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
moe_gmm.events = None

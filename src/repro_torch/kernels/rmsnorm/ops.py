"""Wrapper for the fused RMSNorm kernel (arbitrary leading dims).

On a CPU tensor it computes the plain version (``ref.rmsnorm_ref``); on a
CUDA tensor it launches ``csrc/rmsnorm.cu`` on the current stream, or
raises.  ``rmsnorm_fused.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    fn = _build.library("rmsnorm").rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm_fused(x, scale, *, eps=1e-5):
    """x: (..., D) float32 or bfloat16; scale: (D,) float32.

    Returns x's shape and type.

    Raises:
        ValueError / TypeError: on a CUDA tensor the kernel does not take
            (device, type, shape or contiguity).
        RuntimeError: the launch failed.
    """
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_fused runs on cpu or cuda, not {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPE:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, not "
                        f"{x.dtype}")
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (d,)
            or scale.device != x.device):
        raise ValueError(f"scale must be float32 ({d},) on {x.device}, got "
                         f"{scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows,
                        d, float(eps), _DTYPE[x.dtype],
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    rmsnorm_fused.launches += 1
    return out


rmsnorm_fused.launches = 0

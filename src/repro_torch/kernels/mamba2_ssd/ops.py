"""Wrapper for the Mamba2 SSD chunked-scan kernel (model layout).

On CPU tensors it computes the plain version (``ref.mamba2_ssd_ref``: the
JAX model's ``ssd_chunked`` plus D·x); on CUDA tensors it launches
``csrc/mamba2_ssd.cu`` on the current stream, or raises.  The kernel reads
x, dt, B and C through their strides in the model layout (x and B, C are
views of the causal conv's output), so no transposed copy is made.
``mamba2_ssd.launches`` counts the kernel launches; ``mamba2_ssd.events``
times them when it is a list (see ``kernels/_events.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._events import recorded
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_ref

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's chunk length by input type: bf16 runs on the tensor cores
# in chunks of 128 positions, fp32 on the CUDA cores in chunks of 64.
CHUNK = {torch.bfloat16: 128, torch.float32: 64}
MAX_DIM = 64          # largest head size P and state size N the kernel takes


@functools.cache
def _kernel():
    fn = _build.library("mamba2_ssd").mamba2_ssd_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                   ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, i, p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t, elems):
    """Every stride but the last a multiple of ``elems`` and the base on
    16 bytes."""
    return (t.stride(-1) == 1 and all(st % elems == 0
                                      for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def mamba2_ssd(x, dt, B, C, A, D, *, h0=None):
    """The SSD scan of one Mamba2 layer, D·x included.

    h_t = exp(dt_t·A)·h_{t−1} + dt_t·x_t⊗B_t (from h_{−1} = h0) and
    y_t = C_t·h_t + D·x_t, per head, with B and C shared by every head.

    Args:
        x: (b, S, H, P) float32 or bfloat16, any strides with a unit last
            one.
        dt: (b, S, H) step sizes after softplus (fp32 on CUDA).
        B, C: (b, S, N), x's type.
        A, D: (H,) fp32: decay rates (negative) and the skip weights.
        h0: (b, H, P, N) fp32 initial state, or None for zero.
    Returns:
        (y (b, S, H, P) in x's type, h_final (b, H, P, N) fp32).  On the
        card D·x is added in fp32 before y's one rounding to x's type.
    Raises:
        ValueError / TypeError: shapes the contract does not cover, a
            device other than cpu or cuda, and on CUDA tensors what the
            kernel does not take.
        RuntimeError: the launch failed.
    """
    if x.ndim != 4 or dt.ndim != 3 or B.ndim != 3 or C.ndim != 3:
        raise ValueError(f"mamba2_ssd takes x (b,S,H,P), dt (b,S,H), B and "
                         f"C (b,S,N); got x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    b, s, h, p = x.shape
    n = B.shape[2]
    if (tuple(dt.shape) != (b, s, h) or tuple(B.shape) != (b, s, n)
            or tuple(C.shape) != (b, s, n) or tuple(A.shape) != (h,)
            or tuple(D.shape) != (h,) or s == 0):
        raise ValueError(f"mamba2_ssd takes dt (b,S,H), B and C (b,S,N), A "
                         f"and D (H,) with S > 0; got x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}")
    if h0 is not None and tuple(h0.shape) != (b, h, p, n):
        raise ValueError(f"h0 must be {(b, h, p, n)}, got "
                         f"{tuple(h0.shape)}")
    if x.device.type == "cpu":
        return mamba2_ssd_ref(x, dt, B, C, A, D, h0)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"mamba2_ssd kernel takes float32/bfloat16 x, B and "
                        f"C of one type, got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    fp32 = [dt, A, D] + ([] if h0 is None else [h0])
    if any(t.dtype != torch.float32 for t in fp32):
        raise TypeError("mamba2_ssd kernel takes dt, A, D and h0 in float32")
    if {t.device for t in [dt, B, C, A, D] + fp32} != {x.device}:
        raise ValueError("mamba2_ssd's tensors must share one device")
    if p > MAX_DIM or n > MAX_DIM or p % 8 or n % 8:
        raise ValueError(f"mamba2_ssd kernel takes P and N multiples of 8 "
                         f"up to {MAX_DIM}; got P={p}, N={n}")
    elems = 16 // x.element_size()
    if not (_aligned(x, elems) and _aligned(B, elems)
            and _aligned(C, elems)):
        raise ValueError("mamba2_ssd kernel takes x, B and C with a unit "
                         "last stride, the others multiples of 16 bytes, "
                         "and 16-byte aligned bases")
    if not (A.is_contiguous() and D.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        raise ValueError("mamba2_ssd kernel takes contiguous A, D and h0")
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    h_final = torch.empty((b, h, p, n), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device), recorded(mamba2_ssd):
        err = _kernel()(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), D.data_ptr(), 0 if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), b, s, h, p, n,
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
            dt.stride(1), dt.stride(2), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), _DTYPE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error "
                           f"{err}")
    mamba2_ssd.launches += 1
    return y, h_final


mamba2_ssd.launches = 0
mamba2_ssd.events = None

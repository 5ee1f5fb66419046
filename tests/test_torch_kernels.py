"""The port's kernel wrappers against the JAX package's kernels, on the CPU.

On CPU tensors the port's wrappers compute their plain PyTorch versions;
these are held against the JAX wrappers (the Pallas kernels in interpret
mode, as ``tests/test_kernels.py`` runs them) and against the JAX oracles,
on the same inputs made with numpy.  Tolerances are those of
``tests/test_kernels.py``.  The CUDA kernels themselves are checked on the
card by ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.rmsnorm.ops import rmsnorm_fused as jax_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
from test_torch_serve import on_threads

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.tensor(a).to(getattr(torch, dtype)))


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# ------------------------------------------------------------------ #
# rmsnorm
# ------------------------------------------------------------------ #

DTYPES = ["float32", "bfloat16"]
RMSNORM_CASES = [((512, 1024), 128), ((3, 7, 256), 64), ((100, 896), 256),
                 ((6, 3840), 8)]


def rmsnorm_inputs(dtype, shape):
    rng = np.random.default_rng(0)
    x = both(rng.standard_normal(shape, np.float32), dtype)
    return x, rng.standard_normal(shape[-1:], np.float32)


@functools.cache
def rmsnorm_refs():
    """The JAX kernel's and oracle's outputs for every case, computed on
    threads so that their compiles overlap."""
    def refs(dtype, shape, br):
        (xj, _), s = rmsnorm_inputs(dtype, shape)
        return (np.asarray(jax_rmsnorm(xj, jnp.asarray(s), block_rows=br),
                           np.float32),
                np.asarray(jax_rmsnorm_ref(xj, jnp.asarray(s)), np.float32))

    return on_threads(refs, [(d, *c) for d in DTYPES for c in RMSNORM_CASES])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,br", RMSNORM_CASES)
def test_rmsnorm_matches_jax(dtype, shape, br):
    (_, xt), s = rmsnorm_inputs(dtype, shape)
    before = rmsnorm_fused.launches
    out = rmsnorm_fused(xt, torch.tensor(s))
    assert rmsnorm_fused.launches == before        # plain version, no kernel
    assert out.dtype == xt.dtype and out.shape == xt.shape
    kernel, oracle = rmsnorm_refs()[dtype, shape, br]
    close(out, kernel, dtype)
    close(out, oracle, dtype)


# ------------------------------------------------------------------ #
# decode attention
# ------------------------------------------------------------------ #

DECODE_CASES = [
    (2, 2, 1, 64, 16, False),     # MHA, shared mask
    (3, 1, 3, 50, 16, True),      # qwen2-tiny grouping, per-sequence mask
    (2, 2, 6, 40, 120, True),     # qwen2 grouping at danube's head dim
    (2, 1, 6, 33, 120, False),
]


def decode_inputs(dtype, b, kh, g, s, d, per_seq):
    """(q, k, v) each as a JAX array and a torch tensor, and the mask."""
    rng = np.random.default_rng(1)
    h = kh * g
    qkv = [both(rng.standard_normal(shape, np.float32), dtype)
           for shape in ((b, 1, h, d), (b, s, kh, d), (b, s, kh, d))]
    if per_seq:
        lens = rng.integers(1, s + 1, b)
        lens[-1] = 0                                # an idle, fully masked row
        mask = np.arange(s)[None, :] < lens[:, None]
    else:
        mask = np.arange(s) < rng.integers(1, s + 1)
    return qkv, mask


@functools.cache
def decode_refs():
    """The JAX kernel's and oracle's outputs for every case, computed on
    threads so that their compiles overlap."""
    def refs(dtype, b, kh, g, s, d, per_seq):
        ((qj, _), (kj, _), (vj, _)), mask = decode_inputs(
            dtype, b, kh, g, s, d, per_seq)
        kernel = jax_decode(qj, kj, vj, jnp.asarray(mask), n_kv_heads=kh)
        oracle = jax_decode_ref(qj[:, 0].reshape(b, kh, g, d),
                                jnp.swapaxes(kj, 1, 2),
                                jnp.swapaxes(vj, 1, 2), jnp.asarray(mask))
        return (np.asarray(kernel, np.float32),
                np.asarray(oracle.reshape(b, 1, kh * g, d), np.float32))

    return on_threads(refs, [(d, *c) for d in DTYPES for c in DECODE_CASES])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,kh,g,s,d,per_seq", DECODE_CASES)
def test_decode_attention_matches_jax(dtype, b, kh, g, s, d, per_seq):
    ((_, qt), (_, kt), (_, vt)), mask = decode_inputs(dtype, b, kh, g, s, d,
                                                      per_seq)
    before = decode_attention.launches
    out = decode_attention(qt, kt, vt, torch.tensor(mask), n_kv_heads=kh)
    assert decode_attention.launches == before     # plain version, no kernel
    assert out.dtype == qt.dtype and out.shape == (b, 1, kh * g, d)
    kernel, oracle = decode_refs()[dtype, b, kh, g, s, d, per_seq]
    close(out, kernel, dtype)
    close(out, oracle, dtype)


def test_fully_masked_row_averages_v():
    """An idle slot's row averages V (finite), as the oracle's -2^30 does."""
    rng = np.random.default_rng(2)
    q = torch.tensor(rng.standard_normal((1, 1, 2, 16), np.float32))
    k = torch.tensor(rng.standard_normal((1, 24, 1, 16), np.float32))
    v = torch.tensor(rng.standard_normal((1, 24, 1, 16), np.float32))
    out = decode_attention(q, k, v, torch.zeros(24, dtype=torch.bool),
                           n_kv_heads=1)
    want = v[0, :, 0].mean(0).expand(2, 16)
    np.testing.assert_allclose(out[0, 0].numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("b,s,kh,g", [(8, 160, 2, 6), (8, 4096, 2, 6),
                                      (8, 160, 8, 4), (1, 7, 1, 3),
                                      (2, 100, 1, 12), (64, 33, 4, 8)])
def test_split_plan_covers_keys(b, s, kh, g):
    """The split policy covers every key once, in splits that are whole
    multiples of one pass of the kernel's warps, and never leaves a split
    empty."""
    gt, n, length = decode_ops.split_plan(b, s, kh, g, n_sms=132)
    assert gt in (1, 2, 4, 8) and gt >= min(g, 8)
    assert n * length >= s > (n - 1) * length
    assert length % decode_ops.MIN_SPLIT == 0 and length > 0


def test_wrappers_refuse_other_devices():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        rmsnorm_fused(x, torch.empty((8,), device="meta"))
    q = torch.empty((1, 1, 2, 8), device="meta")
    k = torch.empty((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError):
        decode_attention(q, k, k, torch.empty((4,), dtype=torch.bool,
                                              device="meta"), n_kv_heads=1)

"""The port's long-prompt prefill against the JAX package's, on the CPU.

The port's ``flash_attention`` wrapper computes its plain version on CPU
tensors; it is held against the JAX Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and against the JAX oracle.  The long
branch of the port's ``_self_attention`` is held against the JAX XLA twin
``blockwise_sdpa``, and the port's padded engine against the JAX padded
engine on 2048-token prompts, which take that branch.  Inputs are made
with numpy; weights are the JAX parameters carried across by
``repro_torch.models.convert`` (``test_torch_serve.models``, one cached
initialisation per arch for the port's suite).  fp32 throughout:
atol = rtol = 1e-5 for attention, 1e-4 for logits after whole layers
(order of reductions).  The CUDA kernel itself is checked on the card by
``chip_smoke.py``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jax_tiny
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import attention as jattn
from repro_torch.configs import get_tiny
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Engine, ServeConfig
from test_torch_serve import jax_padded_engine, models, on_threads

ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LONG = 2048          # the shortest prompt that takes the long branch


def qkv(seed, b, h, kh, s, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, t, kh, d), np.float32),
            rng.standard_normal((b, t, kh, d), np.float32))


def swap(x):
    return jnp.swapaxes(jnp.asarray(x), 1, 2)


FLASH_CASES = [
    (1, 3, 1, 2048, 2048, 16, None),     # qwen2-tiny grouping, S = T
    (1, 3, 1, 2048, 2048, 16, 16),       # S >> window: the oldest key
    (2, 4, 2, 100, 1124, 16, None),      # offset T - S, ragged tails
]


@functools.cache
def flash_refs():
    """The Pallas kernel's (interpret mode) and the oracle's outputs for
    every case, computed on threads so that their compiles overlap."""
    def refs(b, h, kh, s, t, d, window):
        q, k, v = qkv(0, b, h, kh, s, t, d)
        pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           n_kv_heads=kh, window=window, interpret=True)
        ref = jax_ref(swap(q), swap(k), swap(v), n_kv_heads=kh,
                      window=window)
        return np.asarray(pallas), np.asarray(jnp.swapaxes(ref, 1, 2))

    return on_threads(refs, FLASH_CASES)


@pytest.mark.parametrize("b,h,kh,s,t,d,window", FLASH_CASES)
def test_flash_matches_jax(b, h, kh, s, t, d, window):
    q, k, v = qkv(0, b, h, kh, s, t, d)
    before = flash_attention.launches
    out = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          n_kv_heads=kh, window=window)
    assert flash_attention.launches == before    # plain version, no kernel
    assert out.shape == (b, s, h, d) and out.dtype == torch.float32
    got = out.numpy()
    pallas, ref = flash_refs()[b, h, kh, s, t, d, window]
    np.testing.assert_allclose(got, pallas, **ATTN_TOL)
    np.testing.assert_allclose(got, ref, **ATTN_TOL)


def configs(arch):
    return (dataclasses.replace(jax_tiny(arch), dtype="float32"),
            dataclasses.replace(get_tiny(arch), dtype="float32"))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "h2o-danube-3-4b"])
def test_long_branch_matches_blockwise(arch):
    jc, tc = configs(arch)
    q, k, v = qkv(1, 1, tc.n_heads, tc.n_kv_heads, LONG, LONG, tc.head_dim)
    got = tattn._self_attention(tc, torch.tensor(q), torch.tensor(k),
                                torch.tensor(v))
    want = jattn.blockwise_sdpa(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jc.n_kv_heads,
                                window=jc.window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("s,long", [(LONG - 1, False), (LONG, True)])
def test_long_branch_threshold(monkeypatch, s, long):
    """_self_attention calls the flash kernel exactly when S·T >= 2048²."""
    _, tc = configs("qwen2-1.5b")
    calls = []

    def spy(q, k, v, **kw):
        calls.append(kw)
        return torch.zeros_like(q)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    x = torch.zeros((1, s, 1, 4))
    tattn._self_attention(tc, x, x, x)
    assert calls == ([{"n_kv_heads": 1, "window": None}] if long else [])


def test_wrapper_refuses():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="S <= T"):
        flash_attention(q, k, k, n_kv_heads=1)          # S > T
    q3 = torch.zeros((1, 4, 3, 16))
    k2 = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="dividing H"):
        flash_attention(q3, k2, k2, n_kv_heads=2)       # KH does not divide H
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, n_kv_heads=2, window=0)
    m = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(m, m[:, :, :1], m[:, :, :1], n_kv_heads=1)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "h2o-danube-3-4b"])
def test_padded_engine_long_prompts_match_jax(arch):
    """2 prompts x 2048 tokens, 4 new tokens: the same tokens as the JAX
    padded engine and last-position prefill logits within 1e-4.  Danube's
    window of 16 puts the prefill through the SWA ring branch."""
    jc, jp, tc, tp = models(arch)
    prompts = np.random.default_rng(2).integers(
        0, tc.vocab_size, (2, LONG), dtype=np.int32)
    if tc.window is not None:
        assert LONG > tc.window
    sc = dict(max_prompt=LONG, max_new_tokens=4)
    jeng = jax_padded_engine(jc, jp, prompts, **sc)
    want = jeng.generate(prompts)
    eng = Engine(tc, tp, ServeConfig(**sc), device="cpu")
    got = eng.generate(prompts)
    np.testing.assert_array_equal(got, want)
    assert eng.timing["prefill_s"] > 0 and eng.timing["decode_s"] > 0
    jlogits, _ = jeng._prefill(jp, {"tokens": jnp.asarray(prompts)})
    tlogits, _ = tlm.prefill(tp, tc, {"tokens": torch.tensor(
        prompts.astype(np.int64))}, LONG + 4)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)

"""The port's MoE slice against the JAX package's, on the CPU.

The grouped matmul's plain version is held to the JAX oracle and to the
Pallas kernel in interpret mode; the port's ``moe_ffn`` to the JAX
``moe_ffn`` (output, aux loss, and the routing itself: the capacity
top-k's scores and token indices), with tokens dropped at capacity, with
two dispatch groups and with ties; the whole mixtral model through the
converter and the padded engine.  Inputs come from numpy seeds, fp32,
``tiny()`` sizes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_tiny as jax_tiny
from repro.kernels.moe_gmm.ops import moe_gmm as jax_moe_gmm
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config, get_tiny
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import tree_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig
from test_torch_serve import jax_padded_engine, models

ARCH = "mixtral-8x22b"
GMM_TOL = dict(atol=2e-5, rtol=2e-5)        # tests/test_kernels.py, fp32


def n_valid_for(rng, e, c):
    """Valid rows per expert, 0 and C among them."""
    nv = rng.integers(0, c + 1, e).astype(np.int32)
    nv[0], nv[-1] = 0, c
    return nv


# ------------------------------------------------------------------ #
# the grouped matmul's plain version
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("e,c,d,f,bc,bf", [
    (4, 64, 32, 48, 32, 16),
    (2, 100, 16, 64, 64, 64),   # ragged C
    (8, 32, 64, 30, 16, 16),    # ragged F
])
@pytest.mark.parametrize("masked", [True, False], ids=["n_valid", "all"])
def test_moe_gmm_matches_jax(e, c, d, f, bc, bf, masked):
    rng = np.random.default_rng(e * c + f)
    x = (rng.standard_normal((e, c, d)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * 0.5).astype(np.float32)
    nv = n_valid_for(rng, e, c) if masked else None
    jnv = None if nv is None else jnp.asarray(nv)
    before = moe_gmm.launches
    out = moe_gmm(torch.tensor(x), torch.tensor(w),
                  None if nv is None else torch.tensor(nv))
    assert moe_gmm.launches == before            # plain version, no kernel
    assert out.shape == (e, c, f) and out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_moe_gmm_ref(jnp.asarray(x),
                                                jnp.asarray(w), jnv)),
        **GMM_TOL)
    if nv is not None:      # the Pallas kernel, interpreted
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jax_moe_gmm(
                jnp.asarray(x), jnp.asarray(w), jnv, bc=bc, bf=bf,
                interpret=True)), **GMM_TOL)
        for i in range(e):
            assert not out[i, nv[i]:].any() and out[i, :nv[i]].all()


class _OnCuda(torch.Tensor):
    """A meta tensor that reports a CUDA device: what the wrapper sees of a
    card's tensor, without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def on_cuda(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(
        _OnCuda, torch.empty(shape, dtype=dtype, device="meta"))


def test_moe_gmm_refuses_without_fallback(monkeypatch):
    """On a CUDA tensor the kernel cannot take, the wrapper raises before
    any launch, and never computes the plain version instead."""
    def no_call(*a, **k):
        raise AssertionError("fell back or launched")

    monkeypatch.setattr(gmm_ops, "moe_gmm_ref", no_call)
    monkeypatch.setattr(gmm_ops, "_kernel", no_call)
    x, w = on_cuda(2, 8, 16), on_cuda(2, 16, 24)
    nv = on_cuda(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        moe_gmm(on_cuda(2, 8, 16, dtype=torch.float16),
                on_cuda(2, 16, 24, dtype=torch.float16))
    with pytest.raises(TypeError, match="one type"):
        moe_gmm(x, on_cuda(2, 16, 24, dtype=torch.float32))
    with pytest.raises(TypeError, match="int32"):
        moe_gmm(x, w, on_cuda(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm(x, on_cuda(2, 24, 16).transpose(1, 2), nv)
    with pytest.raises(ValueError, match="share one device"):
        moe_gmm(x, torch.empty((2, 16, 24), dtype=torch.bfloat16), nv)
    with pytest.raises(ValueError, match=r"\(E,C,D\)"):
        moe_gmm(x, on_cuda(2, 8, 24), nv)
    with pytest.raises(ValueError, match="n_valid"):
        moe_gmm(x, w, on_cuda(3, dtype=torch.int32))
    m = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        moe_gmm(m, torch.empty((2, 16, 24), device="meta"))


# ------------------------------------------------------------------ #
# moe_ffn
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def ffn_params():
    """Layer 0's MoE weights of the port suite's cached mixtral model."""
    jc, jp, tc, tp = models(ARCH)
    return (jc, tc, jax.tree.map(lambda a: a[0], jp["main"]["moe"]),
            tp["main"][0]["moe"])


def run_both(monkeypatch, ffn_params, x, **over):
    """Both ``moe_ffn``s on ``x`` with ``over`` replacing config fields.

    Returns (JAX y, aux, scores, token indices), the port's likewise, and
    the port's scores before the capacity top-k.  The capacity top-k is
    the second top-k call of each function: (scores, token indices) of
    shape (G, E, C)."""
    jc, tc, jp, tp = ffn_params
    jc, tc = dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)
    seen = []
    jax_top_k, port_top_k = jax.lax.top_k, tmoe._top_k

    def jspy(a, k):
        out = jax_top_k(a, k)
        seen.append(out)
        return out

    def tspy(a, k):
        out = port_top_k(a, k)
        seen.append(out + (a,))
        return out

    def jax_run(p, xx):
        seen.clear()
        y, aux = jmoe.moe_ffn(p, jc, xx)
        return y, aux, seen[1]

    monkeypatch.setattr(jax.lax, "top_k", jspy)
    monkeypatch.setattr(tmoe, "_top_k", tspy)
    yj, aj, (js, ji) = jax.jit(jax_run)(jp, jnp.asarray(x))
    seen.clear()
    yt, at = tmoe.moe_ffn(tp, tc, torch.tensor(x))
    monkeypatch.undo()
    ts, ti, scores = seen[1]
    return ((np.asarray(yj), float(aj), np.asarray(js), np.asarray(ji)),
            (yt.numpy(), float(at), ts.numpy(), ti.numpy()), scores)


def assert_same(j, t):
    np.testing.assert_allclose(t[0], j[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t[1], j[1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t[3], j[3])        # token_idx
    np.testing.assert_array_equal(t[2] > 0, j[2] > 0)   # which are kept
    # top_scores: softmax and renormalisation round differently in the
    # last bit of fp32
    np.testing.assert_allclose(t[2], j[2], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_jax(monkeypatch, ffn_params, groups,
                             capacity_factor):
    x = np.random.default_rng(4).standard_normal((2, 12, 64)).astype(
        np.float32)
    j, t, _ = run_both(monkeypatch, ffn_params, x, moe_groups=groups,
                       capacity_factor=capacity_factor)
    assert_same(j, t)
    assert t[2].shape[0] == groups
    if capacity_factor < 1:            # the capacity drops tokens here
        assert (t[2] > 0).sum() < x.shape[0] * x.shape[1] * ffn_params[1].top_k


def test_moe_ffn_tie_order(monkeypatch, ffn_params):
    """Identical tokens tie on every score: the capacity keeps the lowest
    token indices, as ``jax.lax.top_k`` does and ``torch.topk`` does not."""
    x = np.random.default_rng(5).standard_normal((1, 1, 64)).astype(
        np.float32)
    x = np.repeat(x, 24, axis=1)
    j, t, scores = run_both(monkeypatch, ffn_params, x, capacity_factor=0.5)
    assert_same(j, t)
    c = j[3].shape[-1]
    assert c < x.shape[1] and (j[2] > 0).any()      # ties cut by capacity
    np.testing.assert_array_equal(j[3], np.broadcast_to(np.arange(c),
                                                        j[3].shape))
    # torch.topk over the same scores picks other tokens
    assert not np.array_equal(torch.topk(scores, c).indices.numpy(), j[3])


def test_moe_ffn_shared_experts(monkeypatch, ffn_params):
    """The shared-expert branch (deepseek's, not mixtral's)."""
    jc, tc, jp, tp = ffn_params
    jc = dataclasses.replace(jc, n_shared_experts=1)
    tc = dataclasses.replace(tc, n_shared_experts=1)
    rng = np.random.default_rng(5)
    d, f = jc.d_model, jc.moe_ff
    shared = {"w_in": rng.standard_normal((d, f)) / d ** 0.5,
              "w_gate": rng.standard_normal((d, f)) / d ** 0.5,
              "w_out": rng.standard_normal((f, d)) / f ** 0.5}
    jp = {**jp, "shared": {k: jnp.asarray(v, jnp.float32)
                           for k, v in shared.items()}}
    tp = {**tp, "shared": tree_from_numpy(shared, "cpu", torch.float32)}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    j, t, _ = run_both(monkeypatch, (jc, tc, jp, tp), x)
    assert_same(j, t)
    routed, _ = tmoe.moe_ffn(ffn_params[3], ffn_params[1], torch.tensor(x))
    assert np.abs(j[0] - routed.numpy()).max() > 1e-2   # the branch adds


# ------------------------------------------------------------------ #
# the whole model
# ------------------------------------------------------------------ #

def test_n_params_matches_jax():
    for cfg, jcfg in ((get_config(ARCH), jax_config(ARCH)),
                      (get_tiny(ARCH), jax_tiny(ARCH))):
        assert cfg.n_params() == jcfg.n_params()
    cut = dataclasses.replace(get_config(ARCH), n_layers=12)
    assert cut.n_params() == 30_451_390_464


def test_prefill_logits_match_jax():
    """The JAX parameters through the converter: whole-model prefill logits
    within 1e-5."""
    jc, jp, tc, tp = models(ARCH)
    assert isinstance(tp["main"][0]["moe"]["w_in"], torch.Tensor)
    assert tp["main"][0]["moe_norm"]["scale"].dtype == torch.float32
    tokens = np.random.default_rng(7).integers(0, jc.vocab_size, (2, 18))
    lj, _ = jax.jit(lambda p, b: jlm.prefill(p, jc, b, 24))(
        jp, {"tokens": jnp.asarray(tokens)})
    lt, _ = tlm.prefill(tp, tc, {"tokens": torch.tensor(tokens)}, 24)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                               rtol=1e-5)


def test_padded_engine_matches_jax():
    """The padded engine: the same tokens as the JAX padded engine, past
    the window of 16."""
    jc, jp, tc, tp = models(ARCH)
    prompts = np.random.default_rng(8).integers(0, jc.vocab_size, (3, 12),
                                                dtype=np.int32)
    sc = dict(max_prompt=12, max_new_tokens=8)
    assert 12 + 8 > tc.window
    want = jax_padded_engine(jc, jp, prompts, **sc).generate(prompts)
    got = Engine(tc, tp, ServeConfig(**sc), device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, want)


def test_other_families_still_refused():
    cfg = dataclasses.replace(get_tiny(ARCH), family="ssm")
    with pytest.raises(NotImplementedError, match="ssm"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError):
        cfg.n_params()

"""The port's model modules against the JAX package's, on the CPU.

Each test feeds the same inputs (made with numpy) and the same weights
(the JAX parameters carried across by ``repro_torch.models.convert``) to a
JAX function and its counterpart in the port, at ``tiny()`` sizes in
fp32.  Tolerance atol = rtol = 1e-4, for the order of reductions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jax_tiny
from repro.models import attention as jattn
from repro.models import cache as jcache
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import get_tiny
from repro_torch.models import attention as tattn
from repro_torch.models import cache as tcache
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.convert import tree_from_numpy
from test_torch_serve import models as serve_models

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen2-1.5b", "yi-6b", "h2o-danube-3-4b"]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def configs(arch):
    return (dataclasses.replace(jax_tiny(arch), dtype="float32"),
            dataclasses.replace(get_tiny(arch), dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, JAX cfg, port cfg, JAX params, port params), from the port
    suite's one cached initialisation per arch."""
    jc, jp, tc, tp = serve_models(request.param)
    return request.param, jc, tc, jp, tp


def layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["main"])


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ #
# layers
# ------------------------------------------------------------------ #

def test_rmsnorm_layer():
    rng = np.random.default_rng(0)
    x, s = randn(rng, 2, 5, 48), randn(rng, 48)
    close(tlayers.rmsnorm({"scale": torch.tensor(s)}, torch.tensor(x)),
          jlayers.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x)))


@pytest.mark.parametrize("mlp_type", ["gated_silu", "relu2", "gelu"])
def test_mlp(mlp_type):
    jc, tc = configs("yi-6b")
    jc = dataclasses.replace(jc, mlp_type=mlp_type)
    tc = dataclasses.replace(tc, mlp_type=mlp_type)
    jp = jlayers.init_mlp(jax.random.PRNGKey(1), 64, 128, mlp_type)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    x = randn(np.random.default_rng(1), 2, 5, 64)
    close(tlayers.mlp(tp, tc, torch.tensor(x)),
          jlayers.mlp(jp, jc, jnp.asarray(x)))


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope(batched):
    rng = np.random.default_rng(2)
    x = randn(rng, 2, 5, 3, 16)
    pos = (rng.integers(0, 100, (2, 5)) if batched
           else np.arange(5)).astype(np.int32)
    close(tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_embed_unembed(model):
    _, jc, tc, jp, tp = model
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 5))
    xt = tlayers.embed(tp["embed"], tc, torch.tensor(tokens))
    xj = jlayers.embed(jp["embed"], jc, jnp.asarray(tokens))
    close(xt, xj)
    close(tlm.head_logits(tp, tc, xt), jlm.head_logits(jp, jc, xj))


# ------------------------------------------------------------------ #
# attention and caches
# ------------------------------------------------------------------ #

def kv_caches(jc, tc, batch, max_len):
    """Layer-0 slices of a fresh linear (or ring) cache in both."""
    jcl = jax.tree.map(lambda a: a[0], jcache.init_kv_cache(jc, batch,
                                                             max_len))
    tcl = {k: v[0] for k, v in tcache.init_kv_cache(tc, batch,
                                                     max_len).items()}
    return jcl, tcl


def close_cache(tcl, jcl):
    for name in jcl:
        close(tcl[name], jcl[name])


def test_gqa_prefill_then_decode(model):
    """Prefill fills the cache (the SWA ring for danube: 20 tokens over a
    window of 16), then two decode steps attend it."""
    _, jc, tc, jp, tp = model
    rng = np.random.default_rng(4)
    s, max_len = 20, 24
    jcl, tcl = kv_caches(jc, tc, 2, max_len)
    x = randn(rng, 2, s, jc.d_model)
    pos = np.arange(s, dtype=np.int32)
    ja, ta = layer0(jp)["attn"], tp["main"][0]["attn"]
    yj, jcl = jax.jit(lambda *a: jattn.gqa_prefill(ja, jc, *a))(
        jnp.asarray(x), jnp.asarray(pos), jcl)
    yt, tcl = tattn.gqa_prefill(ta, tc, torch.tensor(x), torch.tensor(pos),
                                tcl)
    close(yt, yj)
    close_cache(tcl, jcl)
    decode = jax.jit(lambda *a: jattn.gqa_decode(ja, jc, *a))
    for t in (s, s + 1):
        x1 = randn(rng, 2, 1, jc.d_model)
        yj, jcl = decode(jnp.asarray(x1), t, jcl)
        yt, tcl = tattn.gqa_decode(ta, tc, torch.tensor(x1), t, tcl)
        close(yt, yj)
        close_cache(tcl, jcl)


BS, PAGES, B = 4, 4, 3                 # block size, pages per slot, slots
S_MAX = BS * PAGES


def paged_step(rng, chunk):
    """Numpy bookkeeping of one paged step over B slots.

    ``chunk`` None: a decode step (slot 2 idle); else a prefill chunk of
    that many rows (slot 1 starts mid-prompt, slot 2 is an unused row).
    """
    tables = 1 + np.arange(B * PAGES).reshape(B, PAGES)[::-1]
    gather = (tables[:, :, None] * BS + np.arange(BS)).reshape(B, S_MAX)
    if chunk is None:
        pos = np.array([7, 13, -1])
        write = np.where(pos >= 0, gather[np.arange(B), np.maximum(pos, 0)],
                         np.arange(B) % BS)
    else:
        j = np.arange(chunk)[None, :]
        c0, real = np.array([[0], [5], [0]]), np.array([[chunk], [3], [0]])
        rows = c0 + j
        pos = np.where(j < real, rows, -1)
        write = np.where(j < real, np.take_along_axis(
            gather, np.clip(rows, 0, S_MAX - 1), 1), j % BS)
    return pos, write, gather


def run_paged(jc, tc, pos, write, gather, jfn, tfn, x, jpool, tpool):
    jstep = {"pos": jnp.asarray(pos, jnp.int32),
             "write": jnp.asarray(write, jnp.int32),
             "gather": jnp.asarray(gather, jnp.int32)}
    jstep["mask"] = jcache.paged_valid_mask(jstep["pos"], S_MAX, jc.window)
    tstep = {k: torch.tensor(np.asarray(v, np.int64))
             for k, v in (("pos", pos), ("write", write), ("gather", gather))}
    tstep["mask"] = tcache.paged_valid_mask(tstep["pos"], S_MAX, tc.window)
    np.testing.assert_array_equal(tstep["mask"].numpy(),
                                  np.asarray(jstep["mask"]))
    yj, jpool = jax.jit(jfn)(x[0], jstep, jpool)
    yt, tpool = tfn(x[1], tstep, tpool)
    close(yt, yj)
    for name in jpool:
        close(tpool[name], jpool[name])


@pytest.mark.parametrize("chunk", [None, 6], ids=["decode", "prefill"])
def test_gqa_paged(model, chunk):
    _, jc, tc, jp, tp = model
    rng = np.random.default_rng(5)
    pos, write, gather = paged_step(rng, chunk)
    n_rows = (1 + B * PAGES) * BS
    k, v = (randn(rng, n_rows, jc.n_kv_heads, jc.head_dim) for _ in "kv")
    jpool = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tpool = {"k": torch.tensor(k), "v": torch.tensor(v)}
    x = randn(rng, B, chunk or 1, jc.d_model)
    ja, ta = layer0(jp)["attn"], tp["main"][0]["attn"]
    jfn, tfn = ((jattn.gqa_decode_paged, tattn.gqa_decode_paged)
                if chunk is None else
                (jattn.gqa_prefill_paged, tattn.gqa_prefill_paged))
    run_paged(jc, tc, pos, write, gather,
              lambda xx, st, pl: jfn(ja, jc, xx, st, pl),
              lambda xx, st, pl: tfn(ta, tc, xx, st, pl),
              (jnp.asarray(x), torch.tensor(x)), jpool, tpool)


# ------------------------------------------------------------------ #
# the language model
# ------------------------------------------------------------------ #

def test_lm_prefill_decode(model):
    _, jc, tc, jp, tp = model
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jc.vocab_size, (2, 18))
    lj, cj = jax.jit(lambda p, b: jlm.prefill(p, jc, b, 24))(
        jp, {"tokens": jnp.asarray(tokens)})
    decode = jax.jit(lambda p, b, c, t: jlm.decode_step(p, jc, b, c, t))
    lt, ct = tlm.prefill(tp, tc, {"tokens": torch.tensor(tokens)}, 24)
    close(lt, lj)
    for t in (18, 19):
        nxt = rng.integers(0, jc.vocab_size, (2, 1))
        lj, cj = decode(jp, {"tokens": jnp.asarray(nxt)}, cj, t)
        lt, ct = tlm.decode_step(tp, tc, {"tokens": torch.tensor(nxt)}, ct, t)
        close(lt, lj)
    for name in cj["main"]:
        close(ct["main"][name], cj["main"][name])


@pytest.mark.parametrize("chunk", [None, 6], ids=["decode", "prefill"])
def test_lm_paged_steps(model, chunk):
    _, jc, tc, jp, tp = model
    rng = np.random.default_rng(7)
    pos, write, gather = paged_step(rng, chunk)
    shape = (jc.n_layers, (1 + B * PAGES) * BS, jc.n_kv_heads, jc.head_dim)
    k, v = randn(rng, *shape), randn(rng, *shape)
    tokens = rng.integers(0, jc.vocab_size, (B, chunk or 1))
    jfn, tfn = ((jlm.decode_step_paged, tlm.decode_step_paged)
                if chunk is None else
                (jlm.prefill_chunk_paged, tlm.prefill_chunk_paged))

    def jrun(tok, st, pool):
        logits, c = jfn(jp, jc, {"tokens": tok}, {"main": pool}, st)
        return logits, c["main"]

    def trun(tok, st, pool):
        logits, c = tfn(tp, tc, {"tokens": tok}, {"main": pool}, st)
        return logits, c["main"]

    run_paged(jc, tc, pos, write, gather, jrun, trun,
              (jnp.asarray(tokens), torch.tensor(tokens)),
              {"k": jnp.asarray(k), "v": jnp.asarray(v)},
              {"k": torch.tensor(k), "v": torch.tensor(v)})

"""The port's model modules against the JAX package's, on the CPU.

Each test feeds the same inputs (made with numpy) and the same weights
(the JAX parameters carried across by ``repro_torch.models.convert``) to a
JAX function and its counterpart in the port, at ``tiny()`` sizes in
fp32.  Tolerance atol = rtol = 1e-4, for the order of reductions.
"""

import dataclasses
import functools

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
from test_torch_serve import on_threads

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
# the JAX side of the attention, cache and model tests
# ------------------------------------------------------------------ #

def jax_kv_cache(jc, batch, max_len):
    """Layer-0 slice of a fresh linear (or ring) JAX cache."""
    return jax.tree.map(lambda a: a[0], jcache.init_kv_cache(jc, batch,
                                                            max_len))


def close_cache(tcl, jcl):
    for name in jcl:
        close(tcl[name], jcl[name])


GQA_S, GQA_MAX = 20, 24


def gqa_inputs(jc):
    """A 20-token prefill and two decode tokens."""
    rng = np.random.default_rng(4)
    return (randn(rng, 2, GQA_S, jc.d_model),
            [randn(rng, 2, 1, jc.d_model) for _ in range(2)])


def jax_gqa(jc, jp):
    """The JAX prefill, then two decode steps: each output and cache."""
    x, x1s = gqa_inputs(jc)
    ja = layer0(jp)["attn"]
    jcl = jax_kv_cache(jc, 2, GQA_MAX)
    yj, jcl = jax.jit(lambda *a: jattn.gqa_prefill(ja, jc, *a))(
        jnp.asarray(x), jnp.arange(GQA_S, dtype=jnp.int32), jcl)
    out = [(yj, jcl)]
    decode = jax.jit(lambda *a: jattn.gqa_decode(ja, jc, *a))
    for t, x1 in zip((GQA_S, GQA_S + 1), x1s):
        yj, jcl = decode(jnp.asarray(x1), t, jcl)
        out.append((yj, jcl))
    return jax.block_until_ready(out)


BS, PAGES, B = 4, 4, 3                 # block size, pages per slot, slots
S_MAX = BS * PAGES


def paged_step(chunk):
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


def jax_paged(jc, step, jfn, x, pool):
    """One JAX paged step: its mask, output and pool."""
    pos, write, gather = step
    jstep = {"pos": jnp.asarray(pos, jnp.int32),
             "write": jnp.asarray(write, jnp.int32),
             "gather": jnp.asarray(gather, jnp.int32)}
    jstep["mask"] = jcache.paged_valid_mask(jstep["pos"], S_MAX, jc.window)
    yj, jpool = jax.jit(jfn)(jnp.asarray(x), jstep,
                             {k: jnp.asarray(v) for k, v in pool.items()})
    return jax.block_until_ready((jstep["mask"], yj, jpool))


def port_paged(tc, step, tfn, x, pool, want):
    """The port's paged step on the same inputs, against ``jax_paged``'s
    mask, output and pool."""
    pos, write, gather = step
    jmask, yj, jpool = want
    tstep = {k: torch.tensor(np.asarray(v, np.int64))
             for k, v in (("pos", pos), ("write", write), ("gather", gather))}
    tstep["mask"] = tcache.paged_valid_mask(tstep["pos"], S_MAX, tc.window)
    np.testing.assert_array_equal(tstep["mask"].numpy(), np.asarray(jmask))
    yt, tpool = tfn(torch.tensor(x), tstep,
                    {k: torch.tensor(v) for k, v in pool.items()})
    close(yt, yj)
    for name in jpool:
        close(tpool[name], jpool[name])


def gqa_paged_inputs(jc, chunk):
    rng = np.random.default_rng(5)
    n_rows = (1 + B * PAGES) * BS
    k, v = (randn(rng, n_rows, jc.n_kv_heads, jc.head_dim) for _ in "kv")
    return {"k": k, "v": v}, randn(rng, B, chunk or 1, jc.d_model)


def jax_gqa_paged(jc, jp, chunk):
    pool, x = gqa_paged_inputs(jc, chunk)
    ja = layer0(jp)["attn"]
    jfn = jattn.gqa_decode_paged if chunk is None else jattn.gqa_prefill_paged
    return jax_paged(jc, paged_step(chunk),
                     lambda xx, st, pl: jfn(ja, jc, xx, st, pl), x, pool)


LM_LEN = 18


def lm_inputs(jc):
    """An 18-token prompt and two decode tokens."""
    rng = np.random.default_rng(6)
    return (rng.integers(0, jc.vocab_size, (2, LM_LEN)),
            [rng.integers(0, jc.vocab_size, (2, 1)) for _ in range(2)])


def jax_lm(jc, jp):
    """The JAX prefill's logits, two decode steps' and the last cache."""
    tokens, nxts = lm_inputs(jc)
    lj, cj = jax.jit(lambda p, b: jlm.prefill(p, jc, b, 24))(
        jp, {"tokens": jnp.asarray(tokens)})
    logits = [lj]
    decode = jax.jit(lambda p, b, c, t: jlm.decode_step(p, jc, b, c, t))
    for t, nxt in zip((LM_LEN, LM_LEN + 1), nxts):
        lj, cj = decode(jp, {"tokens": jnp.asarray(nxt)}, cj, t)
        logits.append(lj)
    return jax.block_until_ready((logits, cj))


def lm_paged_inputs(jc, chunk):
    rng = np.random.default_rng(7)
    shape = (jc.n_layers, (1 + B * PAGES) * BS, jc.n_kv_heads, jc.head_dim)
    pool = {"k": randn(rng, *shape), "v": randn(rng, *shape)}
    return pool, rng.integers(0, jc.vocab_size, (B, chunk or 1))


def jax_lm_paged(jc, jp, chunk):
    pool, tokens = lm_paged_inputs(jc, chunk)
    jfn = jlm.decode_step_paged if chunk is None else jlm.prefill_chunk_paged

    def jrun(tok, st, pl):
        logits, c = jfn(jp, jc, {"tokens": tok}, {"main": pl}, st)
        return logits, c["main"]

    return jax_paged(jc, paged_step(chunk), jrun, tokens, pool)


JAX_RUNS = {"gqa": jax_gqa, "gqa_paged": jax_gqa_paged, "lm": jax_lm,
            "lm_paged": jax_lm_paged}


@functools.cache
def jax_side(arch):
    """The JAX side of the attention, cache and model tests below for one
    arch, computed on threads so that their compiles overlap."""
    jc, jp, _, _ = serve_models(arch)
    return on_threads(lambda name, *a: JAX_RUNS[name](jc, jp, *a),
                      [("gqa",), ("gqa_paged", None), ("gqa_paged", 6),
                       ("lm",), ("lm_paged", None), ("lm_paged", 6)])


# ------------------------------------------------------------------ #
# attention and caches
# ------------------------------------------------------------------ #

def test_gqa_prefill_then_decode(model):
    """Prefill fills the cache (the SWA ring for danube: 20 tokens over a
    window of 16), then two decode steps attend it."""
    arch, jc, tc, jp, tp = model
    x, x1s = gqa_inputs(jc)
    ta = tp["main"][0]["attn"]
    want = jax_side(arch)["gqa", ]
    tcl = {k: v[0] for k, v in tcache.init_kv_cache(tc, 2, GQA_MAX).items()}
    yt, tcl = tattn.gqa_prefill(ta, tc, torch.tensor(x),
                                torch.arange(GQA_S, dtype=torch.int32), tcl)
    close(yt, want[0][0])
    close_cache(tcl, want[0][1])
    for t, x1, (yj, jcl) in zip((GQA_S, GQA_S + 1), x1s, want[1:]):
        yt, tcl = tattn.gqa_decode(ta, tc, torch.tensor(x1), t, tcl)
        close(yt, yj)
        close_cache(tcl, jcl)


@pytest.mark.parametrize("chunk", [None, 6], ids=["decode", "prefill"])
def test_gqa_paged(model, chunk):
    arch, jc, tc, jp, tp = model
    pool, x = gqa_paged_inputs(jc, chunk)
    ta = tp["main"][0]["attn"]
    tfn = tattn.gqa_decode_paged if chunk is None else tattn.gqa_prefill_paged
    port_paged(tc, paged_step(chunk),
               lambda xx, st, pl: tfn(ta, tc, xx, st, pl), x, pool,
               jax_side(arch)["gqa_paged", chunk])


# ------------------------------------------------------------------ #
# the language model
# ------------------------------------------------------------------ #

def test_lm_prefill_decode(model):
    arch, jc, tc, jp, tp = model
    tokens, nxts = lm_inputs(jc)
    logits, cj = jax_side(arch)["lm", ]
    lt, ct = tlm.prefill(tp, tc, {"tokens": torch.tensor(tokens)}, 24)
    close(lt, logits[0])
    for t, nxt, lj in zip((LM_LEN, LM_LEN + 1), nxts, logits[1:]):
        lt, ct = tlm.decode_step(tp, tc, {"tokens": torch.tensor(nxt)}, ct, t)
        close(lt, lj)
    for name in cj["main"]:
        close(ct["main"][name], cj["main"][name])


@pytest.mark.parametrize("chunk", [None, 6], ids=["decode", "prefill"])
def test_lm_paged_steps(model, chunk):
    arch, jc, tc, jp, tp = model
    pool, tokens = lm_paged_inputs(jc, chunk)
    tfn = tlm.decode_step_paged if chunk is None else tlm.prefill_chunk_paged

    def trun(tok, st, pl):
        logits, c = tfn(tp, tc, {"tokens": tok}, {"main": pl}, st)
        return logits, c["main"]

    port_paged(tc, paged_step(chunk), trun, tokens, pool,
               jax_side(arch)["lm_paged", chunk])

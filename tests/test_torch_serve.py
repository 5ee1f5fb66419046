"""The port's serving engines against the JAX package's, on the CPU.

The port's ``ContinuousEngine`` must emit the same tokens as the JAX
``ContinuousEngine`` with the same ``ServeConfig``, requests and arrivals,
at ``tiny()`` sizes in fp32, for qwen2 (QKV bias, tied embeddings), yi,
h2o-danube (sliding window 16, crossed by prompt + generation) and mixtral
(MoE experts, window 16).  The port
is also held to its own padded engine, to its block-table datatype view,
and to the recycling and admission rules of the JAX engine's cases.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jax_tiny
from repro.models import lm as jlm
from repro.serve.engine import ContinuousEngine as JaxContinuousEngine
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_tiny
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig
from repro_torch.serve.scheduler import DECODE, PREFILL, Request, Scheduler

# Start torch's intra-op thread pool before any test computes: the first
# parallel kernels of a newly started pool have been seen, on a virtual
# machine, to return exp off by about 1e-4 (relative) in some threads'
# shares, where every later call is right.
torch.exp(torch.zeros(1 << 17))
torch.zeros(1 << 17).add_(1)

SERVE = dict(max_prompt=16, max_new_tokens=10, eos_id=-1, block_size=4,
             n_blocks=24, max_slots=4, prefill_chunk=6, prefill_batch=3)
# (prompt length, budget, arrival): five requests over four slots
WORK = [(5, 7, 0), (9, 10, 0), (13, 3, 1), (5, 1, 2), (16, 10, 2)]

_CTX = {}


def models(arch):
    """Cached (JAX cfg, JAX params, port cfg, port params) in fp32."""
    if arch not in _CTX:
        jc = dataclasses.replace(jax_tiny(arch), dtype="float32")
        tc = dataclasses.replace(get_tiny(arch), dtype="float32")
        # XLA's lowest optimisation level: compiling the initialisation
        # costs more than running it, and both sides get the same values
        jp = jax.jit(lambda key: jlm.init_params(jc, key),
                     compiler_options={"xla_backend_optimization_level": 0})(
            jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
        _CTX[arch] = (jc, jp, tc, tp)
    return _CTX[arch]


def on_threads(fn, cases, workers=4):
    """``fn(*case)`` for every case on threads, so that the JAX compiles
    they start overlap (XLA compiles without the GIL): {case: result}."""
    with ThreadPoolExecutor(workers) as pool:
        done = {case: pool.submit(fn, *case) for case in cases}
        return {case: f.result() for case, f in done.items()}


def jax_padded_engine(jc, jp, prompts, **sc):
    """The JAX padded engine for ``prompts``, its decode step compiled on
    a second thread while its prefill compiles (XLA compiles without the
    GIL): ``generate`` then finds both compiled."""
    eng = JaxEngine(jc, jp, JaxServeConfig(**sc))
    batch = {"tokens": jnp.asarray(prompts)}
    _, caches = jax.eval_shape(eng._prefill, jp, batch)

    def decode():
        eng._decode(jp, {"tokens": jnp.zeros((len(prompts), 1), jnp.int32)},
                    jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                                 caches), prompts.shape[1])

    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(decode)
        eng._prefill(jp, batch)
        done.result()
    return eng


def workload(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (n,), dtype=np.int32), m, a)
            for n, m, a in WORK]


def serve(eng, work):
    rids = [eng.submit(p, m, arrival=a) for p, m, a in work]
    res = eng.run()
    return [list(res[r]) for r in rids]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "yi-6b", "h2o-danube-3-4b",
                                  "mixtral-8x22b"])
def test_continuous_matches_jax(arch):
    jc, jp, tc, tp = models(arch)
    work = workload()
    if tc.window is not None:      # the SWA case must cross its window
        assert max(len(p) + m for p, m, _ in work) > tc.window
    want = serve(JaxContinuousEngine(jc, jp, JaxServeConfig(**SERVE)), work)
    eng = ContinuousEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    assert serve(eng, work) == want
    assert eng.stats["peak_active"] == 4


def test_continuous_matches_padded():
    """Each request's stream equals one-request padded generation."""
    _, _, tc, tp = models("yi-6b")
    eng = ContinuousEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    work = workload(1)
    got = serve(eng, work)
    ref = Engine(tc, tp, ServeConfig(max_prompt=16, max_new_tokens=10),
                 device="cpu")
    for (p, m, _), toks in zip(work, got):
        assert toks == list(ref.generate(p[None, :])[0, :m])


def test_cpu_run_launches_no_kernel():
    for arch in ("qwen2-1.5b", "mixtral-8x22b"):
        _, _, tc, tp = models(arch)
        before = (rmsnorm_fused.launches, decode_attention.launches,
                  moe_gmm.launches)
        eng = ContinuousEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
        serve(eng, workload(2))
        assert eng.stats["decode_steps"] > 0
        assert (rmsnorm_fused.launches, decode_attention.launches,
                moe_gmm.launches) == before


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without a CUDA device and without device="cpu", entry points
    raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("qwen2-1.5b", "mixtral-8x22b"):
        _, _, tc, tp = models(arch)
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousEngine(tc, tp, ServeConfig(**SERVE))
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(tc, tp, ServeConfig(**SERVE))
        with pytest.raises(RuntimeError, match="CUDA"):
            tlm.init_params(tc, torch.Generator().manual_seed(0))


def test_block_and_slot_recycling():
    _, _, tc, tp = models("yi-6b")
    eng = ContinuousEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    free0, v0 = eng.cache.free_blocks, eng.cache.version
    rng = np.random.default_rng(5)
    for i in range(6):
        eng.submit(rng.integers(0, 256, (WORK[i % 5][0],), dtype=np.int32),
                   4 + (i % 3))
    eng.run()
    assert eng.cache.version > v0            # tables actually churned
    assert eng.stats["peak_active"] == 4     # slots were saturated...
    assert eng.cache.free_blocks == free0    # ...and everything came back
    assert sorted(eng.cache._free) == list(range(1, SERVE["n_blocks"]))
    assert not eng.cache.tables.any() and not eng.cache.n_tokens.any()
    assert eng.sched.idle and eng.sched.free_slots == SERVE["max_slots"]


def test_paged_equals_dense():
    """K/V packed through the block-table datatype view equal the padded
    engine's linear cache, and the streams agree.  Equal to rounding, not
    bitwise: the paged decode step attends through the decode-attention
    kernel's plain version, the linear cache through ``_sdpa``, so layer
    1's K/V differ in the last bits."""
    _, _, tc, tp = models("qwen2-1.5b")
    eng = ContinuousEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    prompt, mnt = workload(4)[2][0], 6
    n_kv = len(prompt) + mnt - 1
    snap = {}
    orig = eng.cache.free_slot

    def free_slot(slot):
        snap.update(eng.cache.extract(slot, n_kv))
        orig(slot)

    eng.cache.free_slot = free_slot
    rid = eng.submit(prompt, mnt)
    res = eng.run()
    logits, caches = tlm.prefill(tp, tc, {"tokens": torch.tensor(
        prompt[None, :].astype(np.int64))}, 24)
    toks = [int(logits[0, 0, :tc.vocab_size].argmax())]
    for i in range(mnt - 1):
        logits, caches = tlm.decode_step(tp, tc, {"tokens": torch.tensor(
            [[toks[-1]]])}, caches, len(prompt) + i)
        toks.append(int(logits[0, 0, :tc.vocab_size].argmax()))
    assert toks == list(res[rid])
    for name in ("k", "v"):
        torch.testing.assert_close(caches["main"][name][:, 0, :n_kv],
                                   snap[name], rtol=1e-5, atol=1e-5)


def test_gather_rows_match_datatype_view():
    _, _, tc, tp = models("yi-6b")
    cache = ContinuousEngine(tc, tp, ServeConfig(**SERVE),
                             device="cpu").cache
    cache.alloc_slot(2, 10)
    cache.alloc_slot(0, 5)       # interleave so slot 2's blocks aren't 1..k
    for slot, n in ((2, 10), (0, 5)):
        rows = torch.arange(cache.n_blocks * cache.block_size)
        picked = cache.seq_datatype(slot, n).pack(rows).numpy()
        np.testing.assert_array_equal(picked, cache.gather_row(slot)[:n])


def test_eos_contract_continuous():
    _, _, tc, tp = models("yi-6b")
    eng = ContinuousEngine(tc, tp, ServeConfig(**SERVE), device="cpu")
    rng = np.random.default_rng(2)
    prompts = np.stack([rng.integers(0, 256, (5,), dtype=np.int32)
                        for _ in range(3)])
    base = eng.generate(prompts)
    eos = int(base[0, 2])
    eng = ContinuousEngine(tc, tp, ServeConfig(**{**SERVE, "eos_id": eos}),
                           device="cpu")
    out = eng.generate(prompts)
    assert out.shape == base.shape
    for r in range(3):
        hits = np.flatnonzero(base[r] == eos)
        first = hits[0] if len(hits) else base.shape[1] - 1
        assert list(out[r, :first + 1]) == list(base[r, :first + 1])
        assert np.all(out[r, first + 1:] == eos)


def test_admission_under_pressure():
    """Block pressure drains the queue one request at a time, FIFO, and
    requests that could never be served are refused at submit."""
    _, _, tc, tp = models("yi-6b")
    eng = ContinuousEngine(tc, tp, ServeConfig(
        max_prompt=8, max_new_tokens=6, eos_id=-1, block_size=4,
        n_blocks=6, max_slots=2, prefill_chunk=6, prefill_batch=2),
        device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, (5,), dtype=np.int32) for _ in range(4)]
    rids = [eng.submit(p, 6) for p in prompts]
    res = eng.run()
    assert eng.stats["peak_active"] == 1
    assert list(res) == rids
    for bad in ((rng.integers(0, 256, (9,), np.int32), 2),
                (prompts[0], 0), (prompts[0], 99)):
        with pytest.raises(ValueError):
            eng.submit(*bad)


def test_scheduler_fifo():
    sched = Scheduler(max_slots=2)
    p = np.zeros((4,), np.int32)
    for rid, arr in ((0, 0), (1, 0), (2, 5)):
        sched.submit(Request(rid, p, 3, arrival=arr))
    got = sched.admissible(0, lambda s_, n: True)
    assert [r.rid for r in got] == [0, 1]
    assert all(r.state == PREFILL for r in got)
    assert sched.admissible(5, lambda s_, n: True) == []   # no slot free
    got[0].state = DECODE
    assert [r.rid for r in sched.decoding()] == [got[0].rid]
    sched.release(got[0])
    assert sched.admissible(4, lambda s_, n: True) == []   # rid 2 not arrived
    assert sched.admissible(5, lambda s_, n: False) == []  # blocks short
    assert [r.rid for r in sched.admissible(5, lambda s_, n: True)] == [2]

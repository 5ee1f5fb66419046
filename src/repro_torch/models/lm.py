"""The language model, dense, (non-MLA) MoE and hybrid families: init,
caches, prefill and decode.

Hybrid is zamba2: a stack of Mamba2 blocks with one shared dense block
applied after every full run of ``shared_attn_every`` of them.  Other
families (MLA, SSM, modality frontends) raise ``NotImplementedError``;
ROADMAP.md queues them.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed, init_embed, init_rmsnorm,
                                       rmsnorm, unembed)


def check_ported(cfg) -> str:
    """The block kind of ``cfg``'s stack: "dense", "moe" or, for the
    hybrid family, "mamba".

    Raises:
        NotImplementedError: any other family.
    """
    if cfg.family in ("dense", "moe"):
        return cfg.family
    if cfg.family == "hybrid":
        return "mamba"
    raise NotImplementedError(
        f"family {cfg.family} is not ported yet (dense, moe and hybrid "
        f"only)")


def _hybrid_segments(cfg):
    """zamba2: contiguous mamba runs, shared attn block after each full
    run.  [(start, end, full)]."""
    k = cfg.shared_attn_every
    segs, start = [], 0
    while start < cfg.n_layers:
        end = min(start + k, cfg.n_layers)
        segs.append((start, end, end - start == k))
        start = end
    return segs


# ===================================================================== #
# init
# ===================================================================== #

def init_params(cfg, generator, device=None):
    """Random parameters with the JAX package's distributions.

    Drawn on ``generator``'s device and placed on ``device`` (the card
    unless ``"cpu"`` is asked for).  Matrices, tables, biases and the
    Mamba2 conv weights are held in the activation type; RMSNorm scales
    and the Mamba2 ``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` stay
    fp32.
    """
    kind = check_ported(cfg)
    dev = resolve_device(device)
    dt = cfg.act_dtype
    p = {"embed": init_embed(generator, cfg.padded_vocab, cfg.d_model, dev,
                             dt)}
    if not cfg.tie_embeddings:
        p["head"] = init_embed(generator, cfg.padded_vocab, cfg.d_model, dev,
                               dt)
    p["final_norm"] = init_rmsnorm(cfg.d_model, dev)
    if kind == "mamba":
        p["mamba"] = tfm.init_stack(generator, cfg, kind, cfg.n_layers, dev,
                                    dt)
        p["shared"] = tfm.init_block(generator, cfg, "dense", dev, dt)
    else:
        p["main"] = tfm.init_stack(generator, cfg, kind, cfg.n_layers, dev,
                                   dt)
    return p


# ===================================================================== #
# caches
# ===================================================================== #

def init_cache(cfg, batch, max_len, device=None):
    if check_ported(cfg) == "mamba":
        # the shared attention block: one KV cache per application
        n_apps = sum(1 for s in _hybrid_segments(cfg) if s[2])
        return {"mamba": cache_lib.init_ssm_state(cfg, batch, device=device),
                "shared": cache_lib.init_kv_cache(cfg, batch, max_len,
                                                  device=device,
                                                  n_layers=n_apps)}
    return {"main": cache_lib.init_kv_cache(cfg, batch, max_len,
                                            device=device)}


def init_paged_cache(cfg, n_blocks, block_size, device=None):
    """Paged KV pool for the continuous-batching serving engine.

    Only GQA KV families page: the hybrid family's SSM state is
    linear-only, so asking for a paged cache raises and the engine fails
    at construction, as in the JAX package.
    """
    if check_ported(cfg) not in ("dense", "moe"):
        raise NotImplementedError(
            f"paged KV serving supports GQA families; {cfg.family} caches "
            f"(MLA latent / SSM state) are linear-only")
    return {"main": cache_lib.init_paged_kv_cache(cfg, n_blocks, block_size,
                                                  device=device)}


# ===================================================================== #
# trunk, embedding, head
# ===================================================================== #

def trunk(params, cfg, x, positions, mode, t=None, caches=None):
    """Apply the model trunk. Returns (x, caches), caches updated in
    place."""
    kind = check_ported(cfg)
    if kind == "mamba":
        return _hybrid_trunk(params, cfg, x, positions, mode, t, caches)
    x, cache = tfm.stack_apply(params["main"], cfg, kind, x, positions,
                               mode, t, None if caches is None
                               else caches["main"])
    return x, (None if caches is None else {"main": cache})


def _hybrid_trunk(params, cfg, x, positions, mode, t, caches):
    """zamba2: each run of Mamba2 layers, then the shared block (its own
    KV cache per application) after every full run.  The Mamba2 state and
    the KV caches are updated in place through their slices."""
    app = 0
    for (a, b, full) in _hybrid_segments(cfg):
        seg_cache = {name: arr[a:b] for name, arr in caches["mamba"].items()}
        x, _ = tfm.stack_apply(params["mamba"][a:b], cfg, "mamba", x,
                               positions, mode, t, seg_cache)
        if full:
            sc = {name: arr[app] for name, arr in caches["shared"].items()}
            x, _ = tfm.block_apply(params["shared"], cfg, "dense", x,
                                   positions, mode, t, sc)
            app += 1
    return x, caches


def embed_inputs(params, cfg, batch):
    """Token embedding (text-only families)."""
    return embed(params["embed"], cfg, batch["tokens"])


def head_logits(params, cfg, x):
    table = params["head"]["table"] if "head" in params \
        else params["embed"]["table"]
    return unembed(None, cfg, x, table=table)


# ===================================================================== #
# top-level steps
# ===================================================================== #

def prefill(params, cfg, batch, max_len):
    """Fill caches from a prompt. Returns (last_logits, caches)."""
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    caches = init_cache(cfg, b, max_len, device=x.device)
    x, caches = trunk(params, cfg, x, positions, "prefill", caches=caches)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return head_logits(params, cfg, x[:, -1:]), caches


def decode_step(params, cfg, batch, caches, t):
    """One decode step at position ``t``. Returns (logits, caches)."""
    x = embed_inputs(params, cfg, batch)          # (B,1,d)
    positions = torch.full((1,), t, dtype=torch.int32, device=x.device)
    x, caches = trunk(params, cfg, x, positions, "decode", t=t,
                      caches=caches)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return head_logits(params, cfg, x), caches


def prefill_chunk_paged(params, cfg, batch, caches, step):
    """Prefill one fixed-size chunk of up to B sequences into the paged
    pool.

    batch["tokens"] is (B, C); ``step`` is the per-chunk bookkeeping dict
    (see ``attention.gqa_prefill_paged``).  Returns (logits (B, C, V),
    caches).
    """
    x = embed_inputs(params, cfg, batch)
    x, caches = trunk(params, cfg, x, step["pos"], "paged_prefill", t=step,
                      caches=caches)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return head_logits(params, cfg, x), caches


def decode_step_paged(params, cfg, batch, caches, step):
    """One continuous-batch decode step over every serving slot.

    batch["tokens"] is (B, 1) with B = max_slots; each slot advances at its
    own position ``step["pos"][b]``.  Returns (logits (B, 1, V), caches).
    """
    x = embed_inputs(params, cfg, batch)
    x, caches = trunk(params, cfg, x, step["pos"], "paged_decode", t=step,
                      caches=caches)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return head_logits(params, cfg, x), caches

"""The language model, dense and (non-MLA) MoE families: init, caches,
prefill and decode.

Other families (MLA, hybrid, SSM, modality frontends) raise
``NotImplementedError``; ROADMAP.md queues them.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed, init_embed, init_rmsnorm,
                                       rmsnorm, unembed)


def check_ported(cfg) -> str:
    """The block kind of ``cfg``'s stack: "dense" or "moe".

    Raises:
        NotImplementedError: any other family.
    """
    if cfg.family in ("dense", "moe"):
        return cfg.family
    raise NotImplementedError(
        f"family {cfg.family} is not ported yet (dense and moe only)")


# ===================================================================== #
# init
# ===================================================================== #

def init_params(cfg, generator, device=None):
    """Random parameters with the JAX package's distributions.

    Drawn on ``generator``'s device and placed on ``device`` (the card
    unless ``"cpu"`` is asked for).  Matrices, tables and biases are held
    in the activation type; RMSNorm scales stay fp32.
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
    p["main"] = tfm.init_stack(generator, cfg, kind, cfg.n_layers, dev, dt)
    return p


# ===================================================================== #
# caches
# ===================================================================== #

def init_cache(cfg, batch, max_len, device=None):
    check_ported(cfg)
    return {"main": cache_lib.init_kv_cache(cfg, batch, max_len,
                                            device=device)}


def init_paged_cache(cfg, n_blocks, block_size, device=None):
    """Paged KV pool for the continuous-batching serving engine (GQA
    families only)."""
    check_ported(cfg)
    return {"main": cache_lib.init_paged_kv_cache(cfg, n_blocks, block_size,
                                                  device=device)}


# ===================================================================== #
# trunk, embedding, head
# ===================================================================== #

def trunk(params, cfg, x, positions, mode, t=None, caches=None):
    """Apply the model trunk. Returns (x, caches), caches updated in
    place."""
    kind = check_ported(cfg)
    x, cache = tfm.stack_apply(params["main"], cfg, kind, x, positions,
                               mode, t, None if caches is None
                               else caches["main"])
    return x, (None if caches is None else {"main": cache})


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

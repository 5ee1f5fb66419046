"""Block assembly and layer stacks.

Block kinds:
  dense — GQA attn + MLP       (qwen2, yi, danube, zamba2's shared block)
  moe   — GQA attn + MoE FFN   (mixtral)
  mamba — Mamba2 mixer only    (zamba2 backbone)

A stack is a list of per-layer parameter dicts, applied by a Python loop
over layers (the JAX package scans stacked parameters).  A cache, where
there is one, keeps its leading layer axis; each layer updates its slice
in place.
"""

from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm

ATTN_KINDS = {"dense", "moe"}


def init_block(generator, cfg, kind, device=None, dtype=None):
    if kind == "mamba":
        return {"mamba_norm": init_rmsnorm(cfg.d_model, device),
                "mamba": ssm_lib.init_mamba2(generator, cfg, device, dtype)}
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind} is not ported yet")
    p = {"attn_norm": init_rmsnorm(cfg.d_model, device),
         "attn": attn.init_gqa(generator, cfg, device, dtype)}
    if kind == "dense":
        p["mlp_norm"] = init_rmsnorm(cfg.d_model, device)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                            device, dtype)
    else:
        p["moe_norm"] = init_rmsnorm(cfg.d_model, device)
        p["moe"] = moe_lib.init_moe(generator, cfg, device, dtype)
    return p


def _mix(params, cfg, kind, x, positions, mode, t=None, cache=None):
    """Sequence-mixer sublayer. Returns (y, cache)."""
    if kind not in ATTN_KINDS:
        if mode in ("paged_prefill", "paged_decode"):
            raise ValueError(f"paged KV serving is GQA-only; {kind} caches "
                             f"(MLA latent / SSM state) are linear-only")
        if kind != "mamba":
            raise NotImplementedError(f"block kind {kind} is not ported yet")
        return _mamba_mix(params, cfg, x, mode, cache)
    h = rmsnorm(params["attn_norm"], x, cfg.norm_eps)
    if mode == "prefill":
        return attn.gqa_prefill(params["attn"], cfg, h, positions, cache)
    if mode == "paged_prefill":      # t carries the paged step dict
        return attn.gqa_prefill_paged(params["attn"], cfg, h, t, cache)
    if mode == "paged_decode":
        return attn.gqa_decode_paged(params["attn"], cfg, h, t, cache)
    if mode == "decode":
        return attn.gqa_decode(params["attn"], cfg, h, t, cache)
    raise NotImplementedError(f"mode {mode} is not ported yet")


def _mamba_mix(params, cfg, x, mode, state):
    """The Mamba2 mixer; its conv and SSD state are updated in place."""
    h = rmsnorm(params["mamba_norm"], x, cfg.norm_eps)
    if mode == "prefill":
        y, new = ssm_lib.mamba2_forward(params["mamba"], cfg, h, state)
    elif mode == "decode":
        y, new = ssm_lib.mamba2_decode(params["mamba"], cfg, h, state)
    else:
        raise NotImplementedError(f"mode {mode} is not ported yet")
    state["conv"].copy_(new["conv"])
    state["ssd"].copy_(new["ssd"])
    return y, state


def block_apply(params, cfg, kind, x, positions, mode, t=None, cache=None):
    """One block. Returns (x, cache); the serving modes drop the MoE aux
    loss."""
    y, cache = _mix(params, cfg, kind, x, positions, mode, t, cache)
    x = x + y
    if kind == "mamba":
        return x, cache
    if kind == "moe":
        h = rmsnorm(params["moe_norm"], x, cfg.norm_eps)
        y, _aux = moe_lib.moe_ffn(params["moe"], cfg, h)
        return x + y, cache
    h = rmsnorm(params["mlp_norm"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], cfg, h), cache


def init_stack(generator, cfg, kind, n_layers, device=None, dtype=None):
    """Per-layer parameter dicts, one list entry per layer."""
    return [init_block(generator, cfg, kind, device, dtype)
            for _ in range(n_layers)]


def stack_apply(stack_params, cfg, kind, x, positions, mode, t=None,
                cache=None):
    """Apply the stack. ``cache`` (if any) carries a leading layer axis and
    is updated in place. Returns (x, cache)."""
    for i, lp in enumerate(stack_params):
        lcache = None if cache is None else {
            name: arr[i] for name, arr in cache.items()}
        x, _ = block_apply(lp, cfg, kind, x, positions, mode, t, lcache)
    return x, cache

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions and the compute capability, which must be (9, 0);
2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the serving and long-prompt paths and beside them, with
   the largest absolute error, the tolerance, the kernel's, the plain
   version's and the library call's device times (CUDA graphs of many
   launches over inputs that exceed the L2 cache, timed by CUDA events),
   and the bound; the grouped matmul (moe_gmm) at mixtral's decode and
   prefill-chunk shapes, in the w_out direction at both and at a ragged
   shape; the Mamba2 SSD scan (mamba2_ssd) at zamba2's prefill shape, a
   ragged one and one started from a nonzero state, against the
   sequential oracle;
4. serve: qwen2-1.5b at full width and depth in bf16, eight requests
   through the continuous-batching engine, with the kernel launches
   counted over that run alone;
   serve_long: long prompts through the padded engine at full width and
   depth in bf16 — qwen2-1.5b (4 x 4096 tokens), h2o-danube-3-4b
   (1 x 8192 tokens, past its 4096-token window) and zamba2-1.2b (4 x 4096
   tokens: 38 Mamba2 layers, the shared attention block 6 times) — with
   prefill and decode wall seconds, peak memory and the launches of the
   kernels, then one more prefill of the same prompts with CUDA events
   around each flash and SSD launch: their device time inside a prefill;
   serve_moe: mixtral-8x22b at full width with 12 of its 56 layers (one
   card's 80 GB) in bf16, the same eight requests through the
   continuous-batching engine, with the launches of the three kernels on
   its path (rmsnorm, decode_attention, moe_gmm) counted over that run,
   then the same requests once more with CUDA events around each moe_gmm
   launch: the experts' device time inside a served run;
5. model check: qwen2-1.5b at full width with 4 layers in fp32 — the
   continuous engine's tokens equal the padded engine's, and one decode
   step's logits through the kernels match the same step through the plain
   versions on the CPU; then with 2 layers, a 2100-token prompt through
   the long prefill branch: last-position logits within 1e-3 of the CPU's
   plain path, and the same generated tokens; then mixtral-8x22b at full
   width with 1 layer in fp32: one paged prefill chunk and one paged
   decode step through the kernels on the card against the plain versions
   on the CPU (logits within 1e-3, the same tokens); then zamba2-1.2b at
   full width with 7 layers in fp32: a 2100-token prefill and 4 decode
   steps on the card against the CPU's plain path (logits within 1e-3,
   the same tokens);
6. the ``{"kernels": [...]}`` summary.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.  Without a CUDA device, or without the repository's
``src/repro_torch`` beside this file, it exits non-zero and prints no
result.  It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM rate and dense rates by
# input type (bf16 on the tensor cores, fp32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2 ** 20
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
# Flash attention's outputs shrink as a row sees more keys (std about
# sqrt(e / n) for unit inputs: 0.036 at n = 2048), so its limit scales
# with each element: |out - ref| <= atol + rtol |ref| + p_round ref_abs,
# where ref_abs is the plain version on |v|, i.e. sum p |v| / l.  In bf16
# the kernel rounds each probability to bf16 for P·V (relative error at
# most 2^-8), which moves an element by at most 2^-8 ref_abs; rtol covers
# the rounding of both outputs to bf16 (2^-8 |ref| each); atol is a floor
# well below a typical output.  The relative RMS error ||out - ref|| /
# ||ref|| is held too.  tools/flash_fault_check.py shows that planted
# faults of the tensor-core path fail this check.
FLASH_TOL = {"float32": dict(atol=1e-5, rtol=1e-5, p_round=0.0,
                             rel_rms=1e-5),
             "bfloat16": dict(atol=1e-3, rtol=2e-2, p_round=2.0 ** -8,
                              rel_rms=5e-3)}
# The grouped matmul is held to its plain version's fp32 value (the plain
# version before its cast to x's type): |out - ref| <= rtol |ref| +
# c ref_abs per element, ref_abs being the plain version on |x|, |w| (the
# sum of |products|), and ||out - ref|| / ||ref|| <= rel_rms.  In bf16 the
# kernel rounds its fp32 sum to bf16 once: at most half a bf16 step,
# 2^-8 |ref|, half of rtol = 2^-7.  The kernel and the plain version sum
# the same exact products in fp32 in another order: each addition errs by
# at most 2^-24 of a partial sum, itself at most ref_abs, and over K <=
# 16384 terms these errors grow as a random walk, about 2^-24 sqrt(K)
# ref_abs <= 2^-17 ref_abs; c = 2^-14 leaves a factor of 8 on that.  The
# output rounding gives a relative RMS error of about 2^-9.5; rel_rms =
# 2^-7.  In fp32 there is no output rounding: rtol covers a few steps of
# fp32 (2^-22), c = 2^-18 the summation order, rel_rms = 2^-16.
# tools/moe_gmm_fault_check.py shows that planted faults fail the bf16
# limit.
MOE_TOL = {"float32": dict(rtol=2.0 ** -22, c=2.0 ** -18, rel_rms=2.0 ** -16),
           "bfloat16": dict(rtol=2.0 ** -7, c=2.0 ** -14, rel_rms=2.0 ** -7)}
# The SSD scan is held to the sequential oracle (ssd_scan_ref, fp32, on
# the same inputs, from the same h0), y and the final state h alike: per
# element |out - ref| <= rtol |ref| + c ref_abs, ref_abs being the oracle
# on |x|, |B|, |C|, |D| and |h0| (the sum of the terms' magnitudes), and
# ||out - ref|| / ||ref|| <= rel_rms.  In bf16 the kernel rounds y to bf16
# once: at most 2^-8 |ref| (rtol 2^-7), a relative RMS of about 2^-9.3
# (rel_rms 2^-8).  Inside, it multiplies its fp32 operands (the masked
# weights, the state, the decay-weighted x) as two bf16 parts, about 2^-16
# of each term, and its chunked form takes exp of fp32 segment sums where
# the oracle multiplies per-step decays: a few 2^-24 per step, about 2^-16
# of a term at these lengths.  c = 2^-12 leaves a factor of 8 on both;
# h (fp32, no output rounding) takes rtol 2^-14 and rel_rms 2^-12.  In
# fp32 (CUDA cores) only the order of the sums and the exp of segment
# sums differ: rtol 2^-20, c 2^-18, rel_rms 2^-18 (the plain chunked
# version, chunk 64, uses a tenth of these against the oracle at the
# ragged and h0 shapes on the CPU).  tools/mamba2_ssd_fault_check.py
# shows that planted faults fail the limit.
SSD_TOL = {"float32": {"y": dict(rtol=2.0 ** -20, c=2.0 ** -18,
                                 rel_rms=2.0 ** -18),
                       "h": dict(rtol=2.0 ** -20, c=2.0 ** -18,
                                 rel_rms=2.0 ** -18)},
           "bfloat16": {"y": dict(rtol=2.0 ** -7, c=2.0 ** -12,
                                  rel_rms=2.0 ** -8),
                        "h": dict(rtol=2.0 ** -14, c=2.0 ** -12,
                                  rel_rms=2.0 ** -12)}}


def scaled_limit_use(torch, out, ref, ref_abs, tol):
    """``out`` against ``ref`` under a limit that scales with each element:
    |out - ref| <= rtol |ref| + c ref_abs (NaN counts as over the limit)
    and ||out - ref|| / ||ref|| <= rel_rms; the errors, the share of the
    limit used and the verdict."""
    limit = tol["rtol"] * ref.abs() + tol["c"] * ref_abs
    diff = (out - ref).abs()
    use = torch.nan_to_num(torch.where(diff == 0, 0.0, diff / limit),
                           nan=float("inf"))
    n_over = int((~(diff <= limit)).sum())
    rel_rms = (diff.norm() / ref.norm()).item()
    max_use = use.max().item()
    return {"max_abs_err": diff.max().item(),
            "max_abs_ref": ref.abs().max().item(),
            "rel_rms_err": rel_rms, "max_err_over_limit": max_use,
            "rel_rms_over_limit": rel_rms / tol["rel_rms"],
            "limit_use": max(max_use, rel_rms / tol["rel_rms"]),
            "elements_over_limit": n_over,
            "ok": n_over == 0 and rel_rms <= tol["rel_rms"]}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(torch, fn, arg_sets, reps=100, rounds=5):
    """Median device time of one ``fn(*args)`` call in ms.

    ``reps`` calls, cycling through ``arg_sets`` (whose total size exceeds
    the L2 cache, so inputs arrive cold), are captured in one CUDA graph
    and replayed; the host's launch cost stays out of the time.
    """
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*arg_sets[0])
        with torch.cuda.graph(graph, stream=stream):
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def copies_for(nbytes):
    """Input copies whose total exceeds twice the L2 cache."""
    return max(2, min(256, -(-2 * L2_BYTES // max(nbytes, 1))))


def bound_ms(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #

def check_rmsnorm(torch, F, R, D, dtype, gen):
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    dev = "cuda"
    x = torch.randn((R, D), generator=gen, device=dev).to(dtype)
    scale = torch.randn((D,), generator=gen, device=dev)
    out = rmsnorm_fused(x, scale, eps=1e-5)
    ref = rmsnorm_ref(x, scale, 1e-5)
    torch.cuda.synchronize()
    name = str(dtype).removeprefix("torch.")
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), **TOL[name])
    nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
    sets = [(x.clone(), scale.clone()) for _ in range(copies_for(nbytes))]
    ms = device_ms(torch, lambda a, s: rmsnorm_fused(a, s, eps=1e-5), sets)
    plain = device_ms(torch, lambda a, s: rmsnorm_ref(a, s, 1e-5), sets)
    lib = device_ms(torch, lambda a, s: F.rms_norm(a, (D,), s, 1e-5), sets)
    bnd, by = bound_ms(nbytes, 4 * R * D, name)
    return {"kernel": "rmsnorm", "R": R, "D": D, "dtype": name,
            "max_abs_err": err, "tol": TOL[name], "ok": bool(ok),
            "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bnd, "bound_by": by}


def attention_mask(torch, B, S, gen):
    """Per-sequence validity: partially filled rows, one full row and one
    fully masked row (an idle slot)."""
    lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
    lens[0] = S
    lens[-1] = 0
    return torch.arange(S, device="cuda")[None, :] < lens[:, None]


def attention_bytes_ops(mask, B, S, KH, G, D, elem):
    """Bytes and operations this mask's data needs: the K/V rows of valid
    keys (a fully masked row averages all of V and needs no K), q, the
    mask and the output."""
    valid = mask.sum(dim=1).tolist()
    rows = sum(2 * n if n else S for n in valid)
    nbytes = (rows * KH * D + 2 * B * KH * G * D) * elem + mask.numel()
    ops = sum(4 * KH * G * D * n for n in valid)
    return nbytes, ops


def check_decode_attention(torch, F, B, S, KH, G, D, dtype, gen):
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    dev = "cuda"
    H = KH * G
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, KH, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, KH, D), generator=gen, device=dev).to(dtype)
    mask = attention_mask(torch, B, S, gen)

    def plain(q, k, v, m):
        o = decode_attention_ref(q[:, 0].reshape(B, KH, G, D),
                                 k.transpose(1, 2), v.transpose(1, 2), m)
        return o.reshape(B, 1, H, D)

    def library(q, k, v, m):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m[:, None, None, :], enable_gqa=True)

    out = decode_attention(q, k, v, mask, n_kv_heads=KH)
    ref = plain(q, k, v, mask)
    torch.cuda.synchronize()
    name = str(dtype).removeprefix("torch.")
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), **TOL[name])
    elem = q.element_size()
    nbytes, ops = attention_bytes_ops(mask, B, S, KH, G, D, elem)
    full = (q.numel() + k.numel() + v.numel()) * elem
    sets = [(q.clone(), k.clone(), v.clone(), mask.clone())
            for _ in range(copies_for(full))]
    ms = device_ms(torch, lambda *a: decode_attention(*a, n_kv_heads=KH),
                   sets)
    plain_ms = device_ms(torch, plain, sets)
    lib = device_ms(torch, library, sets)
    bnd, by = bound_ms(nbytes, ops, name)
    return {"kernel": "decode_attention", "B": B, "S": S, "KH": KH, "G": G,
            "D": D, "dtype": name, "max_abs_err": err, "tol": TOL[name],
            "ok": bool(ok), "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib, "bound_ms": bnd, "bound_by": by}


def auto_reps(torch, fn, args, target_s=0.25, cap=100):
    """Launches per timed round so that one round takes about target_s."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return max(2, min(cap, int(target_s / max(time.perf_counter() - t0,
                                              1e-6))))


def causal_pairs(S, T, window):
    """(query, key) pairs of causal ∩ window at diagonal offset T - S."""
    qpos = np.arange(T - S, T, dtype=np.int64)
    n = qpos + 1
    if window is not None:
        n = np.minimum(n, window)
    return int(n.sum())


def check_flash(torch, F, label, B, H, KH, S, T, D, window, dtype, gen,
                timed=True):
    """The flash kernel against its plain version at one shape, with its,
    the plain version's and the library call's device times (only the
    agreement when ``timed`` is false)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev = "cuda"
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, T, KH, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, T, KH, D), generator=gen, device=dev).to(dtype)

    def kernel(q, k, v):
        return flash_attention(q, k, v, n_kv_heads=KH, window=window)

    def plain(q, k, v):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), n_kv_heads=KH,
                             window=window).transpose(1, 2)

    # The library call: SDPA's is_causal aligns top-left when S != T and
    # knows no window, so the offset and window shapes pass an explicit
    # S x T boolean mask of causal ∩ window.
    mask = None
    if S != T or window is not None:
        qpos = torch.arange(T - S, T, device=dev)[:, None]
        kpos = torch.arange(T, device=dev)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= qpos - kpos < window

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=mask is None,
            enable_gqa=True).transpose(1, 2)

    out = kernel(q, k, v).float()
    ref = plain(q, k, v).float()
    name = str(dtype).removeprefix("torch.")
    tol = FLASH_TOL[name]
    limit = tol["atol"] + tol["rtol"] * ref.abs()
    if tol["p_round"]:
        limit += tol["p_round"] * plain(q, k, v.abs()).float()
    diff = (out - ref).abs()
    torch.cuda.synchronize()
    err = diff.max().item()
    rel_rms = (diff.norm() / ref.norm()).item()
    n_over = int((diff > limit).sum())
    res = {"kernel": "flash_attention", "shape": label, "B": B, "H": H,
           "KH": KH, "S": S, "T": T, "D": D, "window": window,
           "dtype": name, "max_abs_err": err, "rel_rms_err": rel_rms,
           "max_err_over_limit": (diff / limit).max().item(),
           "elements_over_limit": n_over, "tol": tol,
           "ok": n_over == 0 and rel_rms <= tol["rel_rms"],
           "ok_at_3e-2": bool(torch.allclose(out, ref, atol=3e-2,
                                             rtol=3e-2))}
    del out, ref, diff, limit
    if not timed:
        return res
    elem = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem
    ops = 4 * D * causal_pairs(S, T, window) * H * B
    sets = [(q.clone(), k.clone(), v.clone())
            for _ in range(copies_for(nbytes))]
    for key, fn in {"ms": kernel, "plain_ms": plain,
                    "library_ms": library}.items():
        res[key] = device_ms(torch, fn, sets,
                             reps=auto_reps(torch, fn, sets[0]), rounds=3)
    bnd, by = bound_ms(nbytes, ops, name)
    res.update({"library_call": "sdpa(is_causal, enable_gqa)" if mask is None
                else "sdpa(bool mask of causal%s, enable_gqa)"
                % (" and window" if window else ""),
                "bound_ms": bnd, "bound_by": by, "ops": ops,
                "bytes": nbytes})
    return res


def moe_gmm_bytes_ops(nv, D, F, elem, C):
    """Bytes and operations this n_valid needs: w of the experts with a
    valid row, the valid rows of x, all of y, n_valid itself."""
    valid = nv.tolist()
    used = sum(1 for n in valid if n)
    rows = sum(valid)
    nbytes = (used * D * F + rows * D + len(valid) * C * F) * elem \
        + 4 * len(valid)
    return nbytes, 2 * rows * D * F


def check_moe_gmm(torch, label, E, C, D, F, dtype, gen, timed=True):
    """The grouped matmul against its plain version at one shape, n_valid
    random with 0 (expert 0) and C (the last expert) among it, with its,
    the plain version's and the library call's device times (only the
    agreement when ``timed`` is false)."""
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
    dev = "cuda"
    x = torch.randn((E, C, D), generator=gen, device=dev).to(dtype)
    w = (torch.randn((E, D, F), generator=gen, device=dev)
         * D ** -0.5).to(dtype)
    nv = torch.randint(0, C + 1, (E,), generator=gen, device=dev,
                       dtype=torch.int32)
    nv[0], nv[-1] = 0, C
    # The output's memory is filled with NaN first (the allocator hands the
    # freed block back), so an element the kernel leaves unwritten fails.
    poison = torch.full((E, C, F), float("nan"), dtype=dtype, device=dev)
    del poison
    out = moe_gmm(x, w, nv).float()
    ref = moe_gmm_ref(x.float(), w.float(), nv)
    plain = moe_gmm_ref(x, w, nv).float()
    name = str(dtype).removeprefix("torch.")
    tol = MOE_TOL[name]
    res = {"kernel": "moe_gmm", "shape": label, "E": E, "C": C, "D": D,
           "F": F, "dtype": name, "n_valid": nv.tolist(), "tol": tol,
           **scaled_limit_use(torch, out, ref, moe_gmm_ref(
               x.abs().float(), w.abs().float(), nv), tol),
           "max_abs_err_vs_plain_out": (out - plain).abs().max().item()}
    del out, ref, plain
    if not timed:
        return res
    elem = x.element_size()
    nbytes, ops = moe_gmm_bytes_ops(nv, D, F, elem, C)
    full = (x.numel() + w.numel()) * elem
    sets = [(x.clone(), w.clone(), nv.clone())
            for _ in range(copies_for(full))]
    for key, fn in {"ms": moe_gmm, "plain_ms": moe_gmm_ref,
                    "library_ms": lambda a, b, _: torch.bmm(a, b)}.items():
        res[key] = device_ms(torch, fn, sets,
                             reps=auto_reps(torch, fn, sets[0]), rounds=3)
    bnd, by = bound_ms(nbytes, ops, name)
    res.update({"library_call": "torch.bmm(x, w) (all rows: it takes no "
                                "n_valid)",
                "bound_ms": bnd, "bound_by": by, "ops": ops,
                "bytes": nbytes})
    del sets
    torch.cuda.empty_cache()
    return res


def ssd_bytes_ops(b, S, H, P, N, elem, with_h0):
    """Bytes: x, dt, B, C, A, D (and h0) read once, y and the final state
    written once.  Operations: 4 P N per position and head, what the scan
    needs in any form: the recurrence takes 3 P N for the state update and
    2 P N for C h, the chunked form at chunk l takes 2 l (N + P) + 4 P N,
    falling to 4 P N as l shrinks.  Independent of the kernel's chunk."""
    nbytes = (2 * b * S * H * P + 2 * b * S * N) * elem + b * S * H * 4 \
        + 2 * H * 4 + (2 if with_h0 else 1) * b * H * P * N * 4
    return nbytes, 4 * b * S * H * P * N


def ssd_inputs(torch, b, S, H, P, N, dtype, gen, with_h0):
    """zamba2-like inputs in the model layout: x, B and C are views of one
    (b, S, H P + 2 N) conv output, N(0, 1); dt = softplus(0.5 N(0, 1) +
    log(expm1(0.01))), about 0.01 as zamba2's initial step; A = -exp of
    linspace(log 1, log 16), as its A_log; D ~ N(0, 1); h0 ~ N(0, 1) or
    None."""
    dev = "cuda"
    xbc = torch.randn((b, S, H * P + 2 * N), generator=gen,
                      device=dev).to(dtype)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    B = xbc[..., H * P:H * P + N]
    C = xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn((b, S, H), generator=gen, device=dev)
        + float(np.log(np.expm1(0.01))))
    A = -torch.exp(torch.linspace(0.0, float(np.log(16.0)), H, device=dev))
    D = torch.randn((H,), generator=gen, device=dev)
    h0 = (torch.randn((b, H, P, N), generator=gen, device=dev)
          if with_h0 else None)
    return x, dt, B, C, A, D, h0


def check_mamba2_ssd(torch, label, b, S, H, P, N, with_h0, dtype, gen,
                     timed=True):
    """The SSD scan against the sequential oracle at one shape (y and the
    final state, SSD_TOL), with its and the plain version's device times
    (only the agreement when ``timed`` is false).  No single PyTorch call
    computes the scan, so there is no library time."""
    from repro_torch.kernels.mamba2_ssd.ops import CHUNK, mamba2_ssd
    from repro_torch.kernels.mamba2_ssd.ref import (mamba2_ssd_ref,
                                                    ssd_scan_ref)
    x, dt, B, C, A, D, h0 = ssd_inputs(torch, b, S, H, P, N, dtype, gen,
                                       with_h0)
    # The outputs' memory is filled with NaN first (the allocator hands
    # the freed blocks back), so an element the kernel leaves unwritten
    # fails.
    poison = [torch.full((b, S, H, P), float("nan"), dtype=dtype,
                         device="cuda"),
              torch.full((b, H, P, N), float("nan"), device="cuda")]
    del poison
    y, h = mamba2_ssd(x, dt, B, C, A, D, h0=h0)
    xt = x.float().transpose(1, 2)
    dtt = dt.transpose(1, 2)
    y_ref, h_ref = ssd_scan_ref(xt, dtt, B.float(), C.float(), A, D, h0)
    y_abs, h_abs = ssd_scan_ref(xt.abs(), dtt, B.float().abs(),
                                C.float().abs(), A, D.abs(),
                                None if h0 is None else h0.abs())
    name = str(dtype).removeprefix("torch.")
    res = {"kernel": "mamba2_ssd", "shape": label, "b": b, "S": S, "H": H,
           "P": P, "N": N, "h0": with_h0, "dtype": name,
           "chunk": CHUNK[dtype], "tol": SSD_TOL[name]}
    for key, out, ref, ref_abs in (
            ("y", y.float().transpose(1, 2), y_ref, y_abs),
            ("h", h, h_ref, h_abs)):
        got = scaled_limit_use(torch, out, ref, ref_abs, SSD_TOL[name][key])
        res.update({f"{key}_{k}": v for k, v in got.items()})
    res.update({"max_abs_err": res["y_max_abs_err"],
                "limit_use": max(res["y_limit_use"], res["h_limit_use"]),
                "ok": res["y_ok"] and res["h_ok"]})
    del y, h, y_ref, h_ref, y_abs, h_abs, xt
    if not timed:
        return res
    elem = x.element_size()
    nbytes, ops = ssd_bytes_ops(b, S, H, P, N, elem, with_h0)
    full = (x.numel() + B.numel() + C.numel()) * elem + dt.numel() * 4
    sets = []
    for _ in range(copies_for(full)):
        xc, dtc, Bc, Cc, _, _, _ = ssd_inputs(torch, b, S, H, P, N, dtype,
                                              gen, False)
        sets.append((xc, dtc, Bc, Cc, A, D, h0))
    for key, fn in {"ms": lambda *a: mamba2_ssd(*a[:6], h0=a[6]),
                    "plain_ms": mamba2_ssd_ref}.items():
        res[key] = device_ms(torch, fn, sets,
                             reps=auto_reps(torch, fn, sets[0]), rounds=3)
    bnd, by = bound_ms(nbytes, ops, name)
    res.update({"library_ms": None,
                "library_call": "none: no single PyTorch call computes the "
                                "SSD scan",
                "bound_ms": bnd, "bound_by": by, "ops": ops,
                "bytes": nbytes})
    del sets
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------- #
# phases 4 and 5: the serving path
# --------------------------------------------------------------------- #

SERVE = dict(max_prompt=128, max_new_tokens=32, block_size=16, n_blocks=129,
             max_slots=8, prefill_chunk=16, prefill_batch=4)


def serve_workload(eng, n_req, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(32, 129, n_req)
    budgets = rng.integers(8, 33, n_req)
    prompts = [rng.integers(0, eng.cfg.vocab_size, (int(n),),
                            dtype="int32") for n in lens]
    eng.reset()
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        eng.submit(p, int(m), arrival=i // 2)
    return prompts, budgets, eng.run()


def phase_serve(torch, arch="qwen2-1.5b", n_layers=None):
    """``arch`` (``n_layers`` of its layers, all by default) at full width
    in bf16, random weights from seed 0, serving eight requests through
    the continuous-batching engine, with each kernel's launches counted
    over that run alone.  For the MoE family the same requests run once
    more with CUDA events around each moe_gmm launch: the experts' device
    time inside a served run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
    from repro_torch.models import lm as lm_lib
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers or full.n_layers)
    moe = cfg.family == "moe"
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = lm_lib.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ContinuousEngine(cfg, params, ServeConfig(**SERVE), "cuda")
    serve_workload(eng, 8)                    # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_fused.launches = 0
    decode_attention.launches = 0
    moe_gmm.launches = 0
    t0 = time.perf_counter()
    prompts, budgets, res = serve_workload(eng, 8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm_fused.launches,
                "decode_attention": decode_attention.launches,
                "moe_gmm": moe_gmm.launches}
    peak = torch.cuda.max_memory_allocated()
    st = dict(eng.stats)
    L = cfg.n_layers
    dispatches = st["prefill_dispatches"] + st["decode_steps"]
    want = {"rmsnorm": (2 * L + 1) * dispatches,
            "decode_attention": L * st["decode_steps"],
            "moe_gmm": 3 * L * dispatches if moe else 0}
    tokens = sum(len(v) for v in res.values())
    lat = sorted(eng.latency.values())
    out = {"phase": "serve_moe" if moe else "serve", "model": cfg.name,
           "n_layers": L, "n_layers_full": full.n_layers,
           "n_params": cfg.n_params(), "n_params_full": full.n_params(),
           "dtype": cfg.dtype, "serve_config": SERVE, "requests": len(res),
           "prompt_lens": [len(p) for p in prompts],
           "budgets": [int(b) for b in budgets], "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "dispatches": dispatches, "s_per_dispatch": wall / dispatches,
           "latency_p50_s": lat[len(lat) // 2], "latency_max_s": lat[-1],
           "stats": st, "peak_memory_bytes": peak, "init_params_s": init_s,
           "launches": launches, "launches_expected": want}
    traced = []
    if moe:
        out["reduced"] = (f"depth {L} of {full.n_layers} layers (one card's "
                          f"80 GB); widths as published")
        moe_gmm.events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve_workload(eng, 8)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        traced = [a.elapsed_time(b) for a, b in moe_gmm.events]
        moe_gmm.events = None
        out.update({"traced_wall_s": traced_s,
                    "traced_moe_gmm_launches": len(traced),
                    "traced_moe_gmm_s": sum(traced) / 1e3,
                    "traced_moe_gmm_ms_per_launch": statistics.median(traced),
                    "traced_moe_gmm_share": sum(traced) / 1e3 / traced_s})
    emit(out)
    if launches != want or len(traced) != (want["moe_gmm"] if moe else 0):
        raise RuntimeError(f"kernel launches {launches} != expected {want}"
                           f" (traced run: {len(traced)} moe_gmm)")
    for rid, toks in res.items():
        if len(toks) != int(budgets[rid]) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise RuntimeError(f"request {rid} emitted {toks}")
    if len(res) != 8:
        raise RuntimeError(f"served {len(res)} of 8 requests")
    del eng, params
    torch.cuda.empty_cache()
    return launches


# (arch, prompts, prompt length, new tokens): the padded engine's long
# prompts at full width and depth.  Danube's prompt is twice its window, so
# its prefill fills the ring cache.  zamba2 (hybrid) serves long documents
# through this engine only (its SSM state does not page).
SERVE_LONG = [("qwen2-1.5b", 4, 4096, 16), ("h2o-danube-3-4b", 1, 8192, 8),
              ("zamba2-1.2b", 4, 4096, 16)]


def padded_launches(cfg):
    """Kernel launches of one padded-engine dispatch: rmsnorm per prefill
    or decode step; flash attention and the SSD scan per long prefill."""
    from repro_torch.models import lm as lm_lib
    L = cfg.n_layers
    if cfg.family == "hybrid":
        apps = sum(1 for seg in lm_lib._hybrid_segments(cfg) if seg[2])
        return {"rmsnorm": L + 2 * apps + 1, "flash_attention": apps,
                "mamba2_ssd": L}
    return {"rmsnorm": 2 * L + 1, "flash_attention": L, "mamba2_ssd": 0}


def phase_serve_long(torch, arch, n_prompts, prompt_len, new_tokens):
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
    from repro_torch.models import lm as lm_lib
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config(arch)
    params = lm_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (n_prompts, prompt_len),
                           dtype=np.int32)
    # the launcher's cache sizing (launch/serve.py)
    sc = ServeConfig(max_prompt=prompt_len + 8, max_new_tokens=new_tokens)
    eng = Engine(cfg, params, sc, "cuda")
    eng.generate(prompts)                     # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_fused.launches = 0
    decode_attention.launches = 0
    flash_attention.launches = 0
    mamba2_ssd.launches = 0
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm_fused.launches,
                "decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches,
                "mamba2_ssd": mamba2_ssd.launches}
    peak = torch.cuda.max_memory_allocated()
    prefill_s, decode_s = eng.timing["prefill_s"], eng.timing["decode_s"]
    L = cfg.n_layers
    per = padded_launches(cfg)
    want = {"rmsnorm": per["rmsnorm"] * new_tokens, "decode_attention": 0,
            "flash_attention": per["flash_attention"],
            "mamba2_ssd": per["mamba2_ssd"]}

    # One more prefill of the same prompts, with CUDA events around each
    # flash and SSD launch: its logits are checked, and the events give
    # the kernels' device time inside a prefill.
    flash_attention.events = []
    mamba2_ssd.events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = lm_lib.prefill(
        params, cfg, {"tokens": torch.as_tensor(prompts.astype(np.int64),
                                                device="cuda")},
        sc.max_prompt + sc.max_new_tokens)
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    flash_ms = [a.elapsed_time(b) for a, b in flash_attention.events]
    ssd_ms = [a.elapsed_time(b) for a, b in mamba2_ssd.events]
    flash_attention.events = None
    mamba2_ssd.events = None
    finite = bool(torch.isfinite(logits).all())
    tokens_ok = (out.shape == (n_prompts, new_tokens)
                 and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    res = {"phase": "serve_long", "model": cfg.name, "n_layers": L,
           "n_params": cfg.n_params(), "dtype": cfg.dtype,
           "window": cfg.window, "engine": "padded", "prompts": n_prompts,
           "prompt_len": prompt_len, "new_tokens": new_tokens,
           "generated_tokens": int(out.size), "prefill_s": prefill_s,
           "decode_s": decode_s, "wall_s": wall,
           "prompt_tokens_per_s": n_prompts * prompt_len / prefill_s,
           "decode_tokens_per_s": n_prompts * (new_tokens - 1) / decode_s,
           "peak_memory_bytes": peak,
           "launches": launches, "launches_expected": want,
           "traced_prefill_s": traced_s,
           "traced_flash_launches": len(flash_ms),
           "traced_flash_s": sum(flash_ms) / 1e3,
           "traced_flash_ms_per_launch": statistics.median(flash_ms),
           "traced_flash_share": sum(flash_ms) / 1e3 / traced_s,
           "traced_ssd_launches": len(ssd_ms),
           "traced_ssd_s": sum(ssd_ms) / 1e3,
           "traced_ssd_ms_per_launch": (statistics.median(ssd_ms)
                                        if ssd_ms else None),
           "traced_ssd_share": sum(ssd_ms) / 1e3 / traced_s,
           "logits_finite": finite, "tokens_ok": tokens_ok,
           "first_tokens": out[:, :4].tolist()}
    emit(res)
    if (launches != want or len(flash_ms) != want["flash_attention"]
            or len(ssd_ms) != want["mamba2_ssd"]):
        raise RuntimeError(f"kernel launches {launches} != expected {want}"
                           f" (traced prefill: {len(flash_ms)} flash, "
                           f"{len(ssd_ms)} mamba2_ssd)")
    if not (finite and tokens_ok):
        raise RuntimeError(f"serve_long {arch}: logits finite {finite}, "
                           f"tokens {out.tolist()}")
    del eng, params, logits
    torch.cuda.empty_cache()
    return res


# mixtral-8x22b at full width: 12 of its 56 layers fit one card's 80 GB
# in bf16 (30.45 B parameters, 60.9 GB; about 5.01 GB a layer).
MOE_ARCH, MOE_LAYERS = "mixtral-8x22b", 12


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.cpu()


def phase_model_check(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import cache as cache_lib
    from repro_torch.models import lm as lm_lib
    from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=4,
                              dtype="float32")
    params = lm_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")

    # (a) continuous engine == padded engine, 4 requests
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
    sc = ServeConfig(max_prompt=32, max_new_tokens=8, block_size=16,
                     n_blocks=17, max_slots=4, prefill_chunk=16,
                     prefill_batch=4)
    padded = Engine(cfg, params, sc, "cuda").generate(prompts)
    cont = ContinuousEngine(cfg, params, sc, "cuda").generate(prompts)
    same = bool((padded == cont).all())

    # (b) one paged decode step: kernels on the card vs plain on the CPU
    B, bs, pages = 8, 16, 10
    s_max = pages * bs
    pool = lm_lib.init_paged_cache(cfg, B * pages + 1, bs, device="cuda")
    pool_gen = torch.Generator(device="cuda").manual_seed(3)
    for arr in pool["main"].values():
        arr.copy_(torch.randn(arr.shape, generator=pool_gen, device="cuda"))
    tables = 1 + np.arange(B * pages).reshape(B, pages)
    gather = torch.as_tensor((tables[:, :, None] * bs + np.arange(bs))
                             .reshape(B, s_max), device="cuda")
    pos = torch.as_tensor(rng.integers(0, s_max, B), device="cuda")
    pos[-1] = -1                                      # an idle slot
    write = torch.where(pos >= 0, gather.gather(
        1, pos.clamp(min=0)[:, None])[:, 0], torch.arange(B, device="cuda"))
    step = {"pos": pos, "write": write, "gather": gather,
            "mask": cache_lib.paged_valid_mask(pos, s_max, cfg.window)}
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                             device="cuda")

    cpu_args = to_cpu((params, {"tokens": tokens}, pool, step))
    logits_k, _ = lm_lib.decode_step_paged(params, cfg, {"tokens": tokens},
                                           pool, step)
    logits_p, _ = lm_lib.decode_step_paged(cpu_args[0], cfg, cpu_args[1],
                                           cpu_args[2], cpu_args[3])
    lk = logits_k.cpu()
    err = (lk - logits_p).abs().max().item()
    finite = bool(torch.isfinite(lk).all())
    shape_ok = tuple(lk.shape) == (B, 1, cfg.padded_vocab)
    out = {"phase": "model_check", "model": cfg.name, "n_layers": 4,
           "dtype": "float32", "allow_tf32": False,
           "continuous_equals_padded": same, "padded_tokens":
           padded.tolist(), "decode_logits_max_abs_err": err,
           "atol": 1e-3, "finite": finite, "shape": list(lk.shape)}
    emit(out)
    if not (same and finite and shape_ok and err <= 1e-3):
        raise RuntimeError("whole-model check failed")


def phase_model_check_long(torch):
    """qwen2-1.5b at full width, 2 layers, fp32: a 2100-token prompt takes
    the long prefill branch (flash attention, with ragged tiles) on the
    card and its plain version on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import lm as lm_lib
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2,
                              dtype="float32")
    params = lm_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(4), "cuda")
    cpu_params = to_cpu(params)
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 2100), dtype=np.int32)
    tokens = torch.as_tensor(prompt.astype(np.int64))
    flash_attention.launches = 0
    logits_k, _ = lm_lib.prefill(params, cfg, {"tokens": tokens.cuda()},
                                 2104)
    launches = flash_attention.launches
    logits_p, _ = lm_lib.prefill(cpu_params, cfg, {"tokens": tokens}, 2104)
    lk = logits_k.cpu()
    err = (lk - logits_p).abs().max().item()
    finite = bool(torch.isfinite(lk).all())
    sc = ServeConfig(max_prompt=2100, max_new_tokens=4)
    tok_k = Engine(cfg, params, sc, "cuda").generate(prompt)
    tok_p = Engine(cfg, cpu_params, sc, "cpu").generate(prompt)
    same = bool((tok_k == tok_p).all())
    out = {"phase": "model_check_long", "model": cfg.name, "n_layers": 2,
           "dtype": "float32", "allow_tf32": False, "prompt_len": 2100,
           "prefill_logits_max_abs_err": err, "atol": 1e-3,
           "finite": finite, "shape": list(lk.shape),
           "flash_launches": launches, "tokens_card": tok_k.tolist(),
           "tokens_cpu": tok_p.tolist(), "tokens_equal": same}
    emit(out)
    if not (same and finite and err <= 1e-3 and launches == cfg.n_layers
            and tuple(lk.shape) == (1, 1, cfg.padded_vocab)):
        raise RuntimeError("long-prompt whole-model check failed")


def phase_model_check_moe(torch):
    """mixtral-8x22b at full width, 1 layer, fp32: one paged prefill chunk
    (4 rows of 16 tokens, one of them partly padding) and one paged decode
    step through the kernels on the card and through the plain versions on
    the CPU: logits within 1e-3 at every real position, the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.models import cache as cache_lib
    from repro_torch.models import lm as lm_lib

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=1,
                              dtype="float32")
    params = lm_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(6), "cuda")
    cpu_params = to_cpu(params)
    B, C, bs, pages = 4, 16, 16, 4
    s_max = pages * bs
    rng = np.random.default_rng(7)
    tables = 1 + np.arange(B * pages).reshape(B, pages)
    gather = torch.as_tensor((tables[:, :, None] * bs + np.arange(bs))
                             .reshape(B, s_max), device="cuda")
    real = torch.tensor([C, C, C, 10], device="cuda")
    j = torch.arange(C, device="cuda")[None, :]
    is_real = j < real[:, None]
    pos = torch.where(is_real, j, -1)
    chunk = {"pos": pos, "write": torch.where(is_real, gather[:, :C], j % bs),
             "gather": gather,
             "mask": cache_lib.paged_valid_mask(pos, s_max, cfg.window)}
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, C)),
                             device="cuda")
    pool = lm_lib.init_paged_cache(cfg, B * pages + 1, bs, device="cuda")
    cpu_pool = to_cpu(pool)

    def both(fn, tok, step):
        moe_gmm.launches = 0
        lk, _ = fn(params, cfg, {"tokens": tok}, pool, step)
        launches = moe_gmm.launches
        lp, _ = fn(cpu_params, cfg, {"tokens": tok.cpu()}, cpu_pool,
                   to_cpu(step))
        return lk.cpu(), lp, launches

    lk, lp, n_prefill = both(lm_lib.prefill_chunk_paged, tokens, chunk)
    sel = is_real.cpu()
    err_prefill = (lk - lp).abs()[sel].max().item()
    last = real.cpu() - 1
    tok_k = lk[torch.arange(B), last, :cfg.vocab_size].argmax(-1)
    tok_p = lp[torch.arange(B), last, :cfg.vocab_size].argmax(-1)
    finite = bool(torch.isfinite(lk).all())

    dpos = real.clone()
    decode = {"pos": dpos, "write": gather.gather(1, dpos[:, None])[:, 0],
              "gather": gather,
              "mask": cache_lib.paged_valid_mask(dpos, s_max, cfg.window)}
    lk2, lp2, n_decode = both(lm_lib.decode_step_paged,
                              tok_k[:, None].cuda(), decode)
    err_decode = (lk2 - lp2).abs().max().item()
    dtok_k = lk2[:, 0, :cfg.vocab_size].argmax(-1)
    dtok_p = lp2[:, 0, :cfg.vocab_size].argmax(-1)
    finite = finite and bool(torch.isfinite(lk2).all())
    same = bool((tok_k == tok_p).all() and (dtok_k == dtok_p).all())
    out = {"phase": "model_check_moe", "model": cfg.name, "n_layers": 1,
           "n_params": cfg.n_params(), "dtype": "float32",
           "allow_tf32": False, "prefill_rows": B, "prefill_chunk": C,
           "prefill_logits_max_abs_err": err_prefill,
           "decode_logits_max_abs_err": err_decode, "atol": 1e-3,
           "finite": finite, "moe_gmm_launches": [n_prefill, n_decode],
           "tokens_card": [tok_k.tolist(), dtok_k.tolist()],
           "tokens_cpu": [tok_p.tolist(), dtok_p.tolist()],
           "tokens_equal": same}
    emit(out)
    if not (same and finite and max(err_prefill, err_decode) <= 1e-3
            and n_prefill == n_decode == 3 * cfg.n_layers
            and tuple(lk2.shape) == (B, 1, cfg.padded_vocab)):
        raise RuntimeError("MoE whole-model check failed")
    del params, cpu_params, pool, cpu_pool
    torch.cuda.empty_cache()


def phase_model_check_hybrid(torch):
    """zamba2-1.2b at full width, 7 layers (a full run of 6 with the
    shared block after it, then a trailing layer), fp32: a 2100-token
    prefill (the shared block's long branch) and 4 decode steps through
    the kernels on the card and through the plain versions on the CPU:
    logits within 1e-3 at every step, the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd
    from repro_torch.models import lm as lm_lib

    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=7,
                              dtype="float32")
    params = lm_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(8), "cuda")
    cpu_params = to_cpu(params)
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 2100), dtype=np.int64)
    tokens = torch.as_tensor(prompt)
    max_len = 2100 + 4
    mamba2_ssd.launches = 0
    flash_attention.launches = 0
    lk, ck = lm_lib.prefill(params, cfg, {"tokens": tokens.cuda()}, max_len)
    launches = {"mamba2_ssd": mamba2_ssd.launches,
                "flash_attention": flash_attention.launches}
    lp, cp = lm_lib.prefill(cpu_params, cfg, {"tokens": tokens}, max_len)
    errs, toks_k, toks_p = [], [], []
    finite = True
    for i in range(5):
        lkc = lk.cpu()
        errs.append((lkc - lp).abs().max().item())
        finite &= bool(torch.isfinite(lkc).all())
        tk = lkc[..., :cfg.vocab_size].argmax(-1)
        tp = lp[..., :cfg.vocab_size].argmax(-1)
        toks_k.append(int(tk[0, 0]))
        toks_p.append(int(tp[0, 0]))
        if i == 4:
            break
        lk, ck = lm_lib.decode_step(params, cfg, {"tokens": tk.cuda()}, ck,
                                    2100 + i)
        lp, cp = lm_lib.decode_step(cpu_params, cfg, {"tokens": tp}, cp,
                                    2100 + i)
    state_err = (ck["mamba"]["ssd"].cpu() - cp["mamba"]["ssd"]).abs().max() \
        .item()
    same = toks_k == toks_p
    out = {"phase": "model_check_hybrid", "model": cfg.name, "n_layers": 7,
           "n_params": cfg.n_params(), "dtype": "float32",
           "allow_tf32": False, "prompt_len": 2100, "decode_steps": 4,
           "logits_max_abs_err": errs, "ssd_state_max_abs_err": state_err,
           "atol": 1e-3, "finite": finite, "prefill_launches": launches,
           "tokens_card": toks_k, "tokens_cpu": toks_p,
           "tokens_equal": same}
    emit(out)
    if not (same and finite and max(errs) <= 1e-3
            and launches == {"mamba2_ssd": 7, "flash_attention": 1}):
        raise RuntimeError("hybrid whole-model check failed")
    del params, cpu_params, ck, cp
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #

RMSNORM_CASES = [(R, D) for D in (1536, 3840, 48) for R in (8, 64, 4096)]
ATTN_CASES = [  # (label, B, S, KH, G, D)
    ("serving", 8, 160, 2, 6, 128),
    ("long", 8, 4096, 2, 6, 128),
    ("danube", 8, 160, 8, 4, 120),
    ("tiny", 8, 160, 1, 3, 16),
]
FLASH_CASES = [  # (label, B, H, KH, S, T, D, window)
    ("qwen2", 4, 12, 2, 4096, 4096, 128, None),
    ("danube", 2, 32, 8, 8192, 8192, 120, 4096),
    ("offset", 2, 12, 2, 100, 2100, 128, None),
    ("tiny", 1, 3, 1, 2048, 2048, 16, None),
    ("zamba2", 4, 32, 32, 4096, 4096, 64, None),
]
MOE_CASES = [  # (label, E, C, D, F): mixtral's experts and a ragged shape
    ("decode", 8, 8, 6144, 16384),
    ("prefill", 8, 24, 6144, 16384),
    ("w_out", 8, 24, 16384, 6144),
    ("w_out_decode", 8, 8, 16384, 6144),
    ("ragged", 5, 37, 200, 300),
]
SSD_CASES = [  # (label, b, S, H, P, N, h0)
    ("zamba2_prefill", 4, 4096, 64, 64, 64, True),   # the served call
    ("ragged", 2, 1000, 8, 64, 64, False),           # a tail of S
    ("h0", 1, 300, 4, 16, 16, True),                 # a nonzero h0
]
MAIN_PATH = {"rmsnorm": (8, 1536, "bfloat16"),
             "decode_attention": ("serving", "bfloat16"),
             "flash_attention": ("qwen2", "bfloat16"),
             "moe_gmm": ("decode", "bfloat16"),
             "mamba2_ssd": ("zamba2_prefill", "bfloat16")}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "count":
          torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "capability": list(cap)})
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, the kernels are "
                           f"built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in p.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
             for n, p in libs.items()}
    emit({"phase": "build", "seconds": build_s,
          "libraries": {n: p.name for n, p in libs.items()},
          "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for R, D in RMSNORM_CASES:
            r = check_rmsnorm(torch, F, R, D, dtype, gen)
            emit({"phase": "kernels", **r})
            results.append(r)
        for label, B, S, KH, G, D in ATTN_CASES:
            r = check_decode_attention(torch, F, B, S, KH, G, D, dtype, gen)
            r["shape"] = label
            emit({"phase": "kernels", **r})
            results.append(r)
        for label, B, H, KH, S, T, D, window in FLASH_CASES:
            r = check_flash(torch, F, label, B, H, KH, S, T, D, window,
                            dtype, gen)
            emit({"phase": "kernels", **r})
            results.append(r)
        for case in MOE_CASES:
            r = check_moe_gmm(torch, *case, dtype, gen)
            emit({"phase": "kernels", **r})
            results.append(r)
        for case in SSD_CASES:
            r = check_mamba2_ssd(torch, *case, dtype, gen)
            emit({"phase": "kernels", **r})
            results.append(r)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise RuntimeError(f"{len(bad)} kernel checks disagree with the "
                           f"plain versions: {bad}")

    launches = phase_serve(torch)
    long_runs = [phase_serve_long(torch, *case) for case in SERVE_LONG]
    # flash attention's launches on the main path: the qwen2 long-prompt run
    launches["flash_attention"] = long_runs[0]["launches"]["flash_attention"]
    # the SSD scan's: the zamba2 long-prompt run
    launches["mamba2_ssd"] = long_runs[2]["launches"]["mamba2_ssd"]
    launches["moe_gmm"] = phase_serve(torch, MOE_ARCH, MOE_LAYERS)["moe_gmm"]
    phase_model_check(torch)
    phase_model_check_long(torch)
    phase_model_check_moe(torch)
    phase_model_check_hybrid(torch)

    def pick(name):
        if name == "rmsnorm":
            R, D, dt = MAIN_PATH[name]
            return next(r for r in results if r["kernel"] == name
                        and r["R"] == R and r["D"] == D and r["dtype"] == dt)
        label, dt = MAIN_PATH[name]
        return next(r for r in results if r["kernel"] == name
                    and r["shape"] == label and r["dtype"] == dt)

    meta = {
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:25"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:69"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:87"),
        "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                    "src/repro/kernels/moe_gmm/kernel.py:37"),
        "mamba2_ssd": ("src/repro_torch/kernels/csrc/mamba2_ssd.cu",
                       "src/repro/kernels/mamba2_ssd/kernel.py:76"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = pick(name)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

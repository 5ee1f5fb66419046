"""Serving launcher: continuous batching over the paged KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-3-4b \
        --requests 8 --new-tokens 32 [--prompt-len 16] [--engine padded] \
        [--device cuda]

Drives :class:`repro_torch.serve.engine.ContinuousEngine` at the arch's
``tiny()`` size on a mixed workload (per-request budgets, staggered
arrivals) and reports aggregate tokens/s plus p50/p99 request latency;
``--engine padded`` runs the fixed-batch baseline on the same prompts.
The hybrid family (``--arch zamba2-1.2b``) serves through the padded
engine only: its SSM state does not page, and the continuous engine
refuses it.  Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import time


def main():
    """CLI entry point."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--engine", choices=("continuous", "padded"),
                    default="continuous")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.configs import get_tiny
    from repro_torch.device import resolve_device
    from repro_torch.models import lm as lm_lib
    from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig

    dev = resolve_device(args.device)
    cfg = get_tiny(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm_lib.init_params(cfg, gen, dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len), dtype=np.int32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if args.engine == "padded":
        eng = Engine(cfg, params,
                     ServeConfig(max_prompt=args.prompt_len + 8,
                                 max_new_tokens=args.new_tokens), dev)
        eng.generate(prompts)                  # warm-up
        sync()
        t0 = time.perf_counter()
        out = eng.generate(prompts)
        dt = time.perf_counter() - t0
        print(f"[serve/padded] {cfg.name} on {dev}: {out.shape[0]}×"
              f"{out.shape[1]} tokens in {dt:.2f}s -> {out.size/dt:.0f} "
              f"tok/s")
        print(out[: min(2, len(out))])
        return

    slots = min(8, args.requests)
    bs = 8
    max_seq = args.prompt_len + args.new_tokens
    pages = -(-max_seq // bs)
    sc = ServeConfig(max_prompt=args.prompt_len, eos_id=-1,
                     max_new_tokens=args.new_tokens, block_size=bs,
                     n_blocks=slots * pages + 1, max_slots=slots,
                     prefill_chunk=min(16, args.prompt_len),
                     prefill_batch=min(4, slots))
    try:
        eng = ContinuousEngine(cfg, params, sc, dev)
    except NotImplementedError as e:
        raise SystemExit(f"[serve/continuous] {cfg.name}: {e}; use "
                         f"--engine padded") from e

    def workload():
        eng.reset()
        # mixed budgets + two arrivals per step: the traffic shape
        # continuous batching exists for
        wrng = np.random.default_rng(1)
        for i, p in enumerate(prompts):
            mnt = int(wrng.integers(max(1, args.new_tokens // 4),
                                    args.new_tokens + 1))
            eng.submit(p, mnt, arrival=i // 2)
        return eng.run()

    workload()                                 # warm-up
    sync()
    t0 = time.perf_counter()
    res = workload()
    dt = time.perf_counter() - t0
    done = sum(len(v) for v in res.values())
    lat = np.sort(np.array(list(eng.latency.values()))) * 1e3
    print(f"[serve/continuous] {cfg.name} on {dev}: {len(res)} requests, "
          f"{done} tokens in {dt:.2f}s -> {done/dt:.0f} tok/s "
          f"(p50 {np.percentile(lat, 50):.0f}ms, "
          f"p99 {np.percentile(lat, 99):.0f}ms; steps={eng.stats['steps']}, "
          f"peak_active={eng.stats['peak_active']})")
    for rid in sorted(res)[:2]:
        print(f"  rid {rid}: {[int(t) for t in res[rid][:12]]}"
              f"{' ...' if len(res[rid]) > 12 else ''}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Fault check of the grouped-matmul tolerance in ``chip_smoke.py``.

    python3 tools/moe_gmm_fault_check.py

Needs one H100.  It builds ``src/repro_torch/kernels/csrc/moe_gmm.cu``
once per variant under ``-DMOE_GMM_FAULT=<n>`` into
``build/fault_check/`` (git-ignored; one ``nvcc`` per variant, all started
together), loads each library in turn behind the port's ``moe_gmm``
wrapper and runs ``chip_smoke.check_moe_gmm`` in bf16 at the decode and
prefill-chunk shapes of phase 3.

Variants, and the verdict each must get at both shapes:

- ``sound`` (0): the kernel as it is; passes;
- ``skip_last_k`` (1): the last K tile of 64 is never multiplied; fails;
- ``ignore_n_valid`` (2): rows at or past n_valid are computed, not
  zeroed; fails;
- ``last_expert_reads_expert_0`` (3): the last expert multiplies by expert
  0's weights; fails;
- ``f_tail_unwritten`` (4): the last F tile of 128 columns is never
  written; fails.

Prints one JSON line per (variant, shape), then ``{"ok": ...}``; exits
non-zero unless every verdict is as above.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WORK = REPO / "build" / "fault_check"
VARIANTS = {"sound": 0, "skip_last_k": 1, "ignore_n_valid": 2,
            "last_expert_reads_expert_0": 3, "f_tail_unwritten": 4}
SHAPES = ["decode", "prefill"]


def main() -> int:
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import ops

    if not torch.cuda.is_available():
        print("moe_gmm_fault_check: no CUDA device", file=sys.stderr)
        return 2
    WORK.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "moe_gmm.cu"
    libs, procs = {}, {}
    for variant, n in VARIANTS.items():
        libs[variant] = WORK / f"moe_gmm_{variant}.so"
        procs[variant] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DMOE_GMM_FAULT={n}",
             "-o", str(libs[variant]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{variant}: nvcc exit {proc.returncode}\n{log}",
                  file=sys.stderr)
            return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    for variant in VARIANTS:
        lib = ctypes.CDLL(str(libs[variant]))
        _build.library = lambda name, lib=lib: lib
        ops._kernel.cache_clear()
        gen = torch.Generator(device="cuda").manual_seed(0)
        for case in chip_smoke.MOE_CASES:
            if case[0] not in SHAPES:
                continue
            r = chip_smoke.check_moe_gmm(torch, *case, torch.bfloat16, gen,
                                         timed=False)
            r.pop("n_valid")
            r.update(variant=variant, expected_ok=variant == "sound")
            print(json.dumps(r), flush=True)
            ok &= r["ok"] == r["expected_ok"]
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

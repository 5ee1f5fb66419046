#!/usr/bin/env python3
"""Fault check of the SSD-scan tolerance in ``chip_smoke.py``.

    python3 tools/mamba2_ssd_fault_check.py

Needs one H100.  It builds ``src/repro_torch/kernels/csrc/mamba2_ssd.cu``
once per variant under ``-DMAMBA2_SSD_FAULT=<n>`` into
``build/fault_check/`` (git-ignored; one ``nvcc`` per variant, all started
together), loads each library in turn behind the port's ``mamba2_ssd``
wrapper and runs ``chip_smoke.check_mamba2_ssd`` at the three phase-3
shapes (``SSD_CASES``) in bf16 and fp32.

Variants, and the shapes at which each must fail (it must pass the rest):

- ``sound`` (0): the kernel as it is; fails none;
- ``no_carry`` (1): the carried-state term is dropped after the first
  chunk; fails all three (each has more than one chunk);
- ``diag_shift`` (2): the causal mask excludes the diagonal; fails all
  three;
- ``tail_dt`` (3): the tail past S is not masked (it repeats dt at
  S - 1, so the final state decays too far); fails ``ragged`` and ``h0``,
  whose S is no multiple of the chunk, and passes ``zamba2_prefill``,
  whose S = 4096 is.

Prints one JSON line per (variant, shape, type), then ``{"ok": ...}``;
exits non-zero unless every verdict is as above.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WORK = REPO / "build" / "fault_check"
VARIANTS = {"sound": 0, "no_carry": 1, "diag_shift": 2, "tail_dt": 3}
MUST_FAIL = {"sound": set(),
             "no_carry": {"zamba2_prefill", "ragged", "h0"},
             "diag_shift": {"zamba2_prefill", "ragged", "h0"},
             "tail_dt": {"ragged", "h0"}}


def main() -> int:
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba2_ssd import ops

    if not torch.cuda.is_available():
        print("mamba2_ssd_fault_check: no CUDA device", file=sys.stderr)
        return 2
    WORK.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "mamba2_ssd.cu"
    libs, procs = {}, {}
    for variant, n in VARIANTS.items():
        libs[variant] = WORK / f"mamba2_ssd_{variant}.so"
        procs[variant] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DMAMBA2_SSD_FAULT={n}",
             "-o", str(libs[variant]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{variant}: nvcc exit {proc.returncode}\n{log}",
                  file=sys.stderr)
            return 1
        if variant == "sound":
            print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                        if "registers" in ln
                                        or "spill" in ln]}), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    for variant in VARIANTS:
        lib = ctypes.CDLL(str(libs[variant]))
        _build.library = lambda name, lib=lib: lib
        ops._kernel.cache_clear()
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.bfloat16, torch.float32):
            for case in chip_smoke.SSD_CASES:
                r = chip_smoke.check_mamba2_ssd(torch, *case, dtype, gen,
                                                timed=False)
                r.update(variant=variant,
                         expected_ok=case[0] not in MUST_FAIL[variant])
                print(json.dumps(r), flush=True)
                ok &= r["ok"] == r["expected_ok"]
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

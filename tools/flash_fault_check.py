#!/usr/bin/env python3
"""Fault check of the flash-attention tolerance in ``chip_smoke.py``.

    python3 tools/flash_fault_check.py

Needs one H100.  It copies ``src/repro_torch`` into
``build/fault_check/<variant>/`` (git-ignored), plants one fault in each
copy's bf16 tensor-core kernel (``flash_fwd_mma_kernel``), builds every
copy and runs ``chip_smoke.check_flash`` in bf16 on each, at the qwen2 and
danube shapes of phase 3 (one process per copy, all started together).

Variants and the verdict each must get:

- ``sound``: the kernel as it is; passes both shapes;
- ``pv_swap``: two adjacent keys' probabilities trade places in the first
  register of the P·V A fragment; fails both;
- ``drop_oldest``: the tensor-core path masks the oldest key of a full
  window; fails danube (window 4096) and passes qwen2, which has none.

Prints one JSON line per (variant, shape), with the verdict at the old
uniform bf16 tolerance (3e-2) beside it, then ``{"ok": ...}``; exits
non-zero unless every verdict is as above.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WORK = REPO / "build" / "fault_check"
KERNEL = "kernels/csrc/flash_attention.cu"

# variant: (text of the sound kernel, its faulty replacement)
FAULTS = {
    "sound": None,
    "pv_swap": (
        "const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),",
        "const uint32_t pa[4] = {pack_bf16(s[2 * kk][1], s[2 * kk][0]),"),
    "drop_oldest": (
        "s[nt][i] = visible(key, qpos[h], a) ? s[nt][i] * a.scale : kNegInf;",
        "s[nt][i] = visible(key, qpos[h], a) && qpos[h] - key != a.window - 1"
        " ? s[nt][i] * a.scale : kNegInf;"),
}
SHAPES = ["qwen2", "danube"]
EXPECT = {"sound": {"qwen2": True, "danube": True},
          "pv_swap": {"qwen2": False, "danube": False},
          "drop_oldest": {"qwen2": True, "danube": False}}


def make_copy(variant: str) -> Path:
    """``build/fault_check/<variant>/src`` holding the port with the
    variant's fault planted; the copy builds into its own build dir."""
    root = WORK / variant
    shutil.rmtree(root, ignore_errors=True)
    dst = root / "src" / "repro_torch"
    shutil.copytree(REPO / "src" / "repro_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    fault = FAULTS[variant]
    if fault is not None:
        path = dst / KERNEL
        text = path.read_text()
        if text.count(fault[0]) != 1:
            raise RuntimeError(f"{variant}: the line to change is not in "
                               f"{KERNEL} exactly once")
        path.write_text(text.replace(*fault))
    return root / "src"


def worker(variant: str, src: str) -> None:
    """Build the copy at ``src`` and check its kernel at SHAPES in bf16."""
    sys.path.insert(0, src)
    sys.path.insert(0, str(REPO))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build

    if not Path(repro_torch.__file__).is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in chip_smoke.FLASH_CASES:
        if case[0] in SHAPES:
            r = chip_smoke.check_flash(torch, F, *case, torch.bfloat16, gen,
                                       timed=False)
            print(json.dumps({"variant": variant, **r}), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3])
        return 0
    procs = {v: subprocess.Popen(
        [sys.executable, __file__, "--worker", v, str(make_copy(v))],
        stdout=subprocess.PIPE, text=True) for v in FAULTS}
    ok = True
    for variant, proc in procs.items():
        stdout, _ = proc.communicate()
        seen = {}
        for line in stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                seen[r["shape"]] = r["ok"]
                r["expected_ok"] = EXPECT[variant][r["shape"]]
                print(json.dumps(r), flush=True)
        if proc.returncode != 0 or seen != EXPECT[variant]:
            print(f"{variant}: exit {proc.returncode}, verdicts {seen}, "
                  f"expected {EXPECT[variant]}", file=sys.stderr)
            ok = False
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Build the CUDA kernels in ``kernels/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/repro_torch/`` at
the root of the checkout.  A library's file name carries a hash of its
source and flags, so a stale build is never loaded.  The first call builds
every source that is missing, one ``nvcc`` process per source, all started
together; a failed build raises.  Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing.

    Returns:
        {source name: library path}.
    Raises:
        RuntimeError: nvcc is missing or a compile failed (its output is
            in the message and in ``<library>.log``).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    todo = {n: st for n, st in targets.items() if not st[1].exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
        failed = []
        for name, (proc, tmp, out, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(f"{name}: nvcc exit {rc}\n"
                              + out.with_suffix(".log").read_text())
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: out for n, (_, out) in targets.items()}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first
    use, together with every other source that needs building)."""
    return ctypes.CDLL(str(build_all()[name]))

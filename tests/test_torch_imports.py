"""Import guard for the PyTorch/CUDA port.

Every module of ``src/repro_torch`` and ``chip_smoke.py`` must stand
without JAX: no ``import jax``/``jaxlib`` and no module of the JAX package
(``repro``).  The port's own modules must also not reach the library
attention or normalisation calls (``scaled_dot_product_attention``,
``rms_norm``) that its hand-written kernels replace; ``chip_smoke.py`` may,
to time them as yardsticks.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
LIBRARY_CALLS = {"scaled_dot_product_attention", "rms_norm"}


def _port_files():
    out = []
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden_module(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _library_uses(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in LIBRARY_CALLS:
            yield node.attr
        elif isinstance(node, ast.Name) and node.id in LIBRARY_CALLS:
            yield node.id
        elif isinstance(node, ast.ImportFrom):
            yield from (a.name for a in node.names
                        if a.name in LIBRARY_CALLS)


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def test_port_has_the_slice_modules():
    names = {os.path.relpath(p, PORT) for p in _port_files()}
    for mod in ("configs/base.py", "configs/qwen2_1p5b.py",
                "kernels/_build.py", "kernels/rmsnorm/ops.py",
                "kernels/decode_attention/ops.py",
                "kernels/flash_attention/ops.py",
                "kernels/flash_attention/ref.py", "models/convert.py",
                "serve/engine.py", "launch/serve.py", "core/datatypes.py"):
        assert mod in names


@pytest.mark.parametrize("path", _port_files() + [SMOKE],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(_parse(path)) if _forbidden_module(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_library_attention_or_norm(path):
    bad = sorted(set(_library_uses(_parse(path))))
    assert not bad, f"{path} uses {bad}"

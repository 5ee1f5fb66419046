"""Import guard for the PyTorch/CUDA port.

Every module of ``src/repro_torch`` and ``chip_smoke.py`` must stand
without JAX: no ``import jax``/``jaxlib`` and no module of the JAX package
(``repro``).  The port's own modules must also not reach the library
attention or normalisation calls (``scaled_dot_product_attention``,
``rms_norm``) that its hand-written kernels replace; ``chip_smoke.py`` may,
to time them as yardsticks.  In ``models/moe.py`` the expert weights
(``w_in``, ``w_gate``, ``w_out``) reach no computation but the grouped
matmul kernel's wrapper, ``moe_gmm``.
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
                "kernels/flash_attention/ref.py", "kernels/moe_gmm/ops.py",
                "kernels/moe_gmm/ref.py", "models/moe.py",
                "configs/mixtral_8x22b.py", "configs/zamba2_1p2b.py",
                "kernels/mamba2_ssd/ops.py", "kernels/mamba2_ssd/ref.py",
                "models/ssm.py", "models/convert.py",
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


EXPERT_WEIGHTS = {"w_in", "w_gate", "w_out"}
MATMULS = {"einsum", "bmm", "matmul", "mm", "baddbmm", "linear"}


def test_moe_experts_only_through_moe_gmm():
    """Every use of an expert weight in ``models/moe.py`` is an argument of
    a ``moe_gmm`` call; no einsum, bmm, matmul or ``@`` takes one."""
    tree = _parse(os.path.join(PORT, "models", "moe.py"))
    in_gmm = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "moe_gmm"):
            in_gmm.update(id(a) for a in node.args)
    uses = [n for n in ast.walk(tree) if isinstance(n, ast.Subscript)
            and isinstance(n.slice, ast.Constant)
            and n.slice.value in EXPERT_WEIGHTS]
    assert len(uses) == 3
    assert all(id(n) in in_gmm for n in uses)
    calls = {n.func.attr for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)}
    assert calls & MATMULS == {"einsum"}       # the router's, alone
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.BinOp)
                and isinstance(n.op, ast.MatMult)]

"""The port stands alone: no module of epidemicsimulator_tpu_torch, nor
chip_smoke.py, nor the port's tools, nor the card-only tests, imports JAX
or the JAX package, and the CUDA and host sources are built without
PyTorch's C++ extension machinery."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "epidemicsimulator_tpu_torch"
STANDALONE = sorted(PACKAGE.rglob("*.py")) + sorted(
    (ROOT / "tools").glob("*torch*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
]
FORBIDDEN = ("jax", "jaxlib", "epidemicsimulator_tpu")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", STANDALONE, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_kernels_use_plain_nvcc_build():
    sources = list((PACKAGE / "csrc").glob("*.cu"))
    assert len(sources) >= 2
    for src in sources + [p for ext in ("*.cuh", "*.cpp")
                          for p in (PACKAGE / "csrc").glob(ext)]:
        assert "torch/extension.h" not in src.read_text()
    for path in PACKAGE.rglob("*.py"):
        assert "cpp_extension" not in path.read_text(), path

"""The port stands alone: no module of epidemicsimulator_tpu_torch, nor
chip_smoke.py, nor the port's tools, nor the card-only tests, imports JAX,
the JAX package, pandas or requests (the card's machine need not have
them), and the CUDA and host sources are built without PyTorch's C++
extension machinery, into a library named by the hash of its sources and
of every flag the build passes."""

import ast
import hashlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "epidemicsimulator_tpu_torch"
STANDALONE = sorted(PACKAGE.rglob("*.py")) + sorted(
    (ROOT / "tools").glob("*torch*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
]
FORBIDDEN = ("jax", "jaxlib", "epidemicsimulator_tpu", "pandas", "requests")


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


def test_build_flags_name_their_own_library(monkeypatch):
    """A build with extra flags (``-lineinfo``, ``-Xptxas -v`` once more,
    or a ``-D`` that changes the code) goes to a file of its own and never
    answers for the default build, or the reverse; the default file is
    named as it always was, by the hash of NVCC_FLAGS and the sources.  No
    nvcc is needed: the path is fixed before anything is built."""
    from epidemicsimulator_tpu_torch import runtime

    h = hashlib.sha256(" ".join(runtime.NVCC_FLAGS).encode())
    for src in sorted(runtime.CSRC.glob("*.cu")) + sorted(runtime.CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    default = runtime.BUILD_DIR / f"libesim_kernels_{h.hexdigest()[:16]}.so"
    assert runtime.library_path() == default
    extras = [("-Xptxas", "-v"), ("-lineinfo",), ("-DUNIT=1",)]
    paths = [runtime.library_path(x) for x in extras]
    assert len({default, *paths}) == 1 + len(extras)
    assert all(p.parent == default.parent for p in paths)
    # build() puts each library where library_path() says
    monkeypatch.setattr(runtime, "_build_into", lambda path, make: (path, ""))
    assert runtime.build()[0] == default
    assert [runtime.build(x)[0] for x in extras] == paths


def test_host_library_holds_the_osm_parser(monkeypatch):
    """The OSM parser is the port's own copy of the source, built with the
    Beneš router into the host library under build/, named by the hash
    of the host flags, the libraries it links and the sources; nothing of
    the port reads or builds the JAX package's native/ directory."""
    from epidemicsimulator_tpu_torch import runtime

    sources = sorted(runtime.CSRC.glob("*.cpp"))
    assert [p.name for p in sources] == ["benes_route.cpp", "osm_native.cpp"]
    h = hashlib.sha256(" ".join((*runtime.HOST_FLAGS, *runtime.HOST_LIBS)).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = runtime.BUILD_DIR / f"libesim_host_{h.hexdigest()[:16]}.so"
    assert runtime.host_library_path() == path
    assert runtime.HOST_LIBS == ("-lz",)
    assert path.relative_to(ROOT).parts[0] == "build"
    monkeypatch.setattr(runtime, "_build_into", lambda p, make: (p, ""))
    assert runtime.build_host()[0] == path
    for py in PACKAGE.rglob("*.py"):
        text = py.read_text()
        assert '"native"' not in text and "libesucd" not in text, py

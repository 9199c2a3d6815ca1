"""The device of a run, the build of the CUDA kernels, and their launch
counts.

The kernels in ``csrc/*.cu`` have a plain C interface.  The first call
that needs them compiles all the sources with ONE ``nvcc`` call into one
shared library under ``<checkout>/build/kernels/`` (the file name carries
a hash of the sources and flags, so a changed source builds anew and a
finished build is never reused by mistake), and loads it with ``ctypes``.
Nothing here includes PyTorch's C++ headers: that build takes minutes,
this one seconds.  The library is written under a temporary name and
renamed into place, so concurrent builds and interrupted builds leave no
lock or half-written file behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: launches of each kernel since the last :func:`reset_launches`; each
#: wrapper adds one where it launches its kernel and nowhere else.
launches = {"citizen_phase": 0, "run_totals_fused": 0, "cumsum_i8": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    "es_scan_tile_elems": ([], ctypes.c_int),
    "es_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "es_cumsum_i8": ([_P, _P, _P, ctypes.c_longlong, _P], ctypes.c_int),
    "es_run_totals_i8": (
        [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "es_citizen_phase": (
        [_P] * 14 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                     ctypes.c_float, ctypes.c_float, ctypes.c_int,
                     ctypes.c_int, _P],
        ctypes.c_int,
    ),
}

_library = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def resolve_device(device="cuda") -> torch.device:
    """The torch device for ``device``; raises if it asks for a card that
    is not present (there is no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for and none is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libesim_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` into the shared library unless it exists.
    Returns (path, compiler output)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
           *map(str, sorted(CSRC.glob("*.cu")))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, proc.stdout + proc.stderr


def library():
    """The loaded kernel library, built on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _library = lib
    return _library


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = library().es_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_lanes(name: str, *tensors) -> None:
    """Validate the tensors a kernel takes: contiguous, on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one device")

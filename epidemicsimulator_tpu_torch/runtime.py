"""The device of a run, the build of the kernels, and their launch
counts.

The kernels in ``csrc/*.cu`` have a plain C interface.  The first call
that needs them compiles every source with its own ``nvcc`` process, all
started together, and links the objects into one shared library under
``<checkout>/build/kernels/`` (the file name carries a hash of the
sources and of every flag the build passes, so a changed source or an
extra flag builds anew and a finished build is never reused by
mistake); ``ctypes`` loads it.  Nothing here includes
PyTorch's C++ headers: that build takes minutes, this one seconds.  The
host code in ``csrc/*.cpp`` (the Beneš router, and the OSM PBF parser and
polygon assignment, linked with zlib) is built the same way with the host
C++ compiler into a second library.  Each library is
written in a temporary directory and renamed into place, so concurrent
builds and interrupted builds leave no lock or half-written file behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# -Xptxas -v changes no code: it puts each kernel's registers and shared
# memory in the build's log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
# after the sources on the command line, as the linker needs them
HOST_LIBS = ("-lz",)

#: launches of each kernel since the last :func:`reset_launches`; each
#: wrapper adds one where it launches its kernel and nowhere else.  B1's
#: ensemble mode counts under ``citizen_phase_ensemble``.
launches = {"citizen_phase": 0, "run_totals_fused": 0, "cumsum_i8": 0,
            "cumsum_i8_2phase": 0, "benes_permute": 0,
            "citizen_phase_ensemble": 0}
#: the kernels that the fused step launches; B4 and B5 run on the paths
#: of ``tools/probe_torch_cumsum.py`` and ``tools/probe_torch_benes.py``
MAIN_PATH_KERNELS = ("citizen_phase", "run_totals_fused", "cumsum_i8")
#: the kernels that the packed ensemble's step launches (engine/packed.py)
ENSEMBLE_PATH_KERNELS = ("citizen_phase_ensemble", "run_totals_fused")

_P = ctypes.c_void_p
_SIGNATURES = {
    "es_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "es_cumsum_i8": (
        [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P], ctypes.c_int),
    "es_cumsum_i8_2phase": (
        [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P], ctypes.c_int),
    "es_benes_permute": (
        [_P, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int, _P],
        ctypes.c_int),
    "es_run_totals_i8": (
        [_P] * 8 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "es_citizen_phase": (
        [_P] * 14 + [ctypes.c_longlong, _P, _P, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                     ctypes.c_int,
                     ctypes.c_float, ctypes.c_float, ctypes.c_int,
                     ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P],
        ctypes.c_int,
    ),
}

_F64P = ctypes.POINTER(ctypes.c_double)
_HOST_SIGNATURES = {
    "es_benes_route": (
        [ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
         ctypes.POINTER(ctypes.c_uint8)], ctypes.c_int),
    "esucd_parse_pbf": (
        [ctypes.c_char_p] + [ctypes.c_double] * 4
        + [ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))]
        + [ctypes.POINTER(_F64P)] * 3 + [ctypes.POINTER(ctypes.c_int64)],
        ctypes.c_int),
    "esucd_assign_points": (
        [_F64P, _F64P, ctypes.c_int64, _F64P, _F64P,
         ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
         ctypes.POINTER(ctypes.c_int32)], None),
    "esucd_free": ([ctypes.c_void_p], None),
}

_library = None
_host_library = None


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


def _library_path(stem: str, flags, sources) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path(extra_flags: tuple[str, ...] = ()) -> Path:
    """Where :func:`build` puts the library built with ``extra_flags``
    added to ``NVCC_FLAGS``."""
    return _library_path(
        "libesim_kernels", (*NVCC_FLAGS, *extra_flags),
        sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")))


def host_library_path() -> Path:
    return _library_path("libesim_host", (*HOST_FLAGS, *HOST_LIBS),
                         sorted(CSRC.glob("*.cpp")))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run(cmds: list[list[str]]) -> str:
    """Runs the commands at once; raises if any fails.  Returns their
    output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed ({proc.returncode}):\n{log}")
    return "".join(logs)


def _build_into(path: Path, make) -> tuple[Path, str]:
    """Unless ``path`` exists, ``make(tmpdir)`` builds the library in a
    fresh directory and returns (file, log); the file is renamed to
    ``path``.  Returns (path, log)."""
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        built, log = make(tmp)
        os.replace(built, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path, log


def build(extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` with ``extra_flags`` into the shared library
    unless it exists: one ``nvcc -c`` per source, all at once, then one
    link.  A build with extra flags is a library of its own, never the one
    :func:`library` loads.  Returns (path, compiler output)."""
    def make(tmp):
        nvcc = _nvcc()
        sources = sorted(CSRC.glob("*.cu"))
        objs = [tmp / (src.stem + ".o") for src in sources]
        log = _run([[nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj),
                     str(src)] for src, obj in zip(sources, objs)])
        lib = tmp / "lib.so"
        log += _run([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(lib),
                      *map(str, objs)]])
        return lib, log
    return _build_into(library_path(extra_flags), make)


def build_host() -> tuple[Path, str]:
    """Compile ``csrc/*.cpp`` with the host C++ compiler unless the
    library exists.  Returns (path, compiler output)."""
    def make(tmp):
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if not cxx:
            raise RuntimeError("no host C++ compiler: set CXX or install g++")
        lib = tmp / "lib.so"
        log = _run([[cxx, *HOST_FLAGS, "-o", str(lib),
                     *map(str, sorted(CSRC.glob("*.cpp"))), *HOST_LIBS]])
        return lib, log
    return _build_into(host_library_path(), make)


def _load(path: Path, signatures):
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def library():
    """The loaded kernel library, built on first use."""
    global _library
    if _library is None:
        _library = _load(build()[0], _SIGNATURES)
    return _library


def host_library():
    """The loaded host library (the Beneš router and the OSM parser),
    built on first use."""
    global _host_library
    if _host_library is None:
        _host_library = _load(build_host()[0], _HOST_SIGNATURES)
    return _host_library


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = library().es_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls after
    3 warm-ups, from CUDA events around the whole run."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 300) -> float:
    """Host microseconds per call of ``fn()``, with no synchronize between
    calls: the rate at which the host can issue the calls."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def device_ms(fn, reps: int = 20) -> dict:
    """{CUDA kernel or memset: (device ms, launches) per call of
    ``fn()``}, from torch.profiler over ``reps`` calls after one warm-up.
    Unlike :func:`cuda_ms`, this leaves out the host's time between
    launches.  The launches per call are rounded to a whole number and
    the device ms is the mean per launch times that, so a launch whose
    record the tracer drops does not lower it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if evt.device_type == DeviceType.CUDA and dev_us > 0:
            per_call = max(1, round(evt.count / reps))
            rows[evt.key] = (dev_us / 1e3 / evt.count * per_call, per_call)
    return rows


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def stream_handle() -> int:
    """The current CUDA stream of the current device, as an address.
    ``torch.cuda.current_stream().cuda_stream`` gives the same number but
    builds a Python Stream object first, which costs microseconds of host
    time on every launch (``tools/probe_torch_cumsum.py`` times both)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def check_lanes(name: str, *tensors) -> None:
    """Validate the tensors a kernel takes: contiguous, on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one device")

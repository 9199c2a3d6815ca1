"""Kernels B2 and B3 of the step: contiguous-run totals and the int8
cumsum, with their plain torch versions.

B2 ``run_totals_fused`` replaces ``epidemicsimulator_tpu/ops/
pallas_scans.py::run_totals_fused``; B3 ``cumsum_i8`` replaces
``cumsum_pallas``.  The CUDA kernels are in ``csrc/scans.cu``.  A wrapper
takes the plain version for a CPU tensor and launches the kernel for a
CUDA tensor; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from .. import runtime
from .runsums import run_totals_from_cumsum


def _scratch(n: int, n_sets: int, device) -> torch.Tensor:
    tile = runtime.library().es_scan_tile_elems()
    nb = -(-n // tile)
    return torch.empty(nb * (2 + 4 * n_sets), dtype=torch.int32, device=device)


def cumsum_i8_plain(v):
    return torch.cumsum(v.to(torch.int32), 0, dtype=torch.int32)


def cumsum_i8(v):
    """Inclusive int32 cumsum of an (N,) int8 lane (or a bool lane, read
    as 0/1) whose total fits int32."""
    if v.device.type == "cpu":
        return cumsum_i8_plain(v)
    v = v.contiguous()
    if v.dtype == torch.bool:
        v = v.view(torch.int8)
    if v.dtype != torch.int8 or v.dim() != 1:
        raise ValueError("cumsum_i8 takes an (N,) int8 or bool lane")
    n = v.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=v.device)
    if n == 0:
        return out
    lib = runtime.library()
    err = lib.es_cumsum_i8(v.data_ptr(), out.data_ptr(),
                           _scratch(n, 0, v.device).data_ptr(), n,
                           runtime.stream_handle())
    runtime.check(err, "cumsum_i8")
    runtime.launches["cumsum_i8"] += 1
    return out


def range_totals(v, lo, hi):
    """Totals of v over the ranges [lo, hi) through one B3 cumsum (the
    JAX package's range_totals_pallas)."""
    cs = cumsum_i8(v)
    cs0 = torch.cat([cs.new_zeros(1), cs])
    return cs0[hi.long()] - cs0[lo.long()]


def run_totals_fused_plain(v, sets):
    v32 = v.to(torch.int32)
    cs = torch.cumsum(v32, 0, dtype=torch.int32)
    return tuple(run_totals_from_cumsum(cs, v32, s, e) for s, e in sets)


def run_totals_fused(v, sets):
    """Per-element run totals of the int8 lane ``v`` for one or two
    boundary sets ``[(start_mask, end_mask), ...]`` (bool lanes).  Masks
    must describe whole runs: the first element starts a run and the last
    ends one.  Returns a tuple of int32 lanes, one per set."""
    if v.device.type == "cpu":
        return run_totals_fused_plain(v, sets)
    if not 1 <= len(sets) <= 2:
        raise ValueError("run_totals_fused takes one or two boundary sets")
    v = v.contiguous()
    if v.dtype == torch.bool:
        v = v.view(torch.int8)
    masks = [m.contiguous() for pair in sets for m in pair]
    if v.dtype != torch.int8 or any(m.dtype != torch.bool for m in masks):
        raise ValueError("run_totals_fused takes an int8 lane and bool masks")
    runtime.check_lanes("run_totals_fused", v, *masks)
    n = v.shape[0]
    if any(m.shape != (n,) for m in masks):
        raise ValueError("run_totals_fused: masks must match the lane")
    outs = [torch.empty(n, dtype=torch.int32, device=v.device) for _ in sets]
    if n == 0:
        return tuple(outs)
    ptr = [m.data_ptr() for m in masks] + [None, None]
    out_ptr = [o.data_ptr() for o in outs] + [None]
    lib = runtime.library()
    err = lib.es_run_totals_i8(
        v.data_ptr(), ptr[0], ptr[1], ptr[2], ptr[3], out_ptr[0], out_ptr[1],
        _scratch(n, len(sets), v.device).data_ptr(), n, len(sets),
        runtime.stream_handle(),
    )
    runtime.check(err, "run_totals_fused")
    runtime.launches["run_totals_fused"] += 1
    return tuple(outs)

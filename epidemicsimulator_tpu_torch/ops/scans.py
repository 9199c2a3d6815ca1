"""Kernels B2 and B3 of the step, contiguous-run totals and the int8
cumsum, and B4, the same cumsum in two passes, with their plain torch
versions.

B2 ``run_totals_fused`` replaces ``epidemicsimulator_tpu/ops/
pallas_scans.py::run_totals_fused``; B3 ``cumsum_i8`` replaces
``cumsum_pallas``; B4 ``cumsum_i8_2phase`` replaces ``_cumsum_pallas2``
(off the fused step: ``tools/probe_torch_cumsum.py`` runs it beside B3).
The CUDA kernels are in ``csrc/scans.cu``.  A wrapper
takes the plain version for a CPU tensor and launches the kernel for a
CUDA tensor; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from .. import runtime
from .runsums import run_totals_from_cumsum


#: B3's tile (``VEC * TILE`` in csrc/scans.cu); the kernel refuses scratch
#: sized for a larger one
LOOKBACK_TILE = 16_384

#: B2's unit (``TILE`` in csrc/scans.cu); its scratch holds 4 ints and
#: 2 + 3 * n_sets ints per unit
RUN_TOTALS_UNIT = 4096

#: B4's unit (``UNIT`` in csrc/scans.cu), in the plain version too; its
#: scratch holds 4 ints and one per unit, and the kernel refuses scratch
#: sized for a larger unit
CUMSUM_UNIT = 16_384


def _i8_lane(v, name):
    if v.dtype == torch.bool:
        v = v.view(torch.int8)
    if v.dtype != torch.int8 or v.dim() != 1:
        raise ValueError(f"{name} takes an (N,) int8 or bool lane")
    return v


def cumsum_i8_plain(v):
    return torch.cumsum(v.to(torch.int32), 0, dtype=torch.int32)


def cumsum_i8(v):
    """Inclusive int32 cumsum of an (N,) int8 lane (or a bool lane, read
    as 0/1) whose total fits int32."""
    if v.device.type == "cpu":
        return cumsum_i8_plain(v)
    v = _i8_lane(v.contiguous(), "cumsum_i8")
    n = v.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=v.device)
    # one allocation: the output, padded to 16 bytes, then the kernel's
    # scratch of one 64-bit word per tile and one for its ticket
    n16 = -(-n // 4) * 4
    scratch_words = 2 * (-(-n // LOOKBACK_TILE) + 1)
    buf = torch.empty(n16 + scratch_words, dtype=torch.int32, device=v.device)
    err = runtime.library().es_cumsum_i8(
        v.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * n16,
        4 * scratch_words, n, runtime.stream_handle())
    runtime.check(err, "cumsum_i8")
    runtime.launches["cumsum_i8"] += 1
    return buf[:n]


def cumsum_i8_2phase_plain(v):
    """B4's arithmetic written out: each unit's sum, their exclusive
    cumsum, then each unit's cumsum from its base."""
    v = _i8_lane(v.contiguous(), "cumsum_i8_2phase")
    n = v.shape[0]
    units = torch.zeros(-(-n // CUMSUM_UNIT) * CUMSUM_UNIT, dtype=torch.int32,
                        device=v.device)
    units[:n] = v
    units = units.view(-1, CUMSUM_UNIT)
    sums = units.sum(1, dtype=torch.int32)
    base = torch.cumsum(sums, 0, dtype=torch.int32) - sums
    return (torch.cumsum(units, 1, dtype=torch.int32)
            + base[:, None]).view(-1)[:n]


def cumsum_i8_2phase(v):
    """Inclusive int32 cumsum of an (N,) int8 lane (or a bool lane, read
    as 0/1) whose total fits int32, in two passes over units of
    :data:`CUMSUM_UNIT` elements: the units' sums and their prefixes, then
    each unit's cumsum from its prefix.  Equals :func:`cumsum_i8`."""
    if v.device.type == "cpu":
        return cumsum_i8_2phase_plain(v)
    v = _i8_lane(v.contiguous(), "cumsum_i8_2phase")
    n = v.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=v.device)
    # one allocation: the output, padded to 16 bytes, then the kernels'
    # scratch of a ticket, three pads and one int per unit
    n16 = -(-n // 4) * 4
    scratch = 4 + -(-n // CUMSUM_UNIT)
    buf = torch.empty(n16 + scratch, dtype=torch.int32, device=v.device)
    err = runtime.library().es_cumsum_i8_2phase(
        v.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * n16, 4 * scratch,
        n, runtime.stream_handle())
    runtime.check(err, "cumsum_i8_2phase")
    runtime.launches["cumsum_i8_2phase"] += 1
    return buf[:n]


def range_totals(v, lo, hi, *more):
    """Totals of v over the ranges [lo, hi) through one B3 cumsum (the
    JAX package's range_totals_pallas).  With ``more`` (lo, hi) lanes
    after the first pair, a tuple of each pair's totals from that one
    cumsum."""
    cs = cumsum_i8(v)
    cs0 = torch.cat([cs.new_zeros(1), cs])
    bounds = (lo, hi, *more)
    totals = tuple(cs0[bounds[i + 1].long()] - cs0[bounds[i].long()]
                   for i in range(0, len(bounds), 2))
    return totals if more else totals[0]


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
    k = len(sets)
    if n == 0:
        return tuple(torch.empty(0, dtype=torch.int32, device=v.device)
                     for _ in sets)
    # one allocation: each output from a 16-byte boundary, then the
    # kernels' scratch
    n4 = -(-n // 4) * 4
    scratch = 4 + -(-n // RUN_TOTALS_UNIT) * (2 + 3 * k)
    buf = torch.empty(k * n4 + scratch, dtype=torch.int32, device=v.device)
    ptr = [m.data_ptr() for m in masks] + [None, None]
    base = buf.data_ptr()
    err = runtime.library().es_run_totals_i8(
        v.data_ptr(), ptr[0], ptr[1], ptr[2], ptr[3], base,
        base + 4 * n4 if k == 2 else None, base + 4 * k * n4, 4 * scratch, n,
        k, runtime.stream_handle(),
    )
    runtime.check(err, "run_totals_fused")
    runtime.launches["run_totals_fused"] += 1
    return tuple(buf[i * n4:i * n4 + n] for i in range(k))

"""Kernel B1: the fused citizen phase of the step, with its plain torch
version.

Replaces ``epidemicsimulator_tpu/ops/pallas_citizen.py::citizen_phase``;
the CUDA kernel is ``csrc/citizen.cu``.  One pass over all citizens does
the disease timers, the movement of the schedule and of its work-order
twin, the infected housemates at home, the home exposure probability and
draw, applies the home hits, packs the gates lane for the work and bus
sides, and counts the pre-exposure census.

Lanes, all (N,):

* ``sched`` (int8) packs at_work | on_bus<<1 | bus_to_work<<2 |
  at_work_ws<<3 | on_bus_ws<<4 (the last two are the work-order twin:
  their position j is the citizen ``work_perm[j]``);
* ``gates`` (int8) packs contrib_work | susceptible<<1 | hit_home<<2 |
  on_bus<<3 | infected<<4;
* ``totals`` (8,) int32: S, E, I, R, V before exposure, work contributors,
  infected riders on a bus, home hits.

The home draw hashes ``gid0 + lane`` as a u32 (wrapping), ``gid0`` being
the global id of lane 0: 0 for one world, a shard's first citizen id in
the population-sharded engine and a rank's first packed lane in the
replica-sharded ensemble (``pallas_citizen.py``'s ``int_scalars[6]``).

Ensemble mode (``engine/packed.py``): R replicas of one world lie in R
contiguous spans of ``tiles_per_rep`` tiles, and the per-replica values
come from the rows of ``rep_ints`` (R, 4) int32 [move, mask status,
exposed time, infected time] and ``rep_f32s`` (R, 2) float32 [exposure
chance, 1 - mask effectiveness] (``pallas_citizen.py``'s
``blocks_per_rep`` mode); ``totals`` is then (R, 8), the census of each
replica.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import runtime
from . import maths
from .hashrng import hash_uniform

#: citizens per block of the kernel (``TILE_ELEMS`` in csrc/citizen.cu);
#: the census holds 8 partial counts per block
CITIZEN_TILE = 2048

#: the kernel's ticket per (device, stream): one int that each call leaves
#: at 0, so the calls that share it run in stream order
_tickets: dict = {}


class CitizenStatics(NamedTuple):
    """The kernel's static lanes, bit-packed into five int8 lanes:

    * ``a``: work_start | uses_transport<<5 | work_neq_home<<6
    * ``b``: work_end | (hh_pos & 7)<<5
    * ``c``: (hh_pos >> 3) | hh_size<<2
    * ``d``: ws_work_start | mask_compliant<<5 | same_oa<<6
    * ``e``: ws_work_end | ws_uses_transport<<5
    """

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor


def make_citizen_statics(world) -> CitizenStatics:
    """Pack the static lanes of a world whose lanes are tensors."""
    i32 = lambda x: x.to(torch.int32)
    ws, we = i32(world.work_start), i32(world.work_end)
    uses = i32(world.uses_transport)
    wneq = i32(world.work_building != world.home_building)
    pos, size = i32(world.hh_pos), i32(world.hh_size)
    compliant = i32(world.mask_compliant)
    same_oa = i32(world.work_oa == world.home_oa)
    i8 = lambda x: x.to(torch.int8).contiguous()
    return CitizenStatics(
        a=i8(ws | (uses << 5) | (wneq << 6)),
        b=i8(we | ((pos & 7) << 5)),
        c=i8((pos >> 3) | (size << 2)),
        d=i8(i32(world.ws_work_start) | (compliant << 5) | (same_oa << 6)),
        e=i8(i32(world.ws_work_end) | (i32(world.ws_uses_transport) << 5)),
    )


def _select(move, moved, frozen):
    """``moved`` where citizens move, ``frozen`` where they do not;
    ``move`` is a Python bool or a bool lane."""
    if isinstance(move, torch.Tensor):
        return torch.where(move, moved, frozen)
    return moved if move else frozen


def _movement(h24, move, ws, we, uses, at_work, on_bus):
    arm_bus_out = (h24 == ws - 1) & uses
    if move is False:
        return at_work, on_bus, arm_bus_out
    arm_to_work = h24 == ws
    arm_to_home = h24 == we
    on_bus1 = arm_bus_out | ((h24 == we - 1) & uses)
    at_work1 = torch.where(arm_to_work, True,
                           torch.where(arm_to_home, False, at_work))
    return (_select(move, at_work1, at_work), _select(move, on_bus1, on_bus),
            arm_bus_out)


def _rep_values(rep_ints, rep_f32s, n, tiles_per_rep, device):
    """The ensemble mode's per-replica values as per-citizen lanes."""
    rep = torch.arange(n, device=device) // (tiles_per_rep * CITIZEN_TILE)
    ri, rf = rep_ints.to(device)[rep], rep_f32s.to(device)[rep]
    return dict(move=ri[:, 0] != 0, mask_status=ri[:, 1],
                exposed_time=ri[:, 2], infected_time=ri[:, 3],
                exposure_chance=rf[:, 0], mask_scale=rf[:, 1])


def _u32(gid0) -> int:
    gid0 = int(gid0)
    if not 0 <= gid0 < 2**32:
        raise ValueError(f"citizen_phase: gid0 must be a u32, got {gid0}")
    return gid0


def _require_scalars(**values):
    """Outside the ensemble mode the six per-world scalars must be given:
    a missing ``move`` would otherwise run as a lockdown."""
    missing = [name for name, v in values.items() if v is None]
    if missing:
        raise ValueError("citizen_phase: outside the ensemble mode it needs "
                         + ", ".join(missing))


def citizen_phase_plain(statics, status, timer, sched, *, h24, seed, K,
                        ref_mask_sem, u8_trunc, move=None, mask_status=None,
                        exposed_time=None, infected_time=None,
                        exposure_chance=None, mask_scale=None, want_q=False,
                        rep_ints=None, rep_f32s=None, tiles_per_rep=None,
                        gid0=0):
    n_reps = None
    if rep_ints is not None:
        n_reps = rep_ints.shape[0]
        vals = _rep_values(rep_ints, rep_f32s, status.shape[0], tiles_per_rep,
                           status.device)
        move, mask_status = vals["move"], vals["mask_status"]
        exposed_time, infected_time = vals["exposed_time"], vals["infected_time"]
        exposure_chance, mask_scale = vals["exposure_chance"], vals["mask_scale"]
    else:
        _require_scalars(move=move, mask_status=mask_status,
                         exposed_time=exposed_time, infected_time=infected_time,
                         exposure_chance=exposure_chance, mask_scale=mask_scale)
        move = bool(move)
        # float32 values times a float32-exact Python float: a float32
        # product
        exposure_chance, mask_scale = float(exposure_chance), float(mask_scale)
    u8 = lambda x: x.to(torch.int32) & 0xFF
    pa, pb, pc, pd, pe = (u8(x) for x in statics)
    sch = u8(sched)
    ws, we = pa & 31, pb & 31
    uses, wneq = ((pa >> 5) & 1) != 0, ((pa >> 6) & 1) != 0
    pos = ((pb >> 5) & 7) | ((pc & 3) << 3)
    size = (pc >> 2) & 31

    st = status.to(torch.int32)
    is_e, is_i = st == 1, st == 2
    e_to_i = is_e & (timer >= exposed_time)
    i_to_r = is_i & (timer >= infected_time)
    st1 = torch.where(i_to_r, 3, torch.where(e_to_i, 2, st))
    tm1 = torch.where(e_to_i | i_to_r, 0,
                      torch.where(is_e | is_i, timer + 1, timer))

    at_work1, on_bus1, arm_bus_out = _movement(
        h24, move, ws, we, uses, (sch & 1) != 0, (sch & 2) != 0)
    inf_active = (st1 == 2) & ~on_bus1
    contrib = (inf_active & (~at_work1 | ~wneq)).to(torch.int32)
    n_h = contrib.clone()
    for d in range(1, K):
        n_h += torch.where(pos + d < size, torch.roll(contrib, -d), 0)
        n_h += torch.where(pos - d >= 0, torch.roll(contrib, d), 0)

    at_work_ws1, on_bus_ws1, _ = _movement(
        h24, move, pd & 31, pe & 31, ((pe >> 5) & 1) != 0,
        (sch & 8) != 0, (sch & 16) != 0)
    btw1 = _select(move, arm_bus_out, (sch & 4) != 0)

    compliant, same_oa = ((pd >> 5) & 1) != 0, ((pd >> 6) & 1) != 0
    if ref_mask_sem:
        active = (mask_status == 2) & ~compliant
    else:
        active = compliant & ((mask_status == 2) | ((mask_status == 1) & on_bus1))
    p = torch.where(active, mask_scale, 1.0) * exposure_chance
    q = maths.home_probability(p, (n_h & 0xFF) if u8_trunc else n_h)
    q = torch.where(~at_work1 | same_oa, q, 0.0)

    idx = (torch.arange(st.shape[0], dtype=torch.int64, device=status.device)
           + _u32(gid0)) & 0xFFFFFFFF
    susceptible = st1 == 0
    hit = susceptible & (hash_uniform(seed, idx) < q)
    contrib_work = inf_active & at_work1 & wneq

    i32 = lambda x: x.to(torch.int32)
    gates = (i32(contrib_work) | (i32(susceptible) << 1) | (i32(hit) << 2)
             | (i32(on_bus1) << 3) | (i32(st1 == 2) << 4))
    sched1 = (i32(at_work1) | (i32(on_bus1) << 1) | (i32(btw1) << 2)
              | (i32(at_work_ws1) << 3) | (i32(on_bus_ws1) << 4))
    rows = (lambda x: x.view(n_reps, -1)) if n_reps else (lambda x: x)
    count = lambda x: rows(x).sum(-1, dtype=torch.int32)
    totals = torch.stack(
        [count(st1 == s) for s in range(5)]
        + [count(contrib_work), count(on_bus1 & (st1 == 2)), count(hit)], -1)
    out = (
        torch.where(hit, 1, st1).to(torch.int8),
        torch.where(hit, 0, tm1).to(torch.int32),
        sched1.to(torch.int8),
        gates.to(torch.int8),
        totals,
    )
    return out + (q,) if want_q else out


def citizen_phase(statics, status, timer, sched, *, h24, seed, K,
                  ref_mask_sem, u8_trunc, move=None, mask_status=None,
                  exposed_time=None, infected_time=None, exposure_chance=None,
                  mask_scale=None, want_q=False, rep_ints=None, rep_f32s=None,
                  tiles_per_rep=None, gid0=0):
    """Returns ``(status1, timer1, sched1, gates, totals)`` (and the
    float32 home probability lane if ``want_q``).  Scalars are Python
    values: ``h24`` the hour of day, ``move`` False under lockdown,
    ``seed`` the u32 home-draw seed, ``gid0`` the u32 global id of lane
    0 (the home draw hashes ``gid0 + lane``), ``exposure_chance`` and
    ``mask_scale`` (1 - mask_effectiveness) float32 values.  ``K`` is the
    world's largest household, at most 24.

    Ensemble mode: ``rep_ints`` (R, 4) int32 and ``rep_f32s`` (R, 2)
    float32 on the lanes' device, and ``tiles_per_rep`` with N = R x
    tiles_per_rep x CITIZEN_TILE, take the place of ``move``,
    ``mask_status``, ``exposed_time``, ``infected_time``,
    ``exposure_chance`` and ``mask_scale``; ``totals`` is (R, 8)."""
    if not 0 < K <= 24:
        raise ValueError("the fused citizen phase needs households of 1..24")
    n = status.shape[0]
    ensemble = rep_ints is not None
    if ensemble:
        n_reps = rep_ints.shape[0]
        if (rep_f32s is None or tiles_per_rep is None
                or rep_ints.shape != (n_reps, 4) or rep_f32s.shape != (n_reps, 2)
                or rep_ints.dtype != torch.int32
                or rep_f32s.dtype != torch.float32
                or n != n_reps * tiles_per_rep * CITIZEN_TILE):
            raise ValueError(
                "citizen_phase: the ensemble mode needs rep_ints (R, 4) int32, "
                "rep_f32s (R, 2) float32 and N = R x tiles_per_rep x "
                f"{CITIZEN_TILE}")
    else:
        _require_scalars(move=move, mask_status=mask_status,
                         exposed_time=exposed_time, infected_time=infected_time,
                         exposure_chance=exposure_chance, mask_scale=mask_scale)
    kw = dict(h24=h24, move=move, mask_status=mask_status, seed=seed,
              exposed_time=exposed_time, infected_time=infected_time,
              exposure_chance=exposure_chance, mask_scale=mask_scale, K=K,
              ref_mask_sem=ref_mask_sem, u8_trunc=u8_trunc, want_q=want_q,
              rep_ints=rep_ints, rep_f32s=rep_f32s, tiles_per_rep=tiles_per_rep,
              gid0=_u32(gid0))
    if status.device.type == "cpu":
        return citizen_phase_plain(statics, status, timer, sched, **kw)
    lanes = (*statics, status, timer, sched)
    runtime.check_lanes("citizen_phase", *lanes,
                        *((rep_ints, rep_f32s) if ensemble else ()))
    dtypes = [torch.int8] * 6 + [torch.int32, torch.int8]
    if any(x.dtype != dt or x.shape != (n,) for x, dt in zip(lanes, dtypes)):
        raise ValueError("citizen_phase: lanes must be (N,) with the kernel's dtypes")
    dev = status.device
    if n == 0:
        e8 = torch.empty(0, dtype=torch.int8, device=dev)
        out = (e8, torch.empty(0, dtype=torch.int32, device=dev), e8, e8,
               torch.zeros(8, dtype=torch.int32, device=dev))
        return out + (torch.empty(0, device=dev),) if want_q else out
    # one allocation: timer (and q), status, sched, gates, each from a
    # 16-byte boundary, then the totals, the per-tile census partials and,
    # in the ensemble mode, the per-replica census
    n16 = -(-n // 16) * 16
    lane4 = 4 * n16
    off = 2 * lane4 if want_q else lane4
    n_partials = 8 * -(-n // CITIZEN_TILE)
    n_rep_totals = 8 * n_reps if ensemble else 0
    buf = torch.empty(off + 3 * n16 + 4 * (8 + n_partials + n_rep_totals),
                      dtype=torch.int8, device=dev)
    timer1 = buf[:4 * n].view(torch.int32)
    q = buf[lane4:lane4 + 4 * n].view(torch.float32) if want_q else None
    status1 = buf[off:off + n]
    sched1 = buf[off + n16:off + n16 + n]
    gates = buf[off + 2 * n16:off + 2 * n16 + n]
    at_totals = off + 3 * n16
    at_rep = at_totals + 4 * (8 + n_partials)
    totals = (buf[at_rep:at_rep + 4 * n_rep_totals].view(torch.int32).view(n_reps, 8)
              if ensemble else buf[at_totals:at_totals + 32].view(torch.int32))
    stream = runtime.stream_handle()
    ticket = _tickets.get((dev.index, stream))
    if ticket is None:
        ticket = _tickets[(dev.index, stream)] = torch.zeros(
            1, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    scalar = (lambda x, f: 0 if ensemble else f(x))
    err = runtime.library().es_citizen_phase(
        *(x.data_ptr() for x in lanes),
        base + off, base, base + off + n16, base + off + 2 * n16,
        base + at_totals, base + at_totals + 32, 4 * n_partials,
        ticket.data_ptr(), base + lane4 if want_q else None,
        n, int(h24), scalar(move, lambda x: int(bool(x))),
        scalar(mask_status, int), int(seed), _u32(gid0),
        scalar(exposed_time, int), scalar(infected_time, int), scalar(exposure_chance, float),
        scalar(mask_scale, float), int(bool(ref_mask_sem)),
        int(bool(u8_trunc)),
        rep_ints.data_ptr() if ensemble else None,
        rep_f32s.data_ptr() if ensemble else None,
        int(tiles_per_rep) if ensemble else 0, n_reps if ensemble else 0,
        base + at_rep if ensemble else None,
        stream,
    )
    runtime.check(err, "citizen_phase")
    runtime.launches["citizen_phase_ensemble" if ensemble else "citizen_phase"] += 1
    out = (status1, timer1, sched1, gates, totals)
    return out + (q,) if want_q else out

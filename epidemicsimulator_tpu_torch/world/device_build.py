"""World construction on the device: the synthetic generator and the
index tables as torch operations, so that a full-UK world (63M citizens)
is made on the card instead of by the host generator.

The port's copy of ``epidemicsimulator_tpu/world/device_build.py``, in
two stages:

* :func:`generate_synthetic_world_device` samples the synthetic citizens,
  households, workplaces, schools and teachers in eight stages (the
  structure of ``world/synthetic.py``; reference semantics per
  simulator_builder.rs:1144-1292, building.rs:244-443,
  output_area.rs:128-197) from counter-hash streams (``ops/hashrng.py``),
  so its lanes are the JAX package's bit for bit, and statistically, not
  bitwise, those of the host generator;
* :func:`build_tables_device` is ``make_world``'s canonical building
  relabel and citizen order and the index and fast tables of
  ``World.build_index_tables`` / ``build_fast_tables``, bit for bit the
  host path for the same core lanes.

The JAX package sorts (major, minor) pairs in int32 with two stable
passes; here one stable sort of an int64 key ``major << 32 | minor``
gives the same order (the work order, the riders' order).  Run starts
and ends come from boundary masks; a run's first position is read from
the list of starts (``torch.nonzero``), where the JAX package takes a
running maximum.  Every data-dependent size (buildings, rooms, riders,
the largest household) comes to the host once, between the stages.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import (
    AVERAGE_CLASS_SIZE,
    AVERAGE_OFFICE_SIZE,
    HOUSEHOLD_SIZE,
    MAX_STUDENT_AGE,
    OCC_STUDENT,
    OCC_TEACHING,
    OCC_UNEMPLOYED,
    PUBLIC_TRANSPORT_PERCENTAGE,
)
from ..ops.hashrng import M32, hash_bits, hash_uniform
from ..runtime import resolve_device
from .schema import World
from .synthetic import (
    _OCCUPATION_WEIGHTS,
    _UNEMPLOYED_FRACTION,
    _WORKPLACE_CAPACITY,
    WorldBuildError,
)

_I32_MAX = 2**31 - 1
_LAST = 2**63 - 1  # sorts after every (major << 32 | minor) key


# ---------------------------------------------------------------------------
# (N,) lane helpers: boundary masks, run ranges, ranks within runs
# ---------------------------------------------------------------------------

def _start_mask(*lanes):
    """True at the first element of each run of equal (lane0, lane1, ...)."""
    neq = torch.zeros(lanes[0].shape[0] - 1, dtype=torch.bool,
                      device=lanes[0].device)
    for lane in lanes:
        neq |= lane[1:] != lane[:-1]
    return torch.cat([neq.new_ones(1), neq])


def _end_from_start(start):
    return torch.cat([start[1:], start.new_ones(1)])


def _run_ids(start):
    """0-based run index per element."""
    return torch.cumsum(start, 0) - 1


def _run_ranges(start):
    """(lo, hi) positions of each element's run, given its start mask
    (whose first element is set)."""
    starts = torch.nonzero(start).flatten()
    ends = torch.cat([starts[1:], starts.new_full((1,), start.shape[0])])
    rid = _run_ids(start)
    return starts[rid], ends[rid]


def _cumcount(start):
    """Position of each element within its run."""
    idx = torch.arange(start.shape[0], device=start.device)
    return idx - torch.nonzero(start).flatten()[_run_ids(start)]


def _inverse_perm(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _argsort(key):
    return torch.sort(key, stable=True).indices


def _scatter(n, index, values):
    """An (n,) lane of zeros with ``values`` at ``index``."""
    return torch.zeros(n, dtype=values.dtype, device=values.device).index_put_(
        (index,), values)


def _tick(timing, name, t0, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    now = time.perf_counter()
    timing[name] = timing.get(name, 0.0) + now - t0
    return now


# ---------------------------------------------------------------------------
# Stage 2: canonical order and the index and fast tables (bit for bit the
# host path)
# ---------------------------------------------------------------------------

def _tables(lanes, *, n_buildings, n_oa, n_riders):
    n = lanes["age"].shape[0]
    dev = lanes["age"].device
    idx = torch.arange(n, device=dev)
    i32 = lambda x: x.to(torch.int32)

    # canonical building numbering (make_world): buildings relabelled
    # OA-major, stable by old id within an OA
    hb0, wb0 = lanes["home_building"].long(), lanes["work_building"].long()
    b_oa = torch.zeros(n_buildings, dtype=torch.int32, device=dev)
    b_oa[wb0] = i32(lanes["work_oa"])
    b_oa[hb0] = i32(lanes["home_oa"])
    new_id = _inverse_perm(_argsort(b_oa))
    hb1, wb1 = new_id[hb0], new_id[wb0]
    del b_oa, new_id, hb0, wb0

    # canonical citizen order: stable by the new home building (the
    # identity on an already sorted lane, as the host path's sort-if-needed)
    order = _argsort(hb1)
    take = lambda name, dtype: lanes[name][order].to(dtype)
    out = dict(
        age=take("age", torch.int16),
        occupation=take("occupation", torch.int8),
        home_building=i32(hb1[order]),
        work_building=i32(wb1[order]),
        home_oa=take("home_oa", torch.int32),
        work_oa=take("work_oa", torch.int32),
        room=take("room", torch.int32),
        is_school_work=take("is_school_work", torch.bool),
        uses_transport=take("uses_transport", torch.bool),
        mask_compliant=take("mask_compliant", torch.bool),
        work_start=take("work_start", torch.int8),
        work_end=take("work_end", torch.int8),
    )
    del order, hb1, wb1
    hb, wb, room = out["home_building"], out["work_building"], out["room"]

    # household ranges in citizen order
    h_start = _start_mask(hb)
    home_lo, home_hi = _run_ranges(h_start)

    # the work order: stable by (work_building, room, index), one sort of
    # an int64 key where the JAX package makes two int32 passes
    work_perm = _argsort((wb.long() << 32) | room.long())
    wpos = _inverse_perm(work_perm)
    wb_ws, rm_ws = wb[work_perm], room[work_perm]
    wb_start_ws = _start_mask(wb_ws)
    rm_start_ws = _start_mask(wb_ws, rm_ws)
    del wb_ws, rm_ws
    wb_lo, wb_hi = (x[wpos] for x in _run_ranges(wb_start_ws))
    room_lo, room_hi = (x[wpos] for x in _run_ranges(rm_start_ws))

    # riders by (home_oa, work_oa, index), non-riders after them: one sort
    # of an int64 key where the JAX package makes two int32 passes
    ho, wo = out["home_oa"], out["work_oa"]
    uses = out["uses_transport"]
    rider_perm = _argsort(torch.where(
        uses, (ho.long() << 32) | wo.long(), _LAST))[:n_riders]
    if n_riders:
        rider_route = _run_ids(_start_mask(ho[rider_perm], wo[rider_perm]))
    else:
        rider_route = torch.zeros(0, dtype=torch.int64, device=dev)
    # rpos: riders get their rider slot, non-riders fillers >= R in
    # citizen order
    rpos = torch.zeros(n, dtype=torch.int64, device=dev)
    rpos[rider_perm] = torch.arange(n_riders, device=dev)
    non_rider = ~uses
    rpos = torch.where(non_rider, n_riders + _run_ids(non_rider), rpos)

    # per-OA ranges; canonical order makes OA runs contiguous in both
    # orders (the host path falls back to empty tables otherwise)
    wo_ws = wo[work_perm]
    if n > 1 and not bool((ho[1:] >= ho[:-1]).all()
                          & (wo_ws[1:] >= wo_ws[:-1]).all()):
        raise ValueError("the device table build needs OA-contiguous worlds")
    ho_counts = torch.bincount(ho, minlength=n_oa)
    wo_counts = torch.bincount(wo_ws, minlength=n_oa)
    oa_hi, ws_oa_hi = torch.cumsum(ho_counts, 0), torch.cumsum(wo_counts, 0)
    hh_size = home_hi - home_lo

    wp = work_perm
    out.update(
        home_lo=i32(home_lo), home_hi=i32(home_hi), work_perm=i32(work_perm),
        wb_lo=i32(wb_lo), wb_hi=i32(wb_hi),
        room_lo=i32(room_lo), room_hi=i32(room_hi),
        rider_perm=i32(rider_perm), rider_route=i32(rider_route),
        rider_mask_compliant=out["mask_compliant"][rider_perm],
        rpos=i32(rpos), wpos=i32(wpos),
        home_start_mask=h_start, home_end_mask=_end_from_start(h_start),
        ws_wb_start_mask=wb_start_ws,
        ws_wb_end_mask=_end_from_start(wb_start_ws),
        ws_room_start_mask=rm_start_ws,
        ws_room_end_mask=_end_from_start(rm_start_ws),
        ws_home_oa=ho[wp], ws_work_oa=wo_ws,
        ws_mask_compliant=out["mask_compliant"][wp],
        ws_is_school=out["is_school_work"][wp],
        ws_work_neq_home=(wb != hb)[wp],
        ws_uses_transport=uses[wp],
        ws_work_start=out["work_start"][wp],
        ws_work_end=out["work_end"][wp],
        oa_lo=i32(oa_hi - ho_counts), oa_hi=i32(oa_hi),
        ws_oa_lo=i32(ws_oa_hi - wo_counts), ws_oa_hi=i32(ws_oa_hi),
        hh_pos=(idx - home_lo).to(torch.int16),
        hh_size=hh_size.to(torch.int16),
    )
    return out, int(hh_size.max()) if n else 0


def build_tables_device(core: World, *, n_riders: int | None = None,
                        device="cuda") -> World:
    """``make_world``'s canonical order and ``build_index_tables`` /
    ``build_fast_tables`` on ``device`` for a ``World`` that carries only
    its core lanes (numpy arrays or tensors).  Returns a fully tabled
    ``World`` of tensors on ``device``, bit for bit the host path's for
    the same core lanes.  ``n_riders``, if known, saves a device read."""
    dev = resolve_device(device)
    lanes = {name: torch.as_tensor(getattr(core, name)).to(dev)
             for name in World.CORE_LANES}
    if n_riders is None:
        n_riders = int(lanes["uses_transport"].sum())
    out, max_hh = _tables(lanes, n_buildings=int(core.n_buildings),
                          n_oa=int(core.n_output_areas), n_riders=n_riders)
    return World(
        n_buildings=int(core.n_buildings),
        n_rooms=int(core.n_rooms),
        n_output_areas=int(core.n_output_areas),
        max_household_size=max_hh,
        **out,
    )


# ---------------------------------------------------------------------------
# Stage 1: the synthetic core (the device analog of synthetic.py)
# ---------------------------------------------------------------------------

def _synthetic_core(n, n_oa, n_schools, seed, oas_per_school, commute_spread,
                    mask_percentage, dev, timing):
    """The core lanes and (n_households, n_workplaces, n_classes, n_rooms,
    n_staffed, n_riders) as 0-d tensors."""
    t0 = time.perf_counter()

    def subkey(i):
        return hash_bits((0xA5A5A5A5 + i * 0x9E3779B9) & M32, seed & M32)

    idx = torch.arange(n, device=dev)
    i32 = lambda x: x.to(torch.int32)

    # 1. citizens (synthetic.py:98-115)
    age = (hash_bits(subkey(0), idx) % 90).to(torch.int16)
    is_student = age < MAX_STUDENT_AGE
    cumw = torch.from_numpy(np.cumsum(
        _OCCUPATION_WEIGHTS / _OCCUPATION_WEIGHTS.sum()).astype(np.float32)).to(dev)
    occ = torch.searchsorted(cumw, hash_uniform(subkey(1), idx), right=True)
    occ = torch.clamp(occ, max=8).to(torch.int8)
    unemployed = hash_uniform(subkey(2), idx) < _UNEMPLOYED_FRACTION
    occ = torch.where(unemployed, OCC_UNEMPLOYED, occ).to(torch.int8)
    occ = torch.where(is_student, OCC_STUDENT, occ).to(torch.int8)
    mask_compliant = hash_uniform(subkey(3), idx) < mask_percentage
    uses_transport = hash_uniform(subkey(4), idx) < PUBLIC_TRANSPORT_PERCENTAGE
    t0 = _tick(timing, "citizens", t0, dev)

    # 2. households and home OAs (synthetic.py:117-129)
    home_oa = torch.sort(i32(hash_bits(subkey(5), idx) % n_oa)).values
    hh_in_oa = _cumcount(_start_mask(home_oa)) // HOUSEHOLD_SIZE
    household = i32(_run_ids(_start_mask(home_oa, hh_in_oa)))
    del hh_in_oa
    n_households = household[n - 1] + 1
    t0 = _tick(timing, "households", t0, dev)

    # 3. commuting (synthetic.py:131-135): a Laplace shift by the inverse
    # CDF, in float32; clipped before the int cast (u == -0.5 gives -inf)
    u = hash_uniform(subkey(6), idx) - 0.5
    lap = -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
    del u
    shift = i32(torch.round(torch.clamp(lap * commute_spread, -float(n_oa),
                                        float(n_oa))))
    del lap
    work_oa = torch.clamp(home_oa + shift, 0, n_oa - 1)
    del shift
    t0 = _tick(timing, "commuting", t0, dev)

    # 4. workplaces (synthetic.py:137-150): workers sorted by (work_oa,
    # occupation), packed to capacity
    is_worker = ~is_student & (occ != OCC_UNEMPLOYED)
    w_bucket = work_oa * 16 + occ
    w_perm = _argsort(torch.where(is_worker, w_bucket, _I32_MAX))
    b_start = _start_mask(w_bucket[w_perm])
    del w_bucket
    caps = torch.tensor(_WORKPLACE_CAPACITY, dtype=torch.int64, device=dev)[
        torch.clamp(occ[w_perm], 0, 8).long()]
    slot = _cumcount(b_start) // caps
    del caps
    wp_start = (b_start | _start_mask(slot)) & is_worker[w_perm]
    del b_start, slot
    wp_id = _run_ids(wp_start)  # dense id among workers (the sorted prefix)
    n_workplaces = wp_start.sum()
    del wp_start
    t0 = _tick(timing, "workplaces", t0, dev)

    # 5. schools (synthetic.py:152-178): students in classes of about
    # AVERAGE_CLASS_SIZE per (school, age) group
    school_of_oa = torch.clamp(
        torch.arange(n_oa, device=dev) // oas_per_school, max=n_schools - 1)
    school_oa = torch.clamp(
        torch.arange(n_schools, device=dev) * oas_per_school, 0, n_oa - 1)
    s_school = school_of_oa[home_oa]
    s_key = torch.where(is_student, s_school * 256 + age, _I32_MAX)
    s_perm = _argsort(s_key)
    # the run structure comes from the unmasked key, so that the
    # non-student tail is a run of its own
    g_run_start = _start_mask(s_key[s_perm])
    del s_key
    g_start = g_run_start & is_student[s_perm]
    g_lo, g_hi = _run_ranges(g_run_start)
    g_count = (g_hi - g_lo).to(torch.float32)
    del g_lo, g_hi
    # a float32 divisor on the device: a CPU scalar divisor may become a
    # multiplication by its reciprocal, which rounds differently
    avg_class = torch.full((), AVERAGE_CLASS_SIZE, dtype=torch.float32,
                           device=dev)
    class_counts = torch.clamp(torch.ceil(g_count / avg_class), min=1.0)
    class_sizes = torch.ceil(g_count / class_counts).long()
    class_counts = class_counts.long()
    del g_count
    class_in_group = _cumcount(g_run_start) // class_sizes
    del class_sizes, g_run_start
    cc_at_start = torch.where(g_start, class_counts, 0)
    class_id = torch.cumsum(cc_at_start, 0) - class_counts + class_in_group
    del class_in_group
    n_classes = cc_at_start.sum()
    del cc_at_start
    classes_per_school = torch.zeros(n_schools, dtype=torch.int64, device=dev)
    classes_per_school.index_add_(
        0, torch.where(g_start, s_school[s_perm], 0),
        torch.where(g_start, class_counts, 0))
    del g_start, class_counts
    sch_class_base = torch.cumsum(classes_per_school, 0) - classes_per_school
    t0 = _tick(timing, "schools", t0, dev)

    # 6. teachers (synthetic.py:180-228): teaching-occupation workers by
    # their work OA's school, the shortfall taken from other workers
    is_teacher_pool = is_worker & (occ == OCC_TEACHING)
    pool_school = school_of_oa[work_oa]
    t_key = torch.where(is_teacher_pool, pool_school, _I32_MAX)
    t_perm = _argsort(t_key)
    t_in_pool = is_teacher_pool[t_perm]
    del is_teacher_pool
    t_school = pool_school[t_perm]
    tr_start = _start_mask(t_key[t_perm])  # unmasked: the tail is its own run
    del t_key
    t_rank = _cumcount(tr_start)
    t_needed = classes_per_school[t_school]
    t_take = t_in_pool & (t_rank < t_needed)
    t_class = sch_class_base[t_school] + t_rank
    # per school, the taken count = min(pool size, needed)
    tp_start = tr_start & t_in_pool
    tp_lo, tp_hi = _run_ranges(tr_start)
    del tr_start
    already = torch.zeros(n_schools, dtype=torch.int64, device=dev)
    already.index_add_(0, torch.where(tp_start, t_school, 0), torch.where(
        tp_start, torch.minimum(tp_hi - tp_lo, t_needed), 0))
    del tp_start, tp_lo, tp_hi
    deficit = classes_per_school - already

    is_other = is_worker & (occ != OCC_TEACHING)
    o_key = torch.where(is_other, pool_school, _I32_MAX)
    o_perm = _argsort(o_key)
    o_school = pool_school[o_perm]
    o_rank = _cumcount(_start_mask(o_key[o_perm]))
    del o_key
    o_take = is_other[o_perm] & (o_rank < deficit[o_school])
    del is_other
    o_class = sch_class_base[o_school] + already[o_school] + o_rank
    del o_school, o_rank
    n_staffed = t_take.sum() + o_take.sum()
    t0 = _tick(timing, "teachers", t0, dev)

    # 7. leftover teachers in offices of AVERAGE_OFFICE_SIZE
    # (synthetic.py:230-243)
    t_left = t_in_pool & ~t_take
    del t_in_pool
    office_in_school = torch.where(
        t_left, (t_rank - t_needed) // AVERAGE_OFFICE_SIZE, 0)
    del t_rank, t_needed
    offices_per_school = torch.zeros(n_schools, dtype=torch.int64, device=dev)
    offices_per_school.scatter_reduce_(
        0, torch.where(t_left, t_school, 0),
        torch.where(t_left, office_in_school + 1, 0), reduce="amax")
    office_base = (n_classes + torch.cumsum(offices_per_school, 0)
                   - offices_per_school)
    left_room = office_base[t_school] + office_in_school
    del t_school, office_in_school
    n_rooms = n_classes + offices_per_school.sum()
    t0 = _tick(timing, "offices", t0, dev)

    # 8. the citizen-order lanes (synthetic.py:245-279)
    workplace_base = n_households
    school_base = workplace_base + n_workplaces
    work_building = torch.where(
        is_worker, _scatter(n, w_perm, workplace_base + wp_id), household)
    work_oa_final = torch.where(is_worker, work_oa, home_oa)
    del wp_id, w_perm, is_worker
    # students: their school and class
    work_building = torch.where(is_student, school_base + s_school,
                                work_building)
    work_oa_final = torch.where(is_student, school_oa[s_school], work_oa_final)
    room = torch.where(is_student, _scatter(n, s_perm, class_id), 0)
    del s_school, s_perm, class_id
    room_is_set = is_student.clone()
    # class teachers and conscripts, then leftover teachers in offices
    take_lane = _scatter(n, t_perm, t_take)
    teach = take_lane | _scatter(n, o_perm, o_take)
    tcls = torch.where(take_lane, _scatter(n, t_perm, t_class),
                       _scatter(n, o_perm, o_class))
    del take_lane, t_take, o_take, t_class, o_class, o_perm
    left_lane = _scatter(n, t_perm, t_left)
    lroom_lane = _scatter(n, t_perm, left_room)
    del t_perm, t_left, left_room
    staff = teach | left_lane
    work_building = torch.where(staff, school_base + pool_school, work_building)
    work_oa_final = torch.where(staff, school_oa[pool_school], work_oa_final)
    room = torch.where(left_lane, lroom_lane, torch.where(teach, tcls, room))
    del tcls, lroom_lane, teach, left_lane, pool_school
    room_is_set |= staff
    is_school_work = is_student | staff
    room = torch.where(room_is_set, room, n_rooms)

    lanes = dict(
        age=age,
        occupation=occ,
        home_building=household,
        work_building=i32(work_building),
        home_oa=home_oa,
        work_oa=i32(work_oa_final),
        room=i32(room),
        is_school_work=is_school_work,
        uses_transport=uses_transport,
        mask_compliant=mask_compliant,
        work_start=torch.full((n,), 9, dtype=torch.int8, device=dev),
        work_end=torch.full((n,), 17, dtype=torch.int8, device=dev),
    )
    scalars = torch.stack([n_households.long(), n_workplaces, n_classes,
                           n_rooms, n_staffed, uses_transport.sum()])
    _tick(timing, "assemble", t0, dev)
    return lanes, scalars


def generate_synthetic_world_device(
    n_citizens: int,
    n_output_areas: int = 64,
    *,
    seed: int = 42,
    oas_per_school: int = 4,
    commute_spread: float = 3.0,
    mask_percentage: float = 0.8,
    device="cuda",
    timing: dict | None = None,
) -> World:
    """A synthetic world built on ``device`` (the card unless the caller
    passes ``"cpu"``): the structure of
    :func:`..world.synthetic.generate_synthetic_world`, the lanes of the
    JAX package's ``generate_synthetic_world_device`` bit for bit.
    Raises with no CUDA device; there is no fall back to the host
    generator.  ``timing``, if given, accumulates seconds by stage: the
    eight stages of the core, ``sync`` (its sizes to the host) and
    ``tables``."""
    dev = resolve_device(device)
    tm = timing if timing is not None else {}
    n = int(n_citizens)
    n_oa = int(n_output_areas)
    if n <= 0:
        raise ValueError("n_citizens must be positive")
    n_schools = max(1, (n_oa + oas_per_school - 1) // oas_per_school)
    # the JAX package passes these as float32 values
    lanes, scalars = _synthetic_core(
        n, n_oa, n_schools, int(seed), int(oas_per_school),
        float(np.float32(commute_spread)), float(np.float32(mask_percentage)),
        dev, tm)
    t0 = time.perf_counter()
    (n_households, n_workplaces, n_classes, n_rooms, n_staffed,
     n_riders) = scalars.tolist()
    t0 = _tick(tm, "sync", t0, dev)
    if n_staffed < n_classes:
        raise WorldBuildError(
            f"synthetic world cannot staff {n_classes} classes with "
            f"{n_staffed} teachers")
    core = World(
        n_buildings=n_households + n_workplaces + n_schools,
        n_rooms=n_rooms,
        n_output_areas=n_oa,
        **lanes,
    )
    del lanes
    world = build_tables_device(core, n_riders=n_riders, device=dev)
    _tick(tm, "tables", t0, dev)
    return world

"""The fused fast step: the main-path formulation of the JAX package's
``engine/fastpath.py::fast_step`` (``SimConfig(use_fused_citizen=True,
use_pallas_scans=True)``, dense apply), written for eager PyTorch.

Per step:

1. the threefry key chain gives the step's seeds, on the host;
2. kernel B1 runs the citizen phase and counts the census; reading those
   eight counts is the step's one device-to-host read, and it decides
   which sides run;
3. the work side (hours with infected workers at work) gathers the
   contributor bits into work order, takes the building and room totals
   with kernel B2, draws the work exposures and counts them per work OA
   with kernel B3;
4. the bus side (hours with an infected rider on a bus) shuffles riders
   into buses and draws the bus exposures (ops/segments.py);
5. the hits are applied, the home exposures are counted per OA (B3),
   the interventions are updated on the host from the census, and an
   exact-k vaccination picks the k lowest fresh hash scores of the pool,
   ranking ties at the threshold with B3; or, from 16M citizens on (the
   fixed-priority pool, ``SimConfig.vaccination_fixed_priority``), the
   first k distinct live ids of 8,192 draws from a compacted pool of
   citizen ids.  The pool's hours read the device once more: whether the
   pool was rebuilt and whether the draws were enough.

The JAX package has a sorted and a sortless body for the work and bus
sides, chosen per hour by cost; they give identical values, and so does
the one body here, which uses plain index operations for its
permutations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import (
    MASK_EVERYWHERE,
    MASK_NONE,
    MASK_PUBLIC_TRANSPORT,
    STATUS_EXPOSED,
    STATUS_SUSCEPTIBLE,
    STATUS_VACCINATED,
)
from ..ops import maths, scans, segments, threefry
from ..ops.citizen import CitizenStatics, citizen_phase, make_citizen_statics
from ..ops.hashrng import hash_bits, hash_uniform
from ..ops.select import bisect_threshold_rows
from ..ops.sparse import scatter_bits
from .state import SimState
from .step import StepOutput


class StepTables(NamedTuple):
    """A world's static step inputs, built once per run."""

    statics: CitizenStatics
    work_perm: torch.Tensor   # int64, citizen of each work-order slot
    wpos: torch.Tensor        # int64, work-order slot of each citizen
    rider_perm: torch.Tensor  # int64, citizen of each rider slot
    oa_lo: torch.Tensor
    oa_hi: torch.Tensor
    ws_oa_lo: torch.Tensor
    ws_oa_hi: torch.Tensor
    iota: torch.Tensor        # int64 arange(N), the hash counters


def make_step_tables(world) -> StepTables:
    """From a world whose lanes are tensors on the run's device."""
    if world.oa_lo.shape[0] != world.n_output_areas:
        raise ValueError("the fast step needs the per-OA range tables")
    long = lambda x: x.long()
    return StepTables(
        statics=make_citizen_statics(world),
        work_perm=long(world.work_perm),
        wpos=long(world.wpos),
        rider_perm=long(world.rider_perm),
        oa_lo=long(world.oa_lo),
        oa_hi=long(world.oa_hi),
        ws_oa_lo=long(world.ws_oa_lo),
        ws_oa_hi=long(world.ws_oa_hi),
        iota=torch.arange(world.n_citizens, dtype=torch.int64,
                          device=world.work_perm.device),
    )


def mask_active(ms, compliant, on_bus, reference):
    """disease.rs:131-154 mask activity: ``ms`` a Python int for one
    world, an (R, 1) column over (R, M) views for a packed ensemble."""
    if reference:
        return (ms == MASK_EVERYWHERE) & ~compliant
    return compliant & ((ms == MASK_EVERYWHERE)
                        | ((ms == MASK_PUBLIC_TRANSPORT) & on_bus))


def _exposure_p(p0, mask_scale, mask_status, compliant, on_bus, reference):
    """Mask-adjusted exposure chance in float32 (disease.rs:131-154)."""
    active = mask_active(mask_status, compliant, on_bus, reference)
    # float32 values times a Python float that is exactly a float32:
    # the product is the float32 product, as in the JAX package
    return torch.where(active, float(mask_scale), 1.0) * float(p0)


def _work_side(world, tables, cfg, p_fn, gates, sched, seed_w, record_oa):
    """Work exposures as a citizen-order hit lane, and their count per
    work OA (building.rs:278-280; school rooms per building.rs:494-522)."""
    g_ws = gates[tables.work_perm]
    n_w, room = scans.run_totals_fused(
        g_ws & 1,
        [(world.ws_wb_start_mask, world.ws_wb_end_mask),
         (world.ws_room_start_mask, world.ws_room_end_mask)],
    )
    draws = torch.where(world.ws_is_school, room, (n_w > 0).to(torch.int32))
    at_work_ws = (sched & 8) != 0
    p_ws = p_fn(world.ws_mask_compliant, (sched & 16) != 0)
    cur_oa = torch.where(at_work_ws, world.ws_work_oa, world.ws_home_oa)
    n_eff = maths.truncate_u8(n_w) if cfg.reference_u8_truncation else n_w
    q_single = maths.binomial_at_least_one(p_ws, n_eff)
    q = torch.where((cur_oa == world.ws_work_oa) & world.ws_work_neq_home,
                    maths.binomial_at_least_one(q_single, draws), 0.0)
    hit_ws = ((g_ws & 2) != 0) & (hash_uniform(seed_w, tables.iota) < q)
    if record_oa:
        from_work = hit_ws & ((g_ws & 4) == 0)
        oa_work = scans.range_totals(from_work, tables.ws_oa_lo, tables.ws_oa_hi)
    else:
        oa_work = None
    return hit_ws[tables.wpos], oa_work


#: the fixed-priority pool's candidate draws per step
POOL_DRAWS = 8192
_SEQ_BITS = 13  # POOL_DRAWS == 1 << _SEQ_BITS


def wants_fixed_priority_vax(world, cfg) -> bool:
    """Whether the step vaccinates from the fixed-priority pool (the JAX
    package's ``engine/fastpath.py::wants_fixed_priority_vax``); callers
    of ``init_state`` pass it to allocate the pool's lanes.  Auto (None):
    on for worlds of 16M citizens or more."""
    fp = cfg.vaccination_fixed_priority
    if fp is None:
        fp = world.n_citizens >= 16_000_000
    return bool(fp) and cfg.use_fast_path and world.has_fast_tables


def _fresh_choice(eligible, k, seed_vax, tables):
    """Exact-k uniform selection (simulator.rs:524-553): the k lowest
    fresh hash scores of the pool, ties at the threshold taken in citizen
    order.  No device read."""
    scores = hash_bits(seed_vax, tables.iota)
    tau = bisect_threshold_rows(scores[None], eligible[None], k.view(1))[0]
    below = eligible & (scores < tau)
    at = eligible & (scores == tau)
    allowed = k - below.sum()
    return below | (at & (scans.cumsum_i8(at) <= allowed))


def _pool_choice(eligible, rate, k_vax, pool, pool_size, newly_started,
                 tables):
    """The fixed-priority pool's draw (the JAX package's
    ``fastpath.py:1609-1644`` and ``:1694-1734``): returns ``(chosen,
    pool, pool_size)``.  k, the eligible count clamped to ``rate``, comes
    from the eligible lane's cumsum, which the draw needs anyway.

    The pool is rebuilt, as the stable partition of the citizen ids by
    ``~eligible``, the step vaccination starts and when the live pool has
    fallen below half of ``pool_size``.  POOL_DRAWS threefry draws from
    ``k_vax`` pick slots below the pool's size (Lemire rejection), the
    slots' ids that are no longer eligible are rejected, and the first k
    distinct ids in draw order are chosen; when fewer than k come up, the
    fresh threshold selector seeded from ``fold_in(k_vax, 1)`` chooses
    instead.  Both decisions depend on the device's data; the draw is
    made for both pools at once (the rebuilt pool's slot s holds the
    (s+1)-th eligible id, found in the eligible lane's cumsum) and the two
    flags come to the host in one read."""
    n = eligible.shape[0]
    dev = eligible.device
    cum = scans.cumsum_i8(eligible)
    k = torch.clamp(cum[-1], max=rate)
    n_elig = cum[-1].to(torch.int64)
    need = (n_elig * 2 < pool_size) | bool(newly_started)
    size = torch.where(need, n_elig, pool_size.to(torch.int64))
    u = threefry.bits(k_vax, POOL_DRAWS, device=dev)
    size_u = torch.clamp(size, min=1)
    accept = u >= (2**32 - size_u) % size_u  # 2^32 mod size
    slot = u % size_u
    rank_member = torch.searchsorted(cum, (slot + 1).to(torch.int32))
    pool_member = pool[torch.clamp(slot, max=n - 1)].long()
    members = torch.clamp(torch.where(need, rank_member, pool_member),
                          max=n - 1)
    alive = accept & (slot < size) & eligible[members]
    # the first k distinct ids in draw order: sort (id, draw) as one key
    seq = torch.arange(POOL_DRAWS, dtype=torch.int64, device=dev)
    key = torch.sort((torch.where(alive, members, n) << _SEQ_BITS) | seq).values
    sk, ss = key >> _SEQ_BITS, key & (POOL_DRAWS - 1)
    first = (sk < n) & torch.cat([sk.new_ones(1, dtype=torch.bool),
                                  sk[1:] != sk[:-1]])
    n_distinct = first.sum()
    order = torch.sort(torch.where(first, ss, 2**30)).values
    kth_seq = order[torch.clamp(k.to(torch.int64) - 1, 0, POOL_DRAWS - 1)]
    sel = first & (ss <= kth_seq) & (k >= 1)
    rebuilt, enough = torch.stack([need, n_distinct >= k]).tolist()
    if rebuilt:
        iota = tables.iota
        pos = torch.where(eligible, cum.long() - 1, n_elig + iota - cum)
        pool = torch.empty(n, dtype=torch.int32, device=dev)
        pool[pos] = iota.to(torch.int32)
        pool_size = n_elig.to(torch.int32)
    if enough:
        chosen = scatter_bits(n, torch.where(sel, sk, n), sel)
    else:
        chosen = _fresh_choice(eligible, k, threefry.bits(
            threefry.fold_in(k_vax, 1)), tables)
    return chosen, pool, pool_size


def next_mask_status(ms, pct, th_pt, th_all):
    """interventions.rs:142-180, elementwise: scalars for one world, (R,)
    rows for a packed ensemble.  Returns int8 numpy values."""
    return np.where(
        ms == MASK_NONE,
        np.where(pct > th_pt, MASK_PUBLIC_TRANSPORT, MASK_NONE),
        np.where(
            ms == MASK_PUBLIC_TRANSPORT,
            np.where(pct < th_pt, MASK_NONE,
                     np.where(pct > th_all, MASK_EVERYWHERE,
                              MASK_PUBLIC_TRANSPORT)),
            np.where(pct < th_all, MASK_PUBLIC_TRANSPORT, MASK_EVERYWHERE),
        ),
    ).astype(np.int8)


def interventions(th, state: SimState, census):
    """The intervention state machine (interventions.rs:110-184) on the
    host, from the step's S, E, I, R, V census (a host list), in float32
    as the JAX package compares: exposures only move citizens from S to
    E, so the census decides it.  Returns ``(lockdown, newly_started,
    vaccination_started, mask_status)``."""
    f32 = np.float32
    pct = f32(census[2]) / f32(sum(census[:5]))
    lockdown = bool(f32(th.lockdown) >= 0 and f32(th.lockdown) < pct)
    newly_started = bool(not state.vaccination_started
                         and f32(th.vaccination) >= 0
                         and f32(th.vaccination) < pct)
    ms_next = int(next_mask_status(state.mask_status, pct,
                                   f32(th.mask_public_transport),
                                   f32(th.mask_everywhere)))
    return (lockdown, newly_started,
            state.vaccination_started or newly_started, ms_next)


def fast_step(world, params, cfg, state: SimState, tables=None):
    """One hour from ``state``; returns ``(new_state, StepOutput)``.
    ``world`` holds tensors on the state's device; ``tables`` are its
    :func:`make_step_tables`, built here when not given."""
    d, th = params.disease, params.thresholds
    n = world.n_citizens
    dev = state.status.device
    fixed_pri = wants_fixed_priority_vax(world, cfg)
    if fixed_pri and state.vax_pool.shape[0] != n:
        raise ValueError(
            "this world and config vaccinate from the fixed-priority pool, "
            "but the state has no pool: pass fixed_priority_vax="
            "wants_fixed_priority_vax(world, cfg) to init_state, or set "
            "SimConfig.vaccination_fixed_priority=False for the fresh draw")
    if tables is None:
        tables = make_step_tables(world)
    f32 = np.float32

    hour = state.hour + 1
    k_bus, k_h, k_w, k_b, k_vax = threefry.split(
        threefry.fold_in(state.rng_key, hour), 5)
    p0 = f32(d.exposure_chance)
    mask_scale = f32(1.0) - f32(d.mask_effectiveness)

    status, timer, sched, gates, totals = citizen_phase(
        tables.statics, state.status, state.timer, state.sched,
        h24=hour % 24, move=not state.lockdown, mask_status=state.mask_status,
        seed=threefry.bits(k_h), exposed_time=int(d.exposed_time),
        infected_time=int(d.infected_time), exposure_chance=p0,
        mask_scale=mask_scale, K=world.max_household_size,
        ref_mask_sem=cfg.reference_mask_semantics,
        u8_trunc=cfg.reference_u8_truncation,
    )
    census = totals.tolist()  # the step's one device read
    hit_home = (gates & 4) != 0
    record_oa = cfg.record_exposures_per_oa and tables.oa_lo.shape[0] > 0

    def p_fn(compliant, on_bus):
        return _exposure_p(p0, mask_scale, state.mask_status, compliant,
                           on_bus, cfg.reference_mask_semantics)

    no_hits = torch.zeros(n, dtype=torch.bool, device=dev)
    oa_work = None
    hit_work = no_hits
    if census[5] > 0:
        hit_work, oa_work = _work_side(world, tables, cfg, p_fn, gates, sched,
                                       threefry.bits(k_w), record_oa)
    hit_bus = no_hits
    if census[6] > 0 and world.n_riders > 0:
        pk = gates[tables.rider_perm]
        hit_bus = segments.bus_hits(
            k_bus, k_b, (pk & 8) != 0, (pk & 16) != 0, (pk & 2) != 0,
            world.rider_mask_compliant, world.rider_route, tables.rider_perm,
            cfg.bus_capacity, p_fn, n,
        )[0]

    # apply (the home hits are already in status/timer; re-applying them
    # is idempotent)
    newly = hit_home | hit_work | hit_bus
    status = torch.where(newly, STATUS_EXPOSED, status)
    timer = torch.where(newly, 0, timer)
    from_bus = hit_bus & ~hit_home & ~hit_work
    if cfg.faithful_vaccine_bugs:
        eligible = state.eligible & ~from_bus
    else:
        eligible = state.eligible & ~newly
    n_new = newly.sum(dtype=torch.int32)
    if record_oa:
        exposures = scans.range_totals(hit_home, tables.oa_lo, tables.oa_hi)
        if oa_work is not None:
            exposures = exposures + oa_work
    else:
        exposures = torch.zeros(0, dtype=torch.int32, device=dev)
    seirv = totals[:5].clone()
    seirv[STATUS_SUSCEPTIBLE] -= n_new
    seirv[STATUS_EXPOSED] += n_new

    lockdown, newly_started, vaccination_started, ms_next = interventions(
        th, state, census)
    if newly_started:
        eligible = status == STATUS_SUSCEPTIBLE

    vax_pool, vax_pool_size = state.vax_pool, state.vax_pool_size
    if vaccination_started:
        rate = int(d.vaccination_rate)
        if fixed_pri:
            chosen, vax_pool, vax_pool_size = _pool_choice(
                eligible, rate, k_vax, vax_pool, vax_pool_size, newly_started,
                tables)
        else:
            k = torch.clamp(eligible.sum(dtype=torch.int32), max=rate)
            chosen = _fresh_choice(eligible, k, threefry.bits(k_vax), tables)
        new = torch.where(chosen, STATUS_VACCINATED, status)
        if not cfg.faithful_vaccine_bugs:
            new = torch.where(chosen & (status != STATUS_SUSCEPTIBLE), status,
                              new)
            eligible = eligible & ~chosen
        status = new
        n_vax = chosen.sum(dtype=torch.int32)
    else:
        n_vax = torch.zeros((), dtype=torch.int32, device=dev)

    new_state = SimState(
        status=status, timer=timer, sched=sched, eligible=eligible,
        vax_pool=vax_pool, vax_pool_size=vax_pool_size, hour=hour,
        lockdown=lockdown, vaccination_started=vaccination_started,
        mask_status=ms_next, rng_key=state.rng_key,
    )
    out = StepOutput(
        seirv=seirv,
        exposures_per_oa=exposures,
        n_bus_exposures=from_bus.sum(dtype=torch.int32),
        n_exposures=n_new,
        lockdown=lockdown,
        mask_status=ms_next,
        n_vaccinated_now=n_vax,
    )
    return new_state, out

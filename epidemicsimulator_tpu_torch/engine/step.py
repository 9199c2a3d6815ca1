"""One hour of the simulation: ``step`` and its per-step observables.

The port of the JAX package's ``engine/step.py``.  ``step`` dispatches as
the JAX one does: the fused fast step of ``engine/fastpath.py`` when
``cfg.use_fast_path`` is set, the world carries its fast tables and the
step is not sharded; otherwise the portable step below, the formulation
that the JAX package's scalar oracle checks.

The portable step per hour (the JAX step's stages, cited by number):

1. timers advance, and the schedule moves everyone unless a lockdown
   holds them; the census of S, E, I, R, V and whether anyone rides are
   read on the host in one read, which decides the bus side and the
   interventions;
2. infection pressure: with index tables (one card), the household,
   work-building and room totals are range totals of kernel B3's cumsums;
   without them (or sharded), ``index_add_`` segment sums, summed over
   the ranks;
3. the home, work and bus exposure chances, the bus side shuffling
   riders into buses by a stable sort (``ops/segments.py``);
4. three threefry uniforms per citizen draw the exposures, attributed
   home, then work, then bus;
5. the interventions on the host, and vaccination of the k lowest
   threefry scores of the pool, taken by a stable sort (lower index
   first among equal scores, as XLA's TopK takes them); sharded, the
   threshold is the rate-th of every rank's k_max lowest scores.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import (
    STATUS_EXPOSED,
    STATUS_INFECTED,
    STATUS_RECOVERED,
    STATUS_SUSCEPTIBLE,
    STATUS_VACCINATED,
)
from ..ops import maths, scans, segments, threefry


class StepOutput(NamedTuple):
    """Per-step observables (statistics.rs:208).  From :func:`step` the
    counts are 0-d device tensors and the interventions host values; from
    a chunk runner every field gains a leading step axis."""

    seirv: torch.Tensor             # (5,) int32 after exposures, pre-vaccination
    exposures_per_oa: torch.Tensor  # (n_oa,) int32, or (0,) if not recorded
    n_bus_exposures: torch.Tensor
    n_exposures: torch.Tensor
    lockdown: object                # bool, post-update
    mask_status: object             # int MASK_*, post-update
    n_vaccinated_now: torch.Tensor


def uses_fast_step(world, cfg) -> bool:
    """Whether :func:`step` takes the fused fast step for this world and
    config (``step.py:76`` of the JAX package, one card)."""
    return bool(cfg.use_fast_path and world.has_fast_tables)


def step(world, params, cfg, state, tables=None, group=None):
    """Advance one hour; returns ``(new_state, StepOutput)``.  ``tables``
    are the world's prebuilt :func:`~.fastpath.make_step_tables` (the
    fast step's alone).  ``group``: this rank's
    :class:`~..parallel.comm.RankGroup` when the step runs on one shard
    of a population sharded over ranks (``parallel/mesh.py``); the step
    is then the portable one, and every count it returns is summed over
    the ranks."""
    if group is None and uses_fast_step(world, cfg):
        from .fastpath import fast_step

        return fast_step(world, params, cfg, state, tables=tables)
    return portable_step(world, params, cfg, state, group=group)


def _identity(x):
    return x


def lowest_k(scores, k: int):
    """The k lowest of an (N,) float32 lane and their indices, the lower
    index first among equal scores: the order of XLA's TopK, which the
    JAX step takes as ``top_k(-scores, k)``.  A stable sort gives it;
    ``torch.topk`` orders tied values otherwise."""
    top, idxs = torch.sort(scores, stable=True)
    return top[:k], idxs[:k]


def portable_step(world, params, cfg, state, group=None):
    """The JAX package's portable step (``engine/step.py:84-456``) on the
    port's packed schedule lane: bits 0-2 (at work, on a bus, bound for
    work) evolve, bits 3-4 (the fast step's work-order twins) and the
    fixed-priority pool are carried through untouched."""
    from .fastpath import _exposure_p, interventions
    from .state import SimState

    d, th = params.disease, params.thresholds
    n = world.n_citizens
    dev = state.status.device
    f32 = np.float32
    psum = group.psum if group is not None else _identity

    hour = state.hour + 1
    key = threefry.fold_in(state.rng_key, hour)
    if group is not None:
        key = threefry.fold_in(key, group.rank)  # per-rank streams
    k_bus, k_draw, k_vax = threefry.split(key, 3)

    # 1. disease timers (disease.rs:47-71): E->I and I->R on the old timer
    status, timer = state.status, state.timer
    is_e = status == STATUS_EXPOSED
    is_i = status == STATUS_INFECTED
    e_to_i = is_e & (timer >= int(d.exposed_time))
    i_to_r = is_i & (timer >= int(d.infected_time))
    status = torch.where(e_to_i, STATUS_INFECTED, status)
    status = torch.where(i_to_r, STATUS_RECOVERED, status)
    timer = torch.where(e_to_i, 0, torch.where(is_e | is_i, timer + 1, timer))
    timer = torch.where(i_to_r, 0, timer)

    # 2. movement (citizen.rs:168-216), frozen whole under a lockdown
    sched = state.sched
    at_work = (sched & 1) != 0
    on_bus = (sched & 2) != 0
    bus_to_work = (sched & 4) != 0
    if not state.lockdown:
        h24 = hour % 24
        ws, we = world.work_start, world.work_end  # int8, as in the JAX step
        arm_bus_out = ((ws - 1) == h24) & world.uses_transport
        arm_bus_home = ((we - 1) == h24) & world.uses_transport
        at_work = torch.where(ws == h24, True,
                              torch.where(we == h24, False, at_work))
        on_bus = arm_bus_out | arm_bus_home
        bus_to_work = arm_bus_out

    # 3. the census after the advance, and whether anyone rides: the
    # step's one host read (simulator.rs:178)
    census = torch.cat([
        torch.bincount(status.long(), minlength=5)[:5],
        on_bus.any().to(torch.int64).view(1),
    ]).to(torch.int32)
    census = psum(census).tolist()
    any_rider = census[5] > 0

    # 4. infection pressure (simulator.rs:181-198): riders contribute on
    # the bus, not in a building
    inf_active = (status == STATUS_INFECTED) & ~on_bus
    neq = world.work_building != world.home_building
    contrib_home = inf_active & (~at_work | ~neq)
    contrib_work = inf_active & at_work & neq
    use_prefix = group is None and world.has_index_tables
    if use_prefix:
        n_h = scans.range_totals(contrib_home, world.home_lo, world.home_hi)
        n_w, draws_room = scans.range_totals(
            contrib_work[world.work_perm.long()], world.wb_lo, world.wb_hi,
            world.room_lo, world.room_hi)
    else:
        pos_building = torch.where(at_work, world.work_building,
                                   world.home_building)
        inf_in_school = inf_active & at_work & world.is_school_work
        tables = psum(torch.cat([
            segments.count_per_segment(inf_active, pos_building,
                                       world.n_buildings),
            segments.count_per_segment(inf_in_school, world.room,
                                       world.n_rooms + 1),
        ]))
        n_inf_building = tables[:world.n_buildings]
        n_inf_room = tables[world.n_buildings:]
        n_h = n_inf_building[world.home_building.long()]
        n_w = n_inf_building[world.work_building.long()]
        draws_room = n_inf_room[world.room.long()]

    # 5. exposure chances (disease.rs:131-154, citizen.rs:221-248)
    p0 = f32(d.exposure_chance)
    mask_scale = f32(1.0) - f32(d.mask_effectiveness)
    p_cit = _exposure_p(p0, mask_scale, state.mask_status,
                        world.mask_compliant, on_bus,
                        cfg.reference_mask_semantics)
    trunc = maths.truncate_u8 if cfg.reference_u8_truncation else _identity
    cur_oa = torch.where(at_work, world.work_oa, world.home_oa)
    q_home = torch.where(cur_oa == world.home_oa,
                         maths.binomial_at_least_one(p_cit, trunc(n_h)), 0.0)
    draws_w = torch.where(world.is_school_work, draws_room,
                          (n_w > 0).to(torch.int32))
    q_single = maths.binomial_at_least_one(p_cit, trunc(n_w))
    q_work = torch.where((cur_oa == world.work_oa) & neq,
                         maths.binomial_at_least_one(q_single, draws_w), 0.0)

    # bus side (simulator.rs:360-401), on hours when anyone rides
    n_inf_my_bus = torch.zeros(n, dtype=torch.int32, device=dev)
    if any_rider:
        is_inf = status == STATUS_INFECTED
        if use_prefix and world.rider_perm is not None:
            rp = world.rider_perm.long()
            rb_on = on_bus[rp]
            n_inf_my_bus[rp] = segments.bus_infection_counts(
                k_bus, rb_on, world.rider_route, is_inf[rp] & rb_on,
                cfg.bus_capacity)
        else:
            # route ids src * n_oa + dst in int32, wrapping as the JAX
            # step's do from 46,341 OAs on
            src = torch.where(bus_to_work, world.home_oa, world.work_oa)
            dst = torch.where(bus_to_work, world.work_oa, world.home_oa)
            route_key = (src.long() * world.n_output_areas + dst.long()) \
                & 0xFFFFFFFF
            route_key = torch.where(route_key >= 2**31, route_key - 2**32,
                                    route_key)
            n_inf_my_bus = segments.bus_infection_counts(
                k_bus, on_bus, route_key, is_inf & on_bus, cfg.bus_capacity)
    q_bus = segments.bus_exposure_probability(p_cit, n_inf_my_bus)

    # 6. exposure draws, attributed home -> work -> bus
    u = threefry.uniform(k_draw, 3 * n, dev).view(3, n)
    susceptible = status == STATUS_SUSCEPTIBLE
    hit_home = susceptible & (u[0] < q_home)
    hit_work = susceptible & (u[1] < q_work)
    hit_bus = susceptible & (u[2] < q_bus)
    newly = hit_home | hit_work | hit_bus
    status = torch.where(newly, STATUS_EXPOSED, status)
    timer = torch.where(newly, 0, timer)
    from_work = hit_work & ~hit_home
    from_bus = hit_bus & ~hit_home & ~hit_work
    if cfg.faithful_vaccine_bugs:
        eligible = state.eligible & ~from_bus
    else:
        eligible = state.eligible & ~newly
    counts = [newly.sum(dtype=torch.int32).view(1),
              from_bus.sum(dtype=torch.int32).view(1)]
    if cfg.record_exposures_per_oa:
        # building-sourced exposures count against the building's OA
        # (statistics.rs:181-195).  The JAX step sends the uncounted to a
        # last segment that it drops; here they add their 0 to their own
        # OA, which gives the same totals without every citizen's atomic
        # add landing on one slot
        counts.append(segments.count_per_segment(
            hit_home | from_work,
            torch.where(hit_home, world.home_oa, world.work_oa),
            world.n_output_areas))

    # 7. interventions (interventions.rs:110-184)
    lockdown, newly_started, started, ms_next = interventions(th, state,
                                                              census)
    if newly_started:
        eligible = status == STATUS_SUSCEPTIBLE

    # 8. vaccination (simulator.rs:524-553): the k_max lowest scores, the
    # first vaccination_rate of them
    n_vax = torch.zeros(1, dtype=torch.int32, device=dev)
    if started:
        rate = int(d.vaccination_rate)
        k_max = min(cfg.max_vaccinations_per_step, n)
        scores = torch.where(eligible, threefry.uniform(k_vax, n, dev), 2.0)
        top, idxs = lowest_k(scores, k_max)
        if group is not None:
            every = torch.sort(group.all_gather(top).reshape(-1)).values
            kth = every[min(max(rate - 1, 0), every.shape[0] - 1)]
            chosen = (top <= kth) & (top <= 1.0)
        else:
            chosen = (torch.arange(k_max, device=dev) < rate) & (top <= 1.0)
        cur = status[idxs]
        if cfg.faithful_vaccine_bugs:
            # the chosen become V whatever their status, and stay in the pool
            status[idxs] = torch.where(chosen, STATUS_VACCINATED, cur)
        else:
            ok = chosen & (cur == STATUS_SUSCEPTIBLE)
            status[idxs] = torch.where(ok, STATUS_VACCINATED, cur)
            eligible[idxs] = eligible[idxs] & ~chosen
        n_vax = chosen.sum(dtype=torch.int32).view(1)

    counts = psum(torch.cat([*counts[:2], n_vax, *counts[2:]]))
    n_new = counts[0]
    seirv = torch.tensor(census[:5], dtype=torch.int32, device=dev)
    seirv[STATUS_SUSCEPTIBLE] -= n_new
    seirv[STATUS_EXPOSED] += n_new
    sched = ((sched & 24) | at_work.to(torch.int8)
             | (on_bus.to(torch.int8) << 1) | (bus_to_work.to(torch.int8) << 2))
    new_state = SimState(
        status=status, timer=timer, sched=sched, eligible=eligible,
        vax_pool=state.vax_pool, vax_pool_size=state.vax_pool_size,
        hour=hour, lockdown=lockdown, vaccination_started=started,
        mask_status=ms_next, rng_key=state.rng_key,
    )
    out = StepOutput(
        seirv=seirv,
        exposures_per_oa=(counts[3:] if cfg.record_exposures_per_oa
                          else torch.zeros(0, dtype=torch.int32, device=dev)),
        n_bus_exposures=counts[1],
        n_exposures=n_new,
        lockdown=lockdown,
        mask_status=ms_next,
        n_vaccinated_now=counts[2],
    )
    return new_state, out

"""The population-sharded fast step over a group of ranks: the port of the
JAX package's ``parallel/fastmesh.py`` in its fused formulation.

Pairs with :mod:`.partition` (household-aligned shards and static ghost
work slots).  Each rank holds one shard, (S,) lanes, and runs the same
engine as the one-card step (``engine/fastpath.py``) on it:

1. kernel B1 (``ops/citizen.py``) runs the citizen phase with the shard's
   global-id offset ``gid0``, so every home draw hashes the global
   citizen id; the eight-count census is summed over the ranks
   (``psum``) and read on the host: that one read decides, on every rank
   alike, whether the work and bus sides run (the JAX step's ``lax.cond``
   on psum'd predicates) and steers the interventions;
2. the work side takes the rank's work slots: its local participants'
   bits by a static gather, and its foreign workers' (the ghosts') bits
   by one ``all_to_all`` of the packed int8 bits; kernel B2 takes the
   building and room totals, the draw hashes each slot's single-card
   work-order position, kernel B3 counts the work exposures per OA, and
   one ``all_to_all`` sends the ghosts' hits back to their home ranks;
3. the bus side is local to the rank (riders live on their home shard),
   with per-rank threefry keys (the key folded with the rank, the one
   documented divergence from the one-card step, FIDELITY.md);
4. vaccination picks the global k lowest hash scores of the global ids:
   the threshold from ``ops/select.py::kth_threshold_sharded``, the ties at
   it split by rank order (one ``all_gather`` of the per-rank counts), and
   within a rank in lane order by B3's cumsum.

Every collective is entered by all ranks in the same order: each branch
depends only on summed values read on the host.  The per-step counts that
decide nothing (new exposures, bus exposures, vaccinations and the per-OA
table) are summed over the ranks once per chunk: a sum of the stacked
steps is the stack of the per-step sums.  The JAX sharded runner ships the
per-OA table as int32, without the one-card runner's int16 saturation,
and so does this one.

Not ported (off by default there): the sortless sharded branches, the
sparse work-back and the ``debug_*`` probes; ``SimConfig`` refuses them
(``config.py::NOT_PORTED``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import (
    STATUS_EXPOSED,
    STATUS_SUSCEPTIBLE,
    STATUS_VACCINATED,
    require_fast_path,
)
from ..engine.fastpath import _exposure_p, interventions
from ..engine.state import SimState, init_state
from ..engine.step import StepOutput
from ..ops import maths, scans, segments, threefry
from ..ops.citizen import CitizenStatics, citizen_phase
from ..ops.hashrng import M32, hash_bits, hash_uniform
from ..ops.select import kth_threshold_sharded
from .launch import launch
from .partition import PAD_STATUS, ShardedWorld, partition_world, shard

#: the lanes of a sharded state, in the padded shard layout
LANES = ("status", "timer", "sched", "eligible")


def shard_citizen_statics(sw: ShardedWorld, device) -> CitizenStatics:
    """B1's packed static lanes of one rank's shard
    (``fastmesh.py::_shard_citizen_statics``).  The sharded step has no
    work-order twin, so the d and e lanes' work-schedule fields are 0."""
    i32 = lambda x: np.asarray(x).astype(np.int32)
    ws, we = i32(sw.work_start), i32(sw.work_end)
    pos, size = i32(sw.hh_pos), i32(sw.hh_size)
    lanes = (
        ws | (i32(sw.uses_transport) << 5) | (i32(sw.work_neq_home) << 6),
        we | ((pos & 7) << 5),
        (pos >> 3) | (size << 2),
        (i32(sw.mask_compliant) << 5) | (i32(sw.same_oa) << 6),
        np.zeros_like(ws),
    )
    return CitizenStatics(*(torch.from_numpy(x.astype(np.int8)).to(device)
                            for x in lanes))


class ShardTables(NamedTuple):
    """One rank's static step inputs on its device, built once per run."""

    statics: CitizenStatics
    gid0: int                 # global id of lane 0
    gid: torch.Tensor         # int64 u32 global id per lane (pads 2**32-1)
    slot_src: torch.Tensor    # int64 (W,): local citizen of each slot, or S
    cit_slot: torch.Tensor    # int64 (S,): slot of each local citizen, or W
    ghost_src: torch.Tensor   # int64 (n_dev * G,): local citizen sent, or S
    ghost_slot: torch.Tensor  # int64 (n_dev * G,): slot received, or W
    slot_active: torch.Tensor
    slot_local: torch.Tensor
    slot_is_school: torch.Tensor
    slot_mask_compliant: torch.Tensor
    slot_same_oa: torch.Tensor
    slot_ws_index: torch.Tensor  # int64: the single-card work-order position
    run_sets: list            # B2's (start, end) masks: buildings, rooms
    rider_local: torch.Tensor  # int64 (R,): local citizen of each rider, or S
    rider_route: torch.Tensor
    rider_compliant: torch.Tensor
    oa_lo: torch.Tensor
    oa_hi: torch.Tensor
    ws_oa_lo: torch.Tensor
    ws_oa_hi: torch.Tensor


def make_shard_tables(sw: ShardedWorld, device) -> ShardTables:
    """From one rank's shard (:func:`.partition.shard`)."""
    S, W = sw.shard_size, sw.n_slots
    host = lambda x: np.asarray(x)
    t = lambda x, dt=torch.int64: torch.from_numpy(
        np.ascontiguousarray(host(x))).to(device=device, dtype=dt)
    sort_rank = host(sw.sort_rank).astype(np.int64)
    unsort = host(sw.unsort_rank).astype(np.int64)
    gid = host(sw.global_id).astype(np.int64)
    return ShardTables(
        statics=shard_citizen_statics(sw, device),
        gid0=int(gid[0]),  # shards are contiguous global ranges
        gid=t(gid & M32),
        slot_src=t(np.where(unsort[:W] < S, unsort[:W], S)),
        cit_slot=t(np.where(sort_rank[:S] < W, sort_rank[:S], W)),
        ghost_src=t(host(sw.out_ghost_src).reshape(-1)),
        ghost_slot=t(host(sw.recv_slot_pos).reshape(-1)),
        slot_active=t(sw.slot_active, torch.bool),
        slot_local=t(sw.slot_local, torch.bool),
        slot_is_school=t(sw.slot_is_school, torch.bool),
        slot_mask_compliant=t(sw.slot_mask_compliant, torch.bool),
        slot_same_oa=t(sw.slot_same_oa, torch.bool),
        slot_ws_index=t(sw.slot_ws_index),
        run_sets=[(t(sw.wb_start, torch.bool), t(sw.wb_end, torch.bool)),
                  (t(sw.room_start, torch.bool), t(sw.room_end, torch.bool))],
        rider_local=t(sw.rider_local),
        rider_route=t(sw.rider_route, torch.int32),
        rider_compliant=t(sw.rider_compliant, torch.bool),
        oa_lo=t(sw.oa_lo),
        oa_hi=t(sw.oa_hi),
        ws_oa_lo=t(sw.ws_oa_lo),
        ws_oa_hi=t(sw.ws_oa_hi),
    )


def _ext(lane, value=0):
    """The lane with one element appended, the target of pad indices."""
    return torch.cat([lane, lane.new_full((1,), value)])


def _work_side(tables, cfg, group, fwd, p_fn, seed_w, record_oa):
    """Work exposures (building.rs:278-280; school rooms per
    building.rs:494-522) on the rank's slots: the local citizens' hit
    lane and the work exposures per OA.  Two all_to_alls."""
    # slot bits: local participants by the static gather; the ghost slots
    # from their home ranks (fwd: contrib | susc<<1 | hit_home<<2 |
    # on_bus<<3 | infected<<4 | at_work<<5)
    fwd_ext = _ext(fwd)
    recv = group.all_to_all(fwd_ext[tables.ghost_src])
    slots = _ext(fwd_ext[tables.slot_src])
    slots[tables.ghost_slot] = recv
    slots = slots[:-1]
    active = tables.slot_active
    contrib = ((slots & 1) != 0) & active
    n_w, room = scans.run_totals_fused(contrib.to(torch.int8), tables.run_sets)
    draws = torch.where(tables.slot_is_school, room, (n_w > 0).to(torch.int32))
    p_s = p_fn(tables.slot_mask_compliant, (slots & 8) != 0)
    n_eff = maths.truncate_u8(n_w) if cfg.reference_u8_truncation else n_w
    q_single = maths.binomial_at_least_one(p_s, n_eff)
    gate = active & (((slots & 32) != 0) | tables.slot_same_oa)
    q = torch.where(gate, maths.binomial_at_least_one(q_single, draws), 0.0)
    hit_s = (((slots & 2) != 0) & active
             & (hash_uniform(seed_w, tables.slot_ws_index) < q))
    oa_work = None
    if record_oa:
        oa_work = scans.range_totals(hit_s & ((slots & 4) == 0),
                                     tables.ws_oa_lo, tables.ws_oa_hi)
    # hits back: local participants by the static inverse gather (a ghost
    # slot is never a local citizen's slot), ghosts to their home ranks
    hit_ext = _ext(hit_s & tables.slot_local, False)
    hit = _ext(hit_ext[tables.cit_slot].to(torch.int8))
    back = group.all_to_all(_ext(hit_s.to(torch.int8))[tables.ghost_slot])
    hit.scatter_reduce_(0, tables.ghost_src, back, reduce="amax")
    return hit[:-1] != 0, oa_work


def _bus_side(tables, cfg, fwd, p_fn, k_bus, k_b):
    """Bus exposures, local to the rank (ops/segments.py)."""
    pk = _ext(fwd)[tables.rider_local]
    return segments.bus_hits(
        k_bus, k_b, (pk & 8) != 0, (pk & 16) != 0, (pk & 2) != 0,
        tables.rider_compliant, tables.rider_route, tables.rider_local,
        cfg.bus_capacity, p_fn, fwd.shape[0],
    )[0]


def _vaccinate(tables, cfg, group, status, eligible, rate, seed_vax):
    """Exact global k (simulator.rs:524-553): the k lowest hash scores of
    the global ids in the pool.  Returns (status, eligible, chosen)."""
    i32 = torch.int32
    scores = hash_bits(seed_vax, tables.gid)
    n_elig = group.psum(eligible.sum(dtype=i32))
    k = torch.clamp(n_elig, max=rate)
    tau = kth_threshold_sharded(
        scores, eligible, k, n_elig, group,
        force_sampled=cfg.use_sampled_vax_sharded,
        sample_log2=cfg.vax_sharded_sample_log2)
    below = eligible & (scores < tau)
    at = eligible & (scores == tau)
    # ties at tau go in global citizen order: shard by shard, then lane
    # by lane (shards are contiguous ranges of ids)
    counts = group.all_gather(torch.stack([below.sum(dtype=i32),
                                           at.sum(dtype=i32)]))
    allowed = k - counts[:, 0].sum()
    quota = torch.clamp(allowed - counts[:group.rank, 1].sum(), min=0)
    chosen = below | (at & (scans.cumsum_i8(at) <= quota))
    new = torch.where(chosen, STATUS_VACCINATED, status).to(torch.int8)
    if not cfg.faithful_vaccine_bugs:
        eligible = eligible & ~chosen
        new = torch.where(chosen & (status != STATUS_SUSCEPTIBLE), status, new)
    return new, eligible, chosen


def fast_shard_step(sw: ShardedWorld, tables: ShardTables, params, cfg,
                    state: SimState, group):
    """One hour on this rank's shard.  Returns ``(new_state, census,
    counts)``: the summed pre-exposure S, E, I, R, V as a host list, and
    this rank's (3 + n_oa,) int32 counts on the device (new exposures,
    bus exposures, vaccinations, then the exposures per OA), which the
    chunk runner sums over the ranks."""
    d, th = params.disease, params.thresholds
    f32 = np.float32
    hour = state.hour + 1
    k_bus, k_h, k_w, k_b, k_vax = threefry.split(
        threefry.fold_in(state.rng_key, hour), 5)
    # citizen-keyed draws hash global ids; the bus keys are per rank
    k_bus = threefry.fold_in(k_bus, group.rank)
    k_b = threefry.fold_in(k_b, group.rank)
    p0 = f32(d.exposure_chance)
    mask_scale = f32(1.0) - f32(d.mask_effectiveness)

    status, timer, sched, gates, totals = citizen_phase(
        tables.statics, state.status, state.timer, state.sched,
        h24=hour % 24, move=not state.lockdown, mask_status=state.mask_status,
        seed=threefry.bits(k_h), exposed_time=int(d.exposed_time),
        infected_time=int(d.infected_time), exposure_chance=p0,
        mask_scale=mask_scale, K=sw.max_household_size,
        ref_mask_sem=cfg.reference_mask_semantics,
        u8_trunc=cfg.reference_u8_truncation, gid0=tables.gid0,
    )
    census = group.psum(totals[:7]).tolist()  # the step's one read
    hit_home = (gates & 4) != 0
    fwd = gates | ((sched & 1) << 5)
    record_oa = cfg.record_exposures_per_oa

    def p_fn(compliant, on_bus):
        return _exposure_p(p0, mask_scale, state.mask_status, compliant,
                           on_bus, cfg.reference_mask_semantics)

    no_hits = torch.zeros_like(hit_home)
    hit_work, oa_work = no_hits, None
    if census[5] > 0:
        hit_work, oa_work = _work_side(tables, cfg, group, fwd, p_fn,
                                       threefry.bits(k_w), record_oa)
    hit_bus = no_hits
    if census[6] > 0:
        hit_bus = _bus_side(tables, cfg, fwd, p_fn, k_bus, k_b)

    # apply (the home hits are already in status and timer)
    newly = hit_home | hit_work | hit_bus
    status = torch.where(newly, STATUS_EXPOSED, status).to(torch.int8)
    timer = torch.where(newly, 0, timer)
    from_bus = hit_bus & ~hit_home & ~hit_work
    if cfg.faithful_vaccine_bugs:
        eligible = state.eligible & ~from_bus
    else:
        eligible = state.eligible & ~newly

    # interventions on the summed census
    lockdown, newly_started, started, ms_next = interventions(th, state,
                                                              census)
    if newly_started:
        eligible = status == STATUS_SUSCEPTIBLE
    n_vax = torch.zeros((), dtype=torch.int32, device=status.device)
    if started:
        status, eligible, chosen = _vaccinate(
            tables, cfg, group, status, eligible, int(d.vaccination_rate),
            threefry.bits(k_vax))
        n_vax = chosen.sum(dtype=torch.int32)

    parts = [newly.sum(dtype=torch.int32), from_bus.sum(dtype=torch.int32),
             n_vax]
    if record_oa:
        oa = scans.range_totals(hit_home, tables.oa_lo, tables.oa_hi)
        parts.append(oa if oa_work is None else oa + oa_work)
    counts = torch.cat([torch.stack(parts[:3]), *parts[3:]])
    new_state = SimState(
        status=status, timer=timer, sched=sched, eligible=eligible,
        vax_pool=state.vax_pool, vax_pool_size=state.vax_pool_size,
        hour=hour, lockdown=lockdown, vaccination_started=started,
        mask_status=ms_next, rng_key=state.rng_key,
    )
    return new_state, census[:5], counts


def make_shard_chunk_runner(sw: ShardedWorld, cfg, group):
    """``chunk(params, state) -> (state, StepOutput)`` for one rank's
    shard: ``cfg.chunk_size`` steps, the outputs as numpy arrays, the same
    on every rank."""
    require_fast_path(cfg, "fast sharded engine")
    tables = make_shard_tables(sw, group.device)

    def chunk(params, state):
        rows, lock, mask, counts = [], [], [], []
        for _ in range(cfg.chunk_size):
            state, census, c = fast_shard_step(sw, tables, params, cfg,
                                               state, group)
            rows.append(census)
            lock.append(state.lockdown)
            mask.append(state.mask_status)
            counts.append(c)
        summed = group.psum(torch.stack(counts)).cpu().numpy()
        seirv = np.asarray(rows, np.int32)
        seirv[:, STATUS_SUSCEPTIBLE] -= summed[:, 0]
        seirv[:, STATUS_EXPOSED] += summed[:, 0]
        # the work-order twin's schedule bits are the kernel's scratch
        # here; the JAX runner drops them at every chunk's end
        state = dataclasses.replace(state, sched=state.sched & 7)
        return state, StepOutput(
            seirv=seirv,
            exposures_per_oa=summed[:, 3:],
            n_bus_exposures=summed[:, 1],
            n_exposures=summed[:, 0],
            lockdown=np.asarray(lock, bool),
            mask_status=np.asarray(mask, np.int8),
            n_vaccinated_now=summed[:, 2],
        )

    return chunk


def init_sharded_state(world, sw: ShardedWorld, *, seed=0,
                       starting_infected=10) -> SimState:
    """The one-card ``init_state`` scattered into the padded shard layout:
    host lanes of n_dev * S, shard r at [r * S, (r + 1) * S), pads with
    status PAD_STATUS; no fixed-priority pool (the sharded step never
    uses it)."""
    gs = init_state(world, seed=seed, starting_infected=starting_infected,
                    device="cpu")
    gid = np.asarray(sw.global_id).reshape(-1)
    real = gid >= 0

    def lane(x, pad):
        x = x.numpy()
        out = np.full(gid.shape, pad, x.dtype)
        out[real] = x[gid[real]]
        return torch.from_numpy(out)

    return dataclasses.replace(
        gs, status=lane(gs.status, PAD_STATUS), timer=lane(gs.timer, 0),
        sched=lane(gs.sched, 0), eligible=lane(gs.eligible, False))


def shard_state(state: SimState, rank: int, S: int) -> SimState:
    """Rank ``rank``'s slice of a state in the padded shard layout, with
    the empty pool lanes of the sharded step (``fastmesh.py:985-986``)."""
    part = lambda x: x[rank * S:(rank + 1) * S].clone()
    return dataclasses.replace(
        state, **{name: part(getattr(state, name)) for name in LANES},
        vax_pool=torch.zeros(0, dtype=torch.int32),
        vax_pool_size=torch.zeros((), dtype=torch.int32))


def _to(state: SimState, device) -> SimState:
    return dataclasses.replace(state, **{
        name: getattr(state, name).to(device)
        for name in (*LANES, "vax_pool", "vax_pool_size")})


def gather_state(state: SimState, group) -> SimState:
    """Every rank's lanes in the padded shard layout, on the host (a
    collective: every rank calls it)."""
    def whole(x):
        g = group.all_gather(x.to(torch.int8) if x.dtype == torch.bool else x)
        return g.reshape(-1).cpu().to(x.dtype)

    return dataclasses.replace(
        state, **{name: whole(getattr(state, name)) for name in LANES},
        vax_pool=torch.zeros(0, dtype=torch.int32),
        vax_pool_size=torch.zeros((), dtype=torch.int32))


def _cut(chunks, max_steps):
    """The chunks' outputs joined, cut to ``max_steps`` and after the first
    step with no citizen exposed, infected or susceptible."""
    out = StepOutput(*(np.concatenate(xs, axis=0)[:max_steps]
                       for xs in zip(*chunks)))
    alive = out.seirv[:, :3].sum(axis=1) > 0
    if not alive.all():
        end = int(np.argmin(alive)) + 1
        out = StepOutput(*(x[:end] for x in out))
    return out


def run_rank(group, params, cfg, start: int, gather_every: int, sw, state,
             *, callback=None, timing=None):
    """One rank's chunk loop on its shard ``sw`` (:func:`.partition.shard`)
    and its slice ``state`` (:func:`shard_state`), from hour ``start``
    until the epidemic ends
    (S + E + I = 0 after a chunk) or ``cfg.max_steps``.  Every
    ``gather_every`` chunks (0: never) and at the end the state is
    gathered in the padded shard layout.  On rank 0, ``callback(steps,
    out, state)`` runs after each chunk, ``state`` being the gathered
    state or None, and ``timing`` accumulates seconds by category.
    Returns ``(gathered final state, outputs)`` on rank 0, None
    elsewhere."""
    tm = timing if timing is not None else {}
    t0 = time.perf_counter()
    state = _to(state, group.device)
    chunk = make_shard_chunk_runner(sw, cfg, group)
    tm["shard upload"] = time.perf_counter() - t0
    tm.setdefault("dispatch", 0.0)
    tm.setdefault("callback", 0.0)
    chunks, steps, n_chunks = [], start, 0
    while steps < cfg.max_steps:
        t0 = time.perf_counter()
        state, out = chunk(params, state)
        tm["dispatch"] += time.perf_counter() - t0
        chunks.append(out)
        steps += cfg.chunk_size
        n_chunks += 1
        whole = (gather_state(state, group)
                 if gather_every and n_chunks % gather_every == 0 else None)
        if callback is not None:
            t0 = time.perf_counter()
            callback(steps, out, whole)
            tm["callback"] += time.perf_counter() - t0
        if not out.seirv[-1, :3].sum() > 0:
            break
    final = gather_state(state, group)
    return (final, _cut(chunks, cfg.max_steps)) if group.rank == 0 else None


def rank_args(sw: ShardedWorld, state: SimState) -> list:
    """Each rank's (shard, state slice), for :func:`run_rank`."""
    return [(shard(sw, r), shard_state(state, r, sw.shard_size))
            for r in range(sw.n_dev)]


def run_fast_sharded(world, params, cfg, devices: int, *, seed=0,
                     starting_infected=10, device="cuda", state=None,
                     callback=None):
    """Partition ``world`` over ``devices`` ranks and run until the
    epidemic ends or ``cfg.max_steps`` (the JAX package's
    ``run_fast_sharded``, a rank count in place of the mesh).  ``state``:
    an initial state in the padded shard layout (default
    :func:`init_sharded_state`).  Returns ``(final state in the padded
    shard layout, the ShardedWorld, outputs)``."""
    require_fast_path(cfg, "fast sharded engine")
    sw = partition_world(world, devices)
    if state is None:
        state = init_sharded_state(world, sw, seed=seed,
                                   starting_infected=starting_infected)
    final, outputs = launch(
        run_rank, devices, device=device, args=(params, cfg, 0, 0),
        rank_args=rank_args(sw, state),
        rank0_kwargs=dict(callback=callback))
    return final, sw, outputs

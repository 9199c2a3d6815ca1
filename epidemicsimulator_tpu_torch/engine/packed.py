"""Packed-replica ensembles: R parameter replicates stepped as ONE world.

The port's copy of ``epidemicsimulator_tpu/engine/packed.py``.  R disjoint
copies of a base world are packed into one World (buildings, OAs and
rooms offset per replica, so no mixing group crosses replicas) and one
pass of the fused step formulation steps them all:

* each replica is padded to a whole number of ``block_rows * 128`` lanes
  (pad citizens are singleton households in a pad OA of their own, with
  status 5, outside every census, draw and mask), so every tile of kernel
  B1 belongs to one replica;
* the swept disease parameters (every DiseaseParams field the step reads)
  and the per-replica intervention state reach B1 as the rows of two small
  device tables (its ensemble mode), and the work, bus and vaccination
  stages as (R, 1) columns broadcast over the (R, stride) view of a lane;
* B1 sums the per-replica census; reading it, an (R, 8) table, is the
  step's one device read, and it decides which sides run and the
  interventions of every replica on the host;
* the work side is the sorted formulation: the gates go into work order
  and the hits back by the static ranks ``wpos`` and ``work_perm``
  (``ops/runsums.py::permute_by_sort``; the JAX package sorts each
  replica's row by its row-relative ranks, with the same values),
  and kernel B2 takes the building and room totals; the bus side draws
  each rider's exposure from its own replica's chance;
* the exact-k vaccination picks, in every replica that has started, the
  k lowest hash scores of its pool, by one bisection over all rows.

Draws hash global lane ids, so the layout of :func:`pack_replicas` fixes
every stream: it gives the JAX package's lanes exactly.  A runner over
replicas ``[r * R_l, (r + 1) * R_l)`` of a larger packing (the
replica-sharded ensemble, ``parallel/ensemble_mesh.py``) passes that
packing's ids of its first lane and first rider, ``gid0`` and
``rider_gid0``, so its draws are the larger packing's.  Replicates are
independent simulations; a replica's trajectory has the law of a solo run
(its streams differ, as with any reseeding).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import (
    MASK_NONE,
    STATUS_EXPOSED,
    STATUS_INFECTED,
    STATUS_SUSCEPTIBLE,
    STATUS_VACCINATED,
    Params,
    SimConfig,
    require_fast_path,
)
from ..ops import maths, scans, segments, threefry
from ..ops.citizen import CITIZEN_TILE, make_citizen_statics
from ..ops.citizen import citizen_phase
from ..ops.hashrng import hash_bits, hash_uniform
from ..ops.hashrng import M32
from ..ops.runsums import permute_by_sort
from ..ops.select import bisect_threshold_rows
from ..runtime import resolve_device
from ..world.schema import World, make_world
from .ensemble import stack_params
from .fastpath import mask_active, next_mask_status

LANES = 128


@dataclasses.dataclass(frozen=True)
class PackedEnsemble:
    """One world holding R block-aligned replicas, and the swept
    parameters as (R,) numpy rows."""

    world: World
    chance: np.ndarray              # float32 (R,)
    exposed_time: np.ndarray        # int32 (R,)
    infected_time: np.ndarray       # int32 (R,)
    mask_effectiveness: np.ndarray  # float32 (R,)
    vaccination_rate: np.ndarray    # int32 (R,)
    n_replicas: int
    rep_size: int
    #: padded lanes per replica, a multiple of block_rows * 128
    rep_stride: int = 0
    block_rows: int = 128

    @property
    def blocks_per_rep(self) -> int:
        return self.rep_stride // (self.block_rows * LANES)


@dataclasses.dataclass(frozen=True)
class PackedState:
    """The lanes (N,) on the run's device; the per-replica intervention
    state as (R,) numpy rows, which the host steers."""

    status: torch.Tensor     # int8; pad lanes hold 5
    timer: torch.Tensor      # int32
    sched: torch.Tensor      # int8, the schedule bits (engine/state.py)
    eligible: torch.Tensor   # bool
    hour: int
    lockdown: np.ndarray             # bool (R,)
    mask_status: np.ndarray          # int8 (R,)
    vaccination_started: np.ndarray  # bool (R,)
    rng_key: tuple


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pack_replicas(base: World, param_list: list[Params], *,
                  block_rows: int = 128) -> PackedEnsemble:
    """Tile ``base`` into R replicas padded to ``block_rows * 128``-lane
    boundaries, with numpy lanes, and collect the swept parameters as
    (R,) rows.  ``block_rows`` must be a multiple of 16, so that every
    tile of B1 (CITIZEN_TILE citizens) lies inside one replica.

    Pad citizens are inert: singleton households in a per-replica pad OA
    (so they sort to the replica's tail), work == home, no transport, not
    mask-compliant; :func:`init_packed_state` gives them status 5.
    Replicas stay contiguous equal-stride blocks in citizen, work and
    rider order."""
    if block_rows <= 0 or (block_rows * LANES) % CITIZEN_TILE:
        raise ValueError(
            f"block_rows must be a positive multiple of "
            f"{CITIZEN_TILE // LANES}, so that a tile of {CITIZEN_TILE} "
            f"citizens lies inside one replica; got {block_rows}")
    R = len(param_list)
    n = base.n_citizens
    B, M, O = base.n_buildings, base.n_rooms, base.n_output_areas
    block_elems = block_rows * LANES
    stride = -(-max(n, 1) // block_elems) * block_elems
    n_pad = stride - n
    Bp, Op = B + n_pad, O + 1
    lane = lambda name: _host(getattr(base, name))

    def padded(x, padval):
        return np.concatenate([x, np.full(n_pad, padval, x.dtype)])

    def tiled(name, padval):
        return np.tile(padded(lane(name), padval), R)

    rep = np.repeat(np.arange(R, dtype=np.int64), stride)
    pad_b = B + np.arange(n_pad, dtype=np.int64)
    hb = np.concatenate([lane("home_building").astype(np.int64), pad_b])
    wb = np.concatenate([lane("work_building").astype(np.int64), pad_b])
    ho = padded(lane("home_oa").astype(np.int64), O)
    wo = padded(lane("work_oa").astype(np.int64), O)
    # room sentinel: base M -> packed R * M (pads have no room either)
    rm = lane("room").astype(np.int64)
    rm_t = np.tile(padded(np.where(rm == M, -1, rm), -1), R)
    world = make_world(
        age=tiled("age", 0),
        occupation=tiled("occupation", 0),
        home_building=rep * Bp + np.tile(hb, R),
        work_building=rep * Bp + np.tile(wb, R),
        home_oa=rep * Op + np.tile(ho, R),
        work_oa=rep * Op + np.tile(wo, R),
        room=np.where(rm_t < 0, R * M, rep * M + rm_t),
        is_school_work=tiled("is_school_work", False),
        uses_transport=tiled("uses_transport", False),
        mask_compliant=tiled("mask_compliant", False),
        work_start=tiled("work_start", 9),
        work_end=tiled("work_end", 17),
        n_buildings=R * Bp,
        n_rooms=R * M,
        n_output_areas=R * Op,
    )
    # make_world must not have reordered citizens across replica blocks or
    # moved pads off the tail: the packed keys are already sorted
    # replica-major with the pad OA last inside each replica
    if world.n_citizens != R * stride or not np.array_equal(
            np.asarray(world.home_oa, np.int64), rep * Op + np.tile(ho, R)):
        raise AssertionError(
            "pack_replicas: canonicalisation broke the replica-major layout")

    ds = [p.disease for p in param_list]
    f32 = lambda name: np.array([getattr(d, name) for d in ds], np.float32)
    i32 = lambda name: np.array([int(getattr(d, name)) for d in ds], np.int32)
    return PackedEnsemble(
        world=world,
        chance=f32("exposure_chance"),
        exposed_time=i32("exposed_time"),
        infected_time=i32("infected_time"),
        mask_effectiveness=f32("mask_effectiveness"),
        vaccination_rate=i32("vaccination_rate"),
        n_replicas=R,
        rep_size=n,
        rep_stride=stride,
        block_rows=block_rows,
    )


def init_packed_state(pe: PackedEnsemble, *, seed: int = 0,
                      starting_infected: int = 10,
                      device="cuda") -> PackedState:
    """Seed ``starting_infected`` infections independently per replica,
    drawn with numpy as the JAX package draws them."""
    dev = resolve_device(device)
    R, n, stride = pe.n_replicas, pe.rep_size, pe.rep_stride
    rng = np.random.default_rng(seed)
    status = np.zeros(R * stride, np.int8)
    for r in range(R):
        status[r * stride + n:(r + 1) * stride] = 5  # inert pad lanes
        idx = rng.choice(n, size=starting_infected, replace=False)
        status[r * stride + idx] = STATUS_INFECTED
    N = R * stride
    return PackedState(
        status=torch.from_numpy(status).to(dev),
        timer=torch.zeros(N, dtype=torch.int32, device=dev),
        sched=torch.zeros(N, dtype=torch.int8, device=dev),
        eligible=torch.zeros(N, dtype=torch.bool, device=dev),
        hour=0,
        lockdown=np.zeros(R, bool),
        mask_status=np.full(R, MASK_NONE, np.int8),
        vaccination_started=np.zeros(R, bool),
        rng_key=threefry.key(seed),
    )


def derive_step_rng(base_key, hours):
    """Per-step random material for the given hours, on the host: for each,
    ``(k_bus, k_b, seed_h, seed_w, seed_vax)`` with the three seeds as u32
    ints, the streams of the JAX package's ``derive_step_rng``."""
    out = []
    for h in hours:
        k_bus, k_h, k_w, k_b, k_vax = threefry.split(
            threefry.fold_in(base_key, int(h)), 5)
        out.append((k_bus, k_b, threefry.bits(k_h), threefry.bits(k_w),
                    threefry.bits(k_vax)))
    return out


def _thresholds(th, R):
    """Thresholds (shared floats or (R,) rows) as four float32 (R,) rows."""
    names = ("lockdown", "vaccination", "mask_public_transport",
             "mask_everywhere")
    return {name: np.broadcast_to(np.asarray(getattr(th, name), np.float32),
                                  (R,)) for name in names}


class _Rows:
    """Device copies of small host rows, uploaded only when they change."""

    def __init__(self, device):
        self.device = device
        self.rows = {}

    def __call__(self, name, arr):
        key = arr.tobytes()
        hit = self.rows.get(name)
        if hit is None or hit[0] != key:
            hit = self.rows[name] = (
                key, torch.from_numpy(np.array(arr)).to(self.device))
        return hit[1]


@dataclasses.dataclass(frozen=True)
class PackedTables:
    """A packed world's static step inputs on the run's device, built once
    per runner."""

    statics: tuple
    wpos: torch.Tensor         # int64, work-order rank of each citizen
    work_perm: torch.Tensor    # int64, citizen rank of each work-order slot
    rider_perm: torch.Tensor   # int64
    ids: torch.Tensor          # int64 u32 (gid0 + lane), the hash counters
    gid0: int                  # the id of lane 0 (0 for a whole packing)
    rider_gid0: int            # the id of rider 0
    rep_f32s: torch.Tensor     # (R, 2) float32 [chance, 1 - mask eff.]
    rate: torch.Tensor         # (R,) int32 vaccination rate
    rows: _Rows


def make_packed_tables(pe: PackedEnsemble, gid0: int = 0,
                       rider_gid0: int = 0) -> PackedTables:
    """From an ensemble whose world lanes are tensors on the run's device.
    ``gid0`` and ``rider_gid0``: the global ids of this packing's first
    lane and first rider in a larger packing whose replicas
    ``[r * R_l, (r + 1) * R_l)`` it holds (0 for a whole packing)."""
    world = pe.world
    dev = world.work_perm.device
    f32 = np.float32
    rep_f32s = np.stack([pe.chance.astype(f32),
                         f32(1.0) - pe.mask_effectiveness.astype(f32)], 1)
    iota = torch.arange(world.n_citizens, dtype=torch.int64, device=dev)
    return PackedTables(
        statics=make_citizen_statics(world),
        wpos=world.wpos.long(),
        work_perm=world.work_perm.long(),
        rider_perm=world.rider_perm.long(),
        ids=(iota + gid0) & M32,
        gid0=int(gid0),
        rider_gid0=int(rider_gid0),
        rep_f32s=torch.from_numpy(rep_f32s).to(dev),
        rate=torch.from_numpy(pe.vaccination_rate.astype(np.int32)).to(dev),
        rows=_Rows(dev),
    )


def _work_side(pe, tables, cfg, gates, sched, ms, seed_w):
    """Work exposures as a citizen-order hit lane (building.rs:278-280;
    school rooms per building.rs:494-522)."""
    world = pe.world
    R = pe.n_replicas
    g_ws = permute_by_sort(tables.wpos, gates, bits=5)
    n_w, room = scans.run_totals_fused(
        g_ws & 1,
        [(world.ws_wb_start_mask, world.ws_wb_end_mask),
         (world.ws_room_start_mask, world.ws_room_end_mask)],
    )
    draws = torch.where(world.ws_is_school, room, (n_w > 0).to(torch.int32))
    at_work_ws = (sched & 8) != 0
    rows = lambda x: x.view(R, -1)
    active = mask_active(ms, rows(world.ws_mask_compliant),
                          rows((sched & 16) != 0), cfg.reference_mask_semantics)
    chance, scale = tables.rep_f32s[:, :1], tables.rep_f32s[:, 1:]
    p_ws = (chance * torch.where(active, scale, 1.0)).view(-1)
    cur_oa = torch.where(at_work_ws, world.ws_work_oa, world.ws_home_oa)
    n_eff = maths.truncate_u8(n_w) if cfg.reference_u8_truncation else n_w
    q_single = maths.binomial_at_least_one(p_ws, n_eff)
    q = torch.where((cur_oa == world.ws_work_oa) & world.ws_work_neq_home,
                    maths.binomial_at_least_one(q_single, draws), 0.0)
    hit_ws = ((g_ws & 2) != 0) & (hash_uniform(seed_w, tables.ids) < q)
    return permute_by_sort(tables.work_perm, hit_ws.to(torch.int8),
                           bits=1).bool()


def _bus_side(pe, tables, cfg, gates, ms, k_bus, k_b):
    """Bus exposures: each rider draws with its own replica's chance."""
    world = pe.world
    R = pe.n_replicas
    R_riders = world.n_riders
    r_base = R_riders // R
    # pack_replicas gives every replica the same riders; any other world
    # would misalign every per-replica rider row
    if R_riders != R * r_base:
        raise ValueError(f"packed rider count {R_riders} is not a multiple "
                         f"of n_replicas={R}")
    pk = gates[tables.rider_perm]
    rb_on = (pk & 8) != 0
    compliant = world.rider_mask_compliant
    active = mask_active(ms, compliant.view(R, -1), rb_on.view(R, -1),
                          cfg.reference_mask_semantics)
    chance, scale = tables.rep_f32s[:, :1], tables.rep_f32s[:, 1:]
    rb_chance = (chance * torch.where(active, scale, 1.0)).view(-1)
    kw = dict(rb_chance=rb_chance)
    if cfg.id_keyed_ensemble_rng:
        # ties and draws hash global rider ids (segments.bus_hits)
        rider_ids = (torch.arange(R_riders, dtype=torch.int64, device=pk.device)
                     + tables.rider_gid0) & M32
        kw.update(tie_bits=hash_bits(threefry.bits(k_bus), rider_ids),
                  draw_seed=threefry.bits(k_b), rider_gid0=tables.rider_gid0)
    return segments.bus_hits(
        k_bus, k_b, rb_on, (pk & 16) != 0, (pk & 2) != 0, compliant,
        world.rider_route, tables.rider_perm, cfg.bus_capacity,
        lambda c, v, chance: chance, pe.world.n_citizens, **kw,
    )[0]


def _vaccinate(pe, tables, status, eligible, started, seed_vax, faithful):
    """Exact-k per replica (simulator.rs:524-553): in each started replica
    the k lowest fresh hash scores of its pool, ties at the threshold
    taken in lane order."""
    R = pe.n_replicas
    scores = hash_bits(seed_vax, tables.ids).view(R, -1)
    elig2 = eligible.view(R, -1)
    k = torch.where(started, torch.minimum(tables.rate, elig2.sum(
        1, dtype=torch.int32)), 0)
    tau = bisect_threshold_rows(scores, elig2, k)[:, None]
    below = elig2 & (scores < tau)
    at = elig2 & (scores == tau)
    allowed = k - below.sum(1, dtype=torch.int32)
    at_rank = torch.cumsum(at, 1, dtype=torch.int32)
    chosen = below | (at & (at_rank <= allowed[:, None]))
    chosen = (chosen & (started & (k > 0))[:, None]).view(-1)
    new = torch.where(chosen, STATUS_VACCINATED, status)
    if not faithful:
        new = torch.where(chosen & (status != STATUS_SUSCEPTIBLE), status, new)
        eligible = eligible & ~chosen
    return new, eligible


def packed_step(pe: PackedEnsemble, th, cfg: SimConfig, state: PackedState,
                tables: PackedTables | None = None, rng=None):
    """One hour for all R replicas; returns ``(new_state, seirv)``, the
    (R, 5) int32 census after exposures and before vaccination on the
    device.  ``th`` holds the thresholds, shared floats or (R,) rows.
    ``rng`` is this step's :func:`derive_step_rng` row, derived here when
    not given.  ``pe.world`` holds tensors on the state's device;
    ``tables`` are its :func:`make_packed_tables`."""
    world = pe.world
    R, n = pe.n_replicas, pe.rep_size
    if tables is None:
        tables = make_packed_tables(pe)
    hour = state.hour + 1
    if rng is None:
        rng = derive_step_rng(state.rng_key, [hour])[0]
    k_bus, k_b, seed_h, seed_w, seed_vax = rng
    ms = tables.rows("mask_status", state.mask_status.astype(np.int8)).view(R, 1)
    rep_ints = np.stack([(~state.lockdown).astype(np.int32),
                         state.mask_status.astype(np.int32),
                         pe.exposed_time.astype(np.int32),
                         pe.infected_time.astype(np.int32)], 1)

    status, timer, sched, gates, rep_totals = citizen_phase(
        tables.statics, state.status, state.timer, state.sched,
        h24=hour % 24, seed=seed_h, K=world.max_household_size,
        ref_mask_sem=cfg.reference_mask_semantics,
        u8_trunc=cfg.reference_u8_truncation,
        rep_ints=tables.rows("rep_ints", rep_ints),
        rep_f32s=tables.rep_f32s, tiles_per_rep=pe.rep_stride // CITIZEN_TILE,
        gid0=tables.gid0,
    )
    census = rep_totals.cpu().numpy()  # (R, 8), the step's one device read
    hit_home = (gates & 4) != 0
    hit_work = hit_bus = None
    if census[:, 5].sum() > 0:
        hit_work = _work_side(pe, tables, cfg, gates, sched, ms, seed_w)
    if census[:, 6].sum() > 0 and world.n_riders > 0:
        hit_bus = _bus_side(pe, tables, cfg, gates, ms, k_bus, k_b)

    if hit_work is None and hit_bus is None:
        # no side ran: the home hits are all, and status and timer hold them
        newly, n_new = hit_home, rep_totals[:, 7]
    else:
        # re-applying the home hits is idempotent
        newly = hit_home
        for hits in (hit_work, hit_bus):
            if hits is not None:
                newly = newly | hits
        status = torch.where(newly, STATUS_EXPOSED, status)
        timer = torch.where(newly, 0, timer)
        n_new = newly.view(R, -1).sum(1, dtype=torch.int32)
    eligible = state.eligible
    if not cfg.faithful_vaccine_bugs:
        eligible = eligible & ~newly
    elif hit_bus is not None:
        from_bus = hit_bus & ~hit_home
        if hit_work is not None:
            from_bus = from_bus & ~hit_work
        eligible = eligible & ~from_bus
    seirv = rep_totals[:, :5].clone()
    seirv[:, STATUS_SUSCEPTIBLE] -= n_new
    seirv[:, STATUS_EXPOSED] += n_new

    # interventions per replica (interventions.rs:110-184), in float32 on
    # the host; the infected fraction divides by the replica's real size
    pct = census[:, STATUS_INFECTED].astype(np.float32) / np.float32(n)
    t = _thresholds(th, R)
    lockdown = (t["lockdown"] >= 0) & (t["lockdown"] < pct)
    newly_started = (~state.vaccination_started & (t["vaccination"] >= 0)
                     & (t["vaccination"] < pct))
    started = state.vaccination_started | newly_started
    if newly_started.any():
        ns = tables.rows("newly_started", newly_started).view(R, 1)
        eligible = torch.where(ns, (status == STATUS_SUSCEPTIBLE).view(R, -1),
                               eligible.view(R, -1)).view(-1)
    ms_next = next_mask_status(state.mask_status, pct,
                                t["mask_public_transport"], t["mask_everywhere"])
    # the JAX package gates this on any eligible lane; a replica has
    # eligible lanes only once it has started, and with none every k is 0,
    # so gating on a started replica gives the same values
    if started.any():
        status, eligible = _vaccinate(
            pe, tables, status, eligible, tables.rows("started", started),
            seed_vax, cfg.faithful_vaccine_bugs)

    new_state = PackedState(
        status=status, timer=timer, sched=sched, eligible=eligible,
        hour=hour, lockdown=lockdown, mask_status=ms_next,
        vaccination_started=started, rng_key=state.rng_key,
    )
    return new_state, seirv


def make_packed_runner(pe: PackedEnsemble, cfg: SimConfig, device="cuda",
                       gid0: int = 0, rider_gid0: int = 0):
    """``chunk(th, state) -> (state, seirv)`` stepping ``cfg.chunk_size``
    hours, seirv (chunk, R, 5) int32 on the run's device.  The world goes
    to ``device`` and its tables are built once, here
    (:func:`make_packed_tables`, with ``gid0`` and ``rider_gid0``)."""
    require_fast_path(cfg, "packed ensemble engine")
    dev = resolve_device(device)
    pe_d = dataclasses.replace(pe, world=pe.world.to(dev))
    tables = make_packed_tables(pe_d, gid0, rider_gid0)

    def chunk(th, state):
        hours = range(state.hour + 1, state.hour + 1 + cfg.chunk_size)
        rows = []
        for rng in derive_step_rng(state.rng_key, hours):
            state, seirv = packed_step(pe_d, th, cfg, state, tables, rng)
            rows.append(seirv)
        return state, torch.stack(rows)

    return chunk


def ensemble_done(seirv_row, early_exit: str = "sei"):
    """Whether every replica's run is over, from one (R, 5) census row.

    ``early_exit="sei"`` (default) is the reference's ``disease_exists =
    S+E+I > 0`` (statistics.rs:289-291): a run ends only once vaccination
    and recovery have emptied all three pools.  ``"ei"`` stops as soon as
    no exposure can happen again (E+I == 0), a benchmarking shortcut.
    """
    if early_exit == "sei":
        return not bool((seirv_row[:, :3].sum(axis=1) > 0).any())
    if early_exit == "ei":
        return not bool((seirv_row[:, 1:3].sum(axis=1) > 0).any())
    raise ValueError(f"early_exit must be 'sei' or 'ei', got {early_exit!r}")


def run_packed_ensemble(base: World, param_list: list[Params], cfg: SimConfig,
                        *, seed: int = 0, block_rows: int = 128,
                        early_exit: str = "sei", device="cuda"):
    """Pack, run to ``cfg.max_steps`` (stopping after the chunk in which
    :func:`ensemble_done` holds) and return the (R, T, 5) SEIRV series as
    numpy.  Each replica keeps its own thresholds."""
    require_fast_path(cfg, "packed ensemble engine")
    pe = pack_replicas(base, param_list, block_rows=block_rows)
    state = init_packed_state(pe, seed=seed,
                              starting_infected=cfg.starting_infected,
                              device=device)
    th = stack_params(param_list).thresholds
    runner = make_packed_runner(pe, cfg, device=device)
    chunks = []
    steps = 0
    while steps < cfg.max_steps:
        state, seirv = runner(th, state)
        seirv = seirv.cpu().numpy()  # (chunk, R, 5)
        chunks.append(seirv)
        steps += cfg.chunk_size
        if ensemble_done(seirv[-1], early_exit):
            break
    out = np.concatenate(chunks, axis=0)[:cfg.max_steps]
    return np.transpose(out, (1, 0, 2))

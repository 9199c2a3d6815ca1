"""Host-side world partitioning for the sharded fast path.

The port's copy of ``epidemicsimulator_tpu/parallel/partition.py``:
numpy on the host, as there.  ``ShardedWorld`` is a plain frozen
dataclass (the JAX package registers it as a pytree); :func:`shard`
takes one rank's row of it.


Citizens are split across devices in household-aligned, home-OA-contiguous
blocks (the canonical citizen order is home-building sorted, so a cut at a
household boundary keeps every mixing structure that the single-device fast
path exploits):

* **households** never straddle shards — the shift-window pressure sum is
  fully shard-local, no halo exchange;
* **bus routes** are keyed by the (home_oa, work_oa) pair and riders live on
  their home shard, so the entire per-step bus machinery is shard-local;
* **workplaces/schools** are the only cross-shard mixing: each building is
  owned by the shard hosting its OA, and foreign workers get static *ghost
  slots* in the owner's work order.  Per step, one ``all_to_all`` carries a
  few packed bits per cross-shard worker out (contribution / susceptible /
  hit-at-home / at-work / on-bus) and one hit bit back — agent state never
  migrates, unlike the reference's citizen moves between OA mutexes
  (simulator.rs:199-257).

Everything here is numpy at preprocessing time; the output holds stacked
``(n_dev, ...)`` arrays, whose row r is rank r's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..world.schema import World

#: status value used for padding citizens/slots: outside the 0..4 SEIRV
#: range, so pads are invisible to every census, mask and draw.
PAD_STATUS = 5


@dataclasses.dataclass(frozen=True)
class ShardedWorld:
    """Static per-shard tables.  All arrays lead with the device axis."""

    # --- per-citizen lanes, (n_dev, S) ---
    work_start: Any
    work_end: Any
    uses_transport: Any
    mask_compliant: Any
    hh_pos: Any
    hh_size: Any
    work_neq_home: Any      # bool
    same_oa: Any            # bool, work_oa == home_oa
    home_oa: Any            # int32 (for per-OA stats fallback)
    # --- local work-order sort lanes, (n_dev, L) ---
    sort_rank: Any          # int32: local citizen -> slot, pads -> >= W
    unsort_rank: Any        # int32: slot -> local citizen position
    # --- work slots, (n_dev, W) ---
    slot_active: Any        # bool
    slot_local: Any         # bool: slot filled by a local citizen (vs ghost)
    slot_is_school: Any
    slot_mask_compliant: Any
    slot_same_oa: Any
    slot_ws_index: Any      # int32: the participant's single-device work-
                            # order position (world.wpos); keys the work
                            # draw so sharded == single-device bitwise
    wb_start: Any           # bool, building-run boundaries among slots
    wb_end: Any
    room_start: Any
    room_end: Any
    # --- ghost routing ---
    out_ghost_src: Any      # int32 (n_dev, n_dev, G): local citizen idx (pad S)
    recv_slot_pos: Any      # int32 (n_dev, n_dev, G): slot position (pad W)
    # --- riders, (n_dev, R) ---
    rider_local: Any        # int32 local citizen idx (pad S)
    rider_route: Any        # int32 dense route id (pad -1)
    rider_compliant: Any
    # --- per-OA ranges, (n_dev, n_oa) ---
    oa_lo: Any
    oa_hi: Any
    ws_oa_lo: Any           # slot-space ranges for work attribution
    ws_oa_hi: Any
    # --- statics ---
    n_dev: int
    shard_size: int
    n_slots: int
    sort_len: int
    n_ghost: int
    n_riders: int
    n_output_areas: int
    max_household_size: int
    n_citizens: int

    #: (n_dev, S) int32 global citizen id per padded local position (pad -1);
    #: host-side mapping for state scatter/gather, not used on device.
    global_id: Any = None
    #: Static slot lanes for the sortless sharded work branch, (n_dev, W):
    #: the occupying participant's schedule (work start/end hour,
    #: uses_transport) and work OA.  The slot's at_work/on_bus state
    #: follows the same _movement recurrence as its occupant (occupancy
    #: is static), so the sharded engine can carry slot-space schedule
    #: lanes and skip the forward slot sort on contributor-light moving
    #: hours.  None on partitions built before the lanes existed.
    slot_ws: Any = None
    slot_we: Any = None
    slot_uses: Any = None
    slot_oa: Any = None
    #: (n_dev, S) int32 rider-compaction rank per shard: local rider
    #: citizens -> their rider_local slot, everyone else fills the
    #: remaining ranks (a complete permutation of [0, S) per shard).  The
    #: bus side moves its input bits into rider order with ONE shard-local
    #: key-sort instead of an R-sized gather (the fastpath rpos trick,
    #: world/schema.py) — pad rider slots receive non-rider citizens whose
    #: on_bus bit is always 0, so they sort to the invalid tail and the
    #: hit set is bitwise the gather formulation's.  None on partitions
    #: built before the lane existed (gather fallback).
    rpos_local: Any = None


def partition_world(world: World, n_dev: int,
                    stats: dict | None = None) -> ShardedWorld:
    """Split a canonical world into household-aligned shards + ghost tables.

    ``stats``: optional dict filled with partition diagnostics (shard
    balance, cross-shard worker counts, max pair ghost count G) for the
    comm-volume model in docs/PERF.md."""
    if isinstance(world.age, torch.Tensor):
        world = world.to("cpu")  # numpy reads CPU tensors in place
    n = world.n_citizens
    hb = np.asarray(world.home_building, np.int64)
    assert (np.diff(hb) >= 0).all(), "citizens must be home-building sorted"

    # household starts
    hh_start = np.r_[True, hb[1:] != hb[:-1]]
    starts = np.flatnonzero(hh_start)

    # household-aligned cuts near i*n/n_dev
    cuts = [0]
    for d in range(1, n_dev):
        target = d * n // n_dev
        j = int(np.searchsorted(starts, target))
        cuts.append(int(starts[min(j, len(starts) - 1)]))
    cuts.append(n)
    cuts = np.asarray(cuts)
    assert (np.diff(cuts) > 0).all(), "empty shard; fewer devices or more citizens"
    sizes = np.diff(cuts)
    S = int(sizes.max())

    shard_of = np.repeat(np.arange(n_dev), sizes)  # global citizen -> shard
    local_of = np.arange(n) - cuts[shard_of]

    # building -> OA -> owner shard (OA owned by the shard of its first
    # home citizen; buildings are OA-major so this is well-defined)
    ho = np.asarray(world.home_oa, np.int64)
    wo = np.asarray(world.work_oa, np.int64)
    n_oa = world.n_output_areas
    oa_owner = np.zeros(n_oa, np.int64)
    first_seen = np.full(n_oa, n, np.int64)
    np.minimum.at(first_seen, ho, np.arange(n))  # first citizen index per OA
    seen = first_seen < n
    oa_owner[seen] = shard_of[first_seen[seen]]
    b_oa = np.zeros(world.n_buildings, np.int64)
    wb = np.asarray(world.work_building, np.int64)
    b_oa[wb] = wo
    b_oa[hb] = ho
    b_owner = oa_owner[b_oa]

    # ---- work-side participants: employed away from home -------------
    wneq = wb != hb
    part = np.flatnonzero(wneq)
    owner = b_owner[wb[part]]
    rm = np.asarray(world.room, np.int64)

    # slots per owner shard, sorted by (building, room)
    order = np.lexsort((rm[part], wb[part], owner))
    part_o = part[order]
    owner_o = owner[order]
    counts_w = np.bincount(owner_o, minlength=n_dev)
    W = int(counts_w.max()) if len(part) else 1
    slot_of = np.empty(len(part_o), np.int64)  # slot index within owner
    off = np.r_[0, np.cumsum(counts_w)[:-1]]
    slot_of = np.arange(len(part_o)) - off[owner_o]

    # per-shard slot lanes
    def slot_lane(vals, pad, dtype):
        out = np.full((n_dev, W), pad, dtype)
        out[owner_o, slot_of] = vals
        return out

    is_school = np.asarray(world.is_school_work)
    compliant = np.asarray(world.mask_compliant)
    slot_active = slot_lane(np.ones(len(part_o), bool), False, np.bool_)
    slot_is_school = slot_lane(is_school[part_o], False, np.bool_)
    slot_compliant = slot_lane(compliant[part_o], False, np.bool_)
    slot_same = slot_lane((wo == ho)[part_o], False, np.bool_)
    slot_ws_index = slot_lane(
        np.asarray(world.wpos, np.int64)[part_o], n, np.int64
    )
    slot_wb = slot_lane(wb[part_o], -1, np.int64)
    slot_pair = slot_lane(
        wb[part_o] * (world.n_rooms + 2) + rm[part_o], -1, np.int64
    )
    slot_oa = slot_lane(wo[part_o], n_oa, np.int64)
    # occupant schedule statics for the sortless work branch (pads get the
    # default 9-17 no-transport schedule; masked by slot_active anyway)
    ws_all = np.asarray(world.work_start, np.int64)
    we_all = np.asarray(world.work_end, np.int64)
    uses_all = np.asarray(world.uses_transport, np.bool_)
    slot_ws_t = slot_lane(ws_all[part_o], 9, np.int8)
    slot_we_t = slot_lane(we_all[part_o], 17, np.int8)
    slot_uses_t = slot_lane(uses_all[part_o], False, np.bool_)

    def run_masks(keys):  # per-row runs; pads (-1) isolated by uniqueness
        start = np.ones_like(keys, bool)
        start[:, 1:] = keys[:, 1:] != keys[:, :-1]
        end = np.ones_like(keys, bool)
        end[:, :-1] = keys[:, 1:] != keys[:, :-1]
        return start, end

    wb_s, wb_e = run_masks(slot_wb)
    rm_s, rm_e = run_masks(slot_pair)

    # slot-space per-OA ranges (slots are OA-major: buildings are OA-major)
    ws_oa_lo = np.zeros((n_dev, n_oa), np.int64)
    ws_oa_hi = np.zeros((n_dev, n_oa), np.int64)
    for d in range(n_dev):
        oas = slot_oa[d]
        cnt = np.bincount(oas[oas < n_oa], minlength=n_oa)
        hi = np.cumsum(cnt)
        ws_oa_hi[d] = hi
        ws_oa_lo[d] = hi - cnt

    # local-vs-ghost split.  The local sort rank must be a COMPLETE
    # permutation of [0, L) per shard: local participants take their slot
    # rank; every other rank (ghost slots' + the dump zone) is distributed
    # over the remaining local positions.  Ghost slots therefore hold
    # arbitrary local garbage after the sort — the ghost scatter overwrites
    # them, and inactive slots are masked by slot_active.
    is_local = owner_o == shard_of[part_o]
    slot_local = slot_lane(is_local, False, np.bool_)
    L = max(S, W)
    sort_rank = np.full((n_dev, L), -1, np.int64)
    loc = np.flatnonzero(is_local)
    sort_rank[owner_o[loc], local_of[part_o[loc]]] = slot_of[loc]
    for d in range(n_dev):
        row = sort_rank[d]
        free_pos = row < 0
        used = row[~free_pos]
        free_ranks = np.setdiff1d(np.arange(L), used, assume_unique=False)
        row[free_pos] = free_ranks
        sort_rank[d] = row
    # permute_by_sort(sort_rank, x)[r] = x[i : sort_rank[i] == r];
    # the inverse crossing uses unsort = argsort(sort_rank):
    # permute_by_sort(unsort, y)[i] = y[sort_rank[i]].
    unsort_rank = np.argsort(sort_rank, axis=1)

    # ghosts, vectorised per (src, dst) pair
    gh = np.flatnonzero(~is_local)
    g_src = shard_of[part_o[gh]]
    g_dst = owner_o[gh]
    pair_counts = np.zeros((n_dev, n_dev), np.int64)
    np.add.at(pair_counts, (g_src, g_dst), 1)
    G = int(pair_counts.max()) if len(gh) else 1
    out_ghost_src = np.full((n_dev, n_dev, G), S, np.int64)  # pad -> S
    recv_slot_pos = np.full((n_dev, n_dev, G), W, np.int64)  # pad -> W
    if len(gh):
        key = g_src * n_dev + g_dst
        ord2 = np.argsort(key, kind="stable")
        ks = key[ord2]
        run_start = np.r_[True, ks[1:] != ks[:-1]]
        seg_first = np.maximum.accumulate(
            np.where(run_start, np.arange(len(ks)), 0)
        )
        sip = np.arange(len(ks)) - seg_first
        gs, gd = g_src[ord2], g_dst[ord2]
        out_ghost_src[gs, gd, sip] = local_of[part_o[gh[ord2]]]
        recv_slot_pos[gd, gs, sip] = slot_of[gh[ord2]]

    # ---- riders (home-shard local) -----------------------------------
    rp = np.asarray(world.rider_perm, np.int64)
    rr = np.asarray(world.rider_route, np.int64)
    rsh = shard_of[rp] if len(rp) else np.zeros(0, np.int64)
    rcnt = np.bincount(rsh, minlength=n_dev)
    R = int(rcnt.max()) if len(rp) else 1
    rider_local = np.full((n_dev, R), S, np.int64)
    rider_route = np.full((n_dev, R), -1, np.int64)
    rider_compliant = np.zeros((n_dev, R), np.bool_)
    if len(rp):
        # stable-order by shard, keep route-major order within each shard
        ord3 = np.argsort(rsh, kind="stable")
        rs = rsh[ord3]
        run_start = np.r_[True, rs[1:] != rs[:-1]]
        seg_first = np.maximum.accumulate(
            np.where(run_start, np.arange(len(rs)), 0)
        )
        rpos = np.arange(len(rs)) - seg_first
        rider_local[rs, rpos] = local_of[rp[ord3]]
        rider_route[rs, rpos] = rr[ord3]
        rider_compliant[rs, rpos] = compliant[rp[ord3]]

    # per-shard rider-compaction rank (see ShardedWorld.rpos_local):
    # local riders take their rider_local slot as rank; every other local
    # position fills the remaining ranks so each row is a complete
    # permutation of [0, S)
    rpos_sh = np.full((n_dev, S), -1, np.int64)
    if len(rp):
        rpos_sh[rs, local_of[rp[ord3]]] = rpos
    for d in range(n_dev):
        row = rpos_sh[d]
        free = row < 0
        free_ranks = np.setdiff1d(np.arange(S), row[~free])
        row[free] = free_ranks
        rpos_sh[d] = row

    # ---- per-citizen lanes, padded ------------------------------------
    def cit_lane(vals, pad, dtype):
        out = np.full((n_dev, S), pad, dtype)
        out[shard_of, local_of] = np.asarray(vals)
        return out

    gid = np.full((n_dev, S), -1, np.int64)
    gid[shard_of, local_of] = np.arange(n)

    # per-OA citizen-order ranges within each shard
    oa_lo = np.zeros((n_dev, n_oa), np.int64)
    oa_hi = np.zeros((n_dev, n_oa), np.int64)
    for d in range(n_dev):
        mine = ho[cuts[d] : cuts[d + 1]]
        cnt = np.bincount(mine, minlength=n_oa)
        hi = np.cumsum(cnt)
        oa_hi[d] = hi
        oa_lo[d] = hi - cnt

    if stats is not None:
        stats.update(
            n_citizens=int(n),
            n_dev=int(n_dev),
            shard_sizes=sizes.tolist(),
            shard_size_padded=int(S),
            imbalance_pct=round(
                100.0 * (S - sizes.min()) / max(1, S), 3
            ),
            n_workers=int(len(part)),
            cross_shard_workers=int(len(gh)),
            cross_shard_pct=round(100.0 * len(gh) / max(1, len(part)), 2),
            ghost_G_max_pair=int(G),
            n_slots=int(W),
            a2a_bytes_per_step_per_dev=int(2 * n_dev * G),
        )
    i32 = lambda x: np.asarray(x, np.int32)
    return ShardedWorld(
        work_start=cit_lane(world.work_start, 9, np.int8),
        work_end=cit_lane(world.work_end, 17, np.int8),
        uses_transport=cit_lane(world.uses_transport, False, np.bool_),
        mask_compliant=cit_lane(world.mask_compliant, False, np.bool_),
        hh_pos=cit_lane(world.hh_pos, 0, np.int16),
        hh_size=cit_lane(world.hh_size, 0, np.int16),
        work_neq_home=cit_lane(wneq, False, np.bool_),
        same_oa=cit_lane(wo == ho, False, np.bool_),
        home_oa=i32(cit_lane(ho, 0, np.int64)),
        sort_rank=i32(sort_rank),
        unsort_rank=i32(unsort_rank),
        slot_active=slot_active,
        slot_local=slot_local,
        slot_is_school=slot_is_school,
        slot_mask_compliant=slot_compliant,
        slot_same_oa=slot_same,
        slot_ws_index=i32(slot_ws_index),
        wb_start=wb_s,
        wb_end=wb_e,
        room_start=rm_s,
        room_end=rm_e,
        out_ghost_src=i32(out_ghost_src),
        recv_slot_pos=i32(recv_slot_pos),
        rider_local=i32(rider_local),
        rider_route=i32(rider_route),
        rider_compliant=rider_compliant,
        oa_lo=i32(oa_lo),
        oa_hi=i32(oa_hi),
        ws_oa_lo=i32(ws_oa_lo),
        ws_oa_hi=i32(ws_oa_hi),
        n_dev=n_dev,
        shard_size=S,
        n_slots=W,
        sort_len=int(L),
        n_ghost=G,
        n_riders=R,
        n_output_areas=n_oa,
        max_household_size=world.max_household_size,
        n_citizens=n,
        global_id=i32(gid),
        rpos_local=i32(rpos_sh),
        slot_ws=slot_ws_t,
        slot_we=slot_we_t,
        slot_uses=slot_uses_t,
        slot_oa=i32(slot_oa),
    )


def shard_state_arrays(sw: ShardedWorld, lanes: dict) -> dict:
    """Scatter (N,) global state lanes into (n_dev, S) stacked arrays."""
    gid = np.asarray(sw.global_id)
    out = {}
    for name, (arr, pad) in lanes.items():
        arr = np.asarray(arr)
        st = np.full((sw.n_dev, sw.shard_size), pad, arr.dtype)
        mask = gid >= 0
        st[mask] = arr[gid[mask]]
        out[name] = st
    return out


def gather_state_arrays(sw: ShardedWorld, stacked: dict) -> dict:
    """Inverse of shard_state_arrays: (n_dev, S) -> (N,) global lanes."""
    gid = np.asarray(sw.global_id)
    mask = gid >= 0
    out = {}
    for name, arr in stacked.items():
        arr = np.asarray(arr)
        glob = np.empty((sw.n_citizens,), arr.dtype)
        glob[gid[mask]] = arr[mask]
        out[name] = glob
    return out


def shard(sw: ShardedWorld, rank: int) -> ShardedWorld:
    """Rank ``rank``'s row of every stacked array of ``sw`` (the statics
    kept): what one rank holds of the partition."""
    return dataclasses.replace(sw, **{
        f.name: np.asarray(getattr(sw, f.name))[rank]
        for f in dataclasses.fields(sw)
        if isinstance(getattr(sw, f.name), np.ndarray)
    })

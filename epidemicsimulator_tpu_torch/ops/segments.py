"""Segment counts and the per-step bus grouping: shuffle each route's
riders, cut them into buses of ``capacity``, and draw each susceptible
rider's exposure.

A plain torch copy of ``count_per_segment``, ``bus_infection_counts``,
``bus_exposure_probability``, ``bus_hits`` and ``bus_hits_sortless`` from
``epidemicsimulator_tpu/ops/segments.py``.  The shuffle is a stable sort
by (route, tie), where non-riding lanes carry route INT32_MAX and ``tie``
is the threefry u32 lane read as SIGNED int32.  torch has no two-key sort,
so both keys ride one int64: the route in the high 32 bits and the tie
with its sign bit flipped (which maps signed order onto unsigned order)
in the low 32.  ``torch.sort(stable=True)`` then keeps lane order among
equal keys, as ``lax.sort`` does.
"""

from __future__ import annotations

import torch

from . import maths, scans, threefry
from .hashrng import M32, hash_uniform
from .runsums import run_totals
from .sparse import block_hierarchy, compact_from_hierarchy

INT32_MAX = 2**31 - 1


def shuffle_order(rk, tie_u32):
    """Stable order by (rk, tie read as signed int32): ``(rk_sorted,
    order)``.  ``rk`` holds int32 values, negative ones too, and
    ``tie_u32`` u32 values, both in int64.  The packed key orders by rk
    first because the low 32 bits, which hold the flipped tie, read as
    unsigned, and an arithmetic shift gives rk back."""
    key_s, order = torch.sort((rk << 32) | (tie_u32 ^ 0x80000000), stable=True)
    return key_s >> 32, order


def count_per_segment(values, segment_ids, num_segments: int):
    """``segment_sum`` with int32 accumulation: the int32 total of
    ``values`` per id in [0, num_segments); ids outside it are dropped, as
    ``jax.ops.segment_sum`` drops them."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(num_segments, dtype=torch.int32, device=ids.device)
    return out.index_add_(0, torch.where(keep, ids, 0),
                          torch.where(keep, values.to(torch.int32), 0))


def bus_infection_counts(key, on_bus, route_key, infected, capacity: int):
    """Per-citizen count of the infected riders sharing the citizen's bus
    this step (0 for non-riders): ``bus_infection_counts`` of the JAX
    package, for its portable step.

    ``on_bus`` and ``infected`` are (N,) bool lanes, ``route_key`` an (N,)
    int32 route id (ignored for non-riders, and read as a signed int32:
    the sharded step's ``src * n_oa + dst`` wraps there from 46,341 OAs
    on, and equal wrapped keys share buses, as in the JAX package) and
    ``key`` the threefry key of the shuffle.  Riders are sorted by (route,
    threefry tie as signed int32), stably, and each route's run is cut
    into buses of ``capacity`` (public_transport_route.rs:79)."""
    n = on_bus.shape[0]
    device = on_bus.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=device)
    rk = torch.where(on_bus, route_key.long(), INT32_MAX)
    rk_s, order = shuffle_order(rk, threefry.bits(key, n, device))
    boundary = torch.ones(n, dtype=torch.bool, device=device)
    boundary[1:] = rk_s[1:] != rk_s[:-1]
    # each route run's start, by a cumsum of the boundary flags (kernel B3)
    # and a scatter of the boundaries' positions to their run ids; the
    # other lanes write the spare slot n
    pos = torch.arange(n, dtype=torch.int64, device=device)
    run_id = scans.cumsum_i8(boundary).long() - 1
    starts = torch.empty(n + 1, dtype=torch.int64, device=device)
    starts[torch.where(boundary, run_id, n)] = pos
    seg_start = starts[run_id]
    bus_first = seg_start + (pos - seg_start) // capacity * capacity
    n_bus = torch.zeros(n, dtype=torch.int32, device=device).index_add_(
        0, bus_first, infected[order].to(torch.int32))
    n_my_bus = torch.where(rk_s != INT32_MAX, n_bus[bus_first], 0)
    out = torch.empty(n, dtype=torch.int32, device=device)
    out[order] = n_my_bus
    return out


def bus_exposure_probability(p_exposure, n_inf_my_bus):
    """A rider's float32 chance of exposure on the bus,
    ``binomial(p, n)`` where n > 0 (simulator.rs:385-400), else 0."""
    return torch.where(n_inf_my_bus > 0,
                       maths.binomial_at_least_one(p_exposure, n_inf_my_bus),
                       0.0)


def _shuffle_and_draw(key_shuffle, key_draw, rb_on, rb_inf, rb_compliant,
                      rider_route, capacity: int, exposure_p_fn,
                      rb_chance=None, tie_bits=None, draw_seed=None,
                      rider_gid0=0):
    """Sorted rider order and the post-draw candidates ``valid & u < q``
    (susceptibility not yet applied), both in sorted order."""
    r = rb_on.shape[0]
    device = rb_on.device
    rk = torch.where(rb_on, rider_route.long(),
                     torch.full((r,), INT32_MAX, dtype=torch.int64,
                                device=device))
    tie = (threefry.bits(key_shuffle, r, device) if tie_bits is None
           else tie_bits)
    rk_s, order = shuffle_order(rk, tie)

    pos_i = torch.arange(r, dtype=torch.int64, device=device)
    boundary = torch.ones(r, dtype=torch.bool, device=device)
    boundary[1:] = rk_s[1:] != rk_s[:-1]
    seg_start = torch.cummax(torch.where(boundary, pos_i, 0), 0).values
    bus_start = boundary | ((pos_i - seg_start) % capacity == 0)
    bus_end = torch.ones(r, dtype=torch.bool, device=device)
    bus_end[:-1] = bus_start[1:]

    n_bus = run_totals(rb_inf[order], bus_start, bus_end)
    valid = rk_s != INT32_MAX
    if rb_chance is None:
        p = exposure_p_fn(rb_compliant[order], valid)
    else:
        p = exposure_p_fn(rb_compliant[order], valid, rb_chance[order])
    q = torch.where(valid & (n_bus > 0), maths.binomial_at_least_one(p, n_bus),
                    0.0)
    if draw_seed is None:
        u = threefry.uniform(key_draw, r, device)
    else:
        u = hash_uniform(draw_seed, (order + rider_gid0) & M32)
    return order, valid & (u < q)


def bus_hits(key_shuffle, key_draw, rb_on, rb_inf, rb_susc, rb_compliant,
             rider_route, rider_citizen_id, capacity: int, exposure_p_fn,
             n_citizens: int, rb_chance=None, tie_bits=None, draw_seed=None,
             rider_gid0: int = 0):
    """Bus exposures of one step.

    Inputs are rider-order lanes (R,): riding now, infected, susceptible,
    mask compliant, the static route id, and the citizen id of each
    rider.  ``exposure_p_fn(compliant, on_bus) -> float32`` gives the
    mask-adjusted exposure chance.  Returns ``(cit_lane, rider_lane,
    n_hits)``: the (n_citizens,) and (R,) bool hit lanes and their count.

    ``rb_chance``: each rider's own float32 chance (the packed ensemble
    sweeps exposure_chance per replica); it follows the shuffle, and
    ``exposure_p_fn`` is then called as ``(compliant, on_bus,
    chance_sorted)``.  ``tie_bits`` (u32 values in int64) and
    ``draw_seed`` replace the counter streams over the rider lane: the
    ties are the given lane and the draw of the rider with id i is
    ``hash_uniform(draw_seed, rider_gid0 + i)``, independent of the
    lane's length and order; ``rider_gid0`` is the global id of rider 0
    (a rank's first rider in the replica-sharded ensemble).
    """
    r = rb_on.shape[0]
    device = rb_on.device
    cit_lane = torch.zeros(n_citizens, dtype=torch.bool, device=device)
    rider_lane = torch.zeros(r, dtype=torch.bool, device=device)
    if r == 0:
        return cit_lane, rider_lane, torch.zeros((), dtype=torch.int32,
                                                 device=device)
    order, cand = _shuffle_and_draw(key_shuffle, key_draw, rb_on, rb_inf,
                                    rb_compliant, rider_route, capacity,
                                    exposure_p_fn, rb_chance, tie_bits,
                                    draw_seed, rider_gid0)
    hit = cand & rb_susc[order]
    hit_riders = order[hit]
    rider_lane[hit_riders] = True
    cit_lane[rider_citizen_id[hit_riders].long()] = True
    return cit_lane, rider_lane, hit.sum(dtype=torch.int32)


def bus_hits_sortless(key_shuffle, key_draw, rb_on, rb_inf, rb_compliant,
                      rider_route, rider_citizen_id, capacity: int,
                      exposure_p_fn, susc_of_rider, max_hits: int = 16384):
    """:func:`bus_hits` with susceptibility applied after the draw, to the
    first ``max_hits`` candidates in sorted order (``susc_of_rider(ids)
    -> bool``).  Returns ``(rider_lane, rider_ids, live, n_hits, cit_ids,
    cand_total)`` as the JAX function does; valid while ``cand_total <=
    max_hits``."""
    r = rb_on.shape[0]
    device = rb_on.device
    if r == 0:
        z = torch.zeros(0, dtype=torch.int32, device=device)
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return (torch.zeros(0, dtype=torch.bool, device=device), z,
                torch.zeros(0, dtype=torch.bool, device=device), zero, z, zero)
    order, cand = _shuffle_and_draw(key_shuffle, key_draw, rb_on, rb_inf,
                                    rb_compliant, rider_route, capacity,
                                    exposure_p_fn)
    pos, live_c, cand_total = compact_from_hierarchy(
        block_hierarchy(cand, block=128), min(max_hits, r), n=r, sb=128
    )
    rider_ids = order[torch.clamp(pos.long(), max=r - 1)]
    live = live_c & susc_of_rider(rider_ids)
    cit_ids = rider_citizen_id[rider_ids].to(torch.int32)
    rider_lane = torch.zeros(r, dtype=torch.bool, device=device)
    rider_lane[rider_ids[live]] = True
    return (rider_lane, rider_ids.to(torch.int32), live,
            live.sum(dtype=torch.int32), cit_ids, cand_total)

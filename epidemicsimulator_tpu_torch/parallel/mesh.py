"""The portable step sharded over the population on a group of ranks: the
port of the JAX package's ``parallel/mesh.py``.

Citizens are cut into ``ranks`` contiguous blocks of the canonical
(home-OA sorted) order, one per rank, after padding the population to a
multiple of the rank count with inert citizens.  Each rank steps its
block with the portable step (``engine/step.py``, ``group`` set): the
infection-pressure tables (per building and per school room), the
census, whether anyone rides and the step's counts are summed over the
ranks (``psum``), every rank's k_max lowest vaccination scores are
gathered (``all_gather``), and the threefry key is folded with the rank,
as the JAX step folds it with ``axis_index``.  No agent state moves
between ranks.  Riders form buses within their rank's block.

``make_mesh``, ``shard_inputs`` and the ``PartitionSpec`` specs have no
counterpart: the ranks of ``parallel/launch.py`` replace the mesh, and
each rank receives its block of the lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import OCC_UNEMPLOYED, STATUS_RECOVERED
from ..engine.state import SimState
from ..engine.step import StepOutput, step
from ..world.geometry import _host
from ..world.schema import World
from .fastmesh import _to, gather_state, shard_state
from .launch import launch


def pad_world_for_mesh(world: World, n_devices: int) -> World:
    """The world's core lanes on the host, without its index tables,
    padded to a multiple of ``n_devices`` citizens.  The pads live in a
    padding building of their own in OA 0 (building id ``n_buildings``,
    one more building in all), join no workplace, school or bus, and are
    Recovered for ever (:func:`pad_state_for_mesh`), so they neither
    carry nor catch an infection."""
    world = world.without_index_tables()
    world = dataclasses.replace(world, **{
        name: _host(getattr(world, name)) for name in world.lane_names()})
    rem = (-world.n_citizens) % n_devices
    if rem == 0:
        return world
    pads = {
        "age": np.full(rem, 99, np.int16),
        "occupation": np.full(rem, OCC_UNEMPLOYED, np.int8),
        "home_building": np.full(rem, world.n_buildings, np.int32),
        "work_building": np.full(rem, world.n_buildings, np.int32),
        "home_oa": np.zeros(rem, np.int32),
        "work_oa": np.zeros(rem, np.int32),
        "room": np.full(rem, world.n_rooms, np.int32),
        "is_school_work": np.zeros(rem, np.bool_),
        "uses_transport": np.zeros(rem, np.bool_),
        "mask_compliant": np.zeros(rem, np.bool_),
        "work_start": np.full(rem, 9, np.int8),
        "work_end": np.full(rem, 17, np.int8),
    }
    return dataclasses.replace(
        world, n_buildings=world.n_buildings + 1,
        **{k: np.concatenate([getattr(world, k), v]) for k, v in pads.items()})


def pad_state_for_mesh(state: SimState, n_total: int) -> SimState:
    """The state's lanes on the host, padded to ``n_total`` citizens with
    Recovered pads (terminal, never exposed, and counted in the R column
    of every census row: callers subtract the pad count when they report
    it).  The fast step's work-order schedule bits and the
    fixed-priority pool, which the portable step never reads, are
    dropped, as the JAX ``run_sharded`` drops them."""
    rem = n_total - state.status.shape[0]

    def lane(x, pad):
        x = x.cpu()
        return torch.cat([x, torch.full((rem,), pad, dtype=x.dtype)])

    return dataclasses.replace(
        state, status=lane(state.status, STATUS_RECOVERED),
        timer=lane(state.timer, 0), sched=lane(state.sched & 7, 0),
        eligible=lane(state.eligible, False),
        vax_pool=torch.zeros(0, dtype=torch.int32),
        vax_pool_size=torch.zeros((), dtype=torch.int32))


def shard_world(world: World, rank: int, n_devices: int) -> World:
    """Rank ``rank``'s contiguous block of a padded world's lanes (every
    lane's length divides by ``n_devices``)."""
    size = world.n_citizens // n_devices
    return dataclasses.replace(world, **{
        name: getattr(world, name)[rank * size:(rank + 1) * size].copy()
        for name in World.CORE_LANES})


def make_sharded_chunk_runner(world: World, cfg, group):
    """``chunk(params, state) -> (state, StepOutput[chunk_size])`` for this
    rank's block ``world`` (lanes on ``group.device``): ``cfg.chunk_size``
    portable steps, every output summed over the ranks, as numpy arrays
    alike on every rank.  The per-OA series stays int32, as the JAX
    sharded runner ships it."""

    def chunk(params, state):
        outs = []
        for _ in range(cfg.chunk_size):
            state, out = step(world, params, cfg, state, group=group)
            outs.append(out)
        stack = lambda name: torch.stack(
            [getattr(o, name) for o in outs]).cpu().numpy()
        host = lambda name, dtype: np.asarray(
            [getattr(o, name) for o in outs], dtype)
        return state, StepOutput(
            seirv=stack("seirv"),
            exposures_per_oa=stack("exposures_per_oa"),
            n_bus_exposures=stack("n_bus_exposures"),
            n_exposures=stack("n_exposures"),
            lockdown=host("lockdown", bool),
            mask_status=host("mask_status", np.int8),
            n_vaccinated_now=stack("n_vaccinated_now"),
        )

    return chunk


def run_rank(group, params, cfg, world: World, state: SimState, *,
             callback=None):
    """One rank's chunk loop on its block (:func:`shard_world`,
    ``fastmesh.shard_state``), until the epidemic ends (S + E + I = 0 in a
    chunk's last row) or ``cfg.max_steps`` steps have been dispatched.
    On rank 0, ``callback(steps_done, out, state)`` runs after each chunk,
    ``state`` being rank 0's block.  Returns ``(the final state in the
    padded layout, on the host; outputs)`` on rank 0, None elsewhere."""
    world = world.to(group.device)
    state = _to(state, group.device)
    chunk = make_sharded_chunk_runner(world, cfg, group)
    chunks, steps_done = [], 0
    while steps_done < cfg.max_steps:
        state, out = chunk(params, state)
        chunks.append(out)
        steps_done += cfg.chunk_size
        if callback is not None:
            callback(steps_done, out, state)
        if not out.seirv[-1, :3].sum() > 0:
            break
    final = gather_state(state, group)
    if group.rank != 0:
        return None
    outputs = StepOutput(*(np.concatenate(xs, axis=0)[:cfg.max_steps]
                           for xs in zip(*chunks)))
    alive = outputs.seirv[:, :3].sum(axis=1) > 0
    if not alive.all():
        end = int(np.argmin(alive)) + 1
        outputs = StepOutput(*(x[:end] for x in outputs))
    return final, outputs


def run_sharded(world: World, params, cfg, state: SimState, *, devices: int,
                device="cuda", callback=None):
    """The portable step sharded over ``devices`` ranks on ``device``
    ("cuda": the card or cards, "cpu": gloo processes), run until the
    epidemic ends or ``cfg.max_steps`` (the JAX package's
    ``run_sharded``, a rank count in place of the mesh).  ``state`` is a
    one-device state of ``world`` (``init_state``).  Returns ``(final
    state in the padded layout, on the host; outputs)``: every SEIRV row
    counts the ``(-N) % devices`` pads as Recovered."""
    world = pad_world_for_mesh(world, devices)
    state = pad_state_for_mesh(state, world.n_citizens)
    size = world.n_citizens // devices
    return launch(
        run_rank, devices, device=device, args=(params, cfg),
        rank_args=[(shard_world(world, r, devices),
                    shard_state(state, r, size))
                   for r in range(devices)],
        rank0_kwargs=dict(callback=callback))

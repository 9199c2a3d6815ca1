"""Simulation state: four per-citizen lanes (five with the fixed-priority
vaccination pool) and a few host scalars.

The port's counterpart of ``epidemicsimulator_tpu/engine/state.py``.  The
five schedule bits always travel packed in one int8 ``sched`` lane, the
representation the citizen kernel reads and writes (``pack_sched`` /
``unpack_sched`` convert to and from the JAX package's bool lanes).  The
scalars the host needs to steer a step (hour, interventions, the key of
the threefry chain) are Python values, so a step needs no device read to
choose its branches beyond its one read of the census, and a second on
the hours that vaccinate from the pool.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MASK_NONE, STARTING_INFECTED_COUNT, STATUS_INFECTED
from ..ops import threefry
from ..runtime import resolve_device

SCHED_LANES = ("at_work", "on_bus", "bus_to_work", "at_work_ws", "on_bus_ws")


@dataclasses.dataclass(frozen=True)
class SimState:
    status: torch.Tensor      # int8 STATUS_*
    timer: torch.Tensor       # int32 hours in the current E/I state
    sched: torch.Tensor       # int8, the schedule bits (pack_sched)
    eligible: torch.Tensor    # bool, in the vaccination pool
    # the fixed-priority vaccination pool (SimConfig.vaccination_fixed_
    # priority): vax_pool[:vax_pool_size] holds the citizen ids of a
    # superset of the eligible pool (entries go stale when citizens leave;
    # draws reject them against the live eligible lane), rebuilt the step
    # vaccination starts and when the pool halves.  vax_pool is (N,)
    # int32, or (0,) when the pool is off; vax_pool_size a 0-d int32.
    vax_pool: torch.Tensor
    vax_pool_size: torch.Tensor
    hour: int = 0             # 1-based step of the last step taken
    lockdown: bool = False
    vaccination_started: bool = False
    mask_status: int = MASK_NONE
    rng_key: tuple = (0, 0)   # threefry key (k0, k1)


def pack_sched(at_work, on_bus, bus_to_work, at_work_ws, on_bus_ws):
    """Five schedule bool lanes -> one int8 lane (bits 0-4)."""
    out = torch.zeros(at_work.shape, dtype=torch.int8, device=at_work.device)
    for bit, lane in enumerate((at_work, on_bus, bus_to_work, at_work_ws,
                                on_bus_ws)):
        out |= lane.to(torch.int8) << bit
    return out


def unpack_sched(sched) -> dict:
    """The inverse of :func:`pack_sched`, as a dict of bool lanes."""
    return {name: (sched & (1 << bit)) != 0
            for bit, name in enumerate(SCHED_LANES)}


def init_state(world, *, seed: int = 0,
               starting_infected: int = STARTING_INFECTED_COUNT,
               np_seed: int | None = None, fixed_priority_vax: bool = False,
               device="cuda") -> SimState:
    """Initial state with ``starting_infected`` seeded infections: a
    uniform output area, then a uniform citizen in it
    (simulator_builder.rs:1111-1142), drawn on the host with numpy exactly
    as the JAX package draws them.  ``fixed_priority_vax`` allocates the
    fixed-priority pool's lanes: pass
    ``wants_fixed_priority_vax(world, cfg)``, without which a step that
    wants the pool (from 16M citizens on, by default) raises."""
    dev = resolve_device(device)
    n = world.n_citizens
    rng = np.random.default_rng(seed if np_seed is None else np_seed)
    status = np.zeros(n, np.int8)
    home_oa = np.asarray(world.home_oa.cpu() if isinstance(
        world.home_oa, torch.Tensor) else world.home_oa)
    if n and (np.diff(home_oa) < 0).any():
        raise ValueError("citizens must be in canonical order (make_world)")
    if n:
        # home_oa is sorted, so OA membership is a searchsorted range
        oas = rng.integers(0, world.n_output_areas, starting_infected)
        lo = np.searchsorted(home_oa, oas, side="left")
        hi = np.searchsorted(home_oa, oas, side="right")
        nonempty = hi > lo
        picks = lo[nonempty] + (
            rng.random(int(nonempty.sum())) * (hi - lo)[nonempty]
        ).astype(np.int64)
        status[picks] = STATUS_INFECTED
    return SimState(
        status=torch.from_numpy(status).to(dev),
        timer=torch.zeros(n, dtype=torch.int32, device=dev),
        sched=torch.zeros(n, dtype=torch.int8, device=dev),
        eligible=torch.zeros(n, dtype=torch.bool, device=dev),
        vax_pool=torch.zeros(n if fixed_priority_vax else 0,
                             dtype=torch.int32, device=dev),
        vax_pool_size=torch.zeros((), dtype=torch.int32, device=dev),
        rng_key=threefry.key(seed),
    )

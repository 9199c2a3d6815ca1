"""Carry a world, parameters and a state from the JAX package into the
port, so that both packages step the same inputs.

The caller passes the JAX package's objects as plain numpy arrays and
Python numbers (this module imports nothing of JAX):

    world = world_from_arrays(
        {name: np.asarray(getattr(jax_world, name)) for name in LANES},
        n_buildings=..., n_rooms=..., n_output_areas=...,
        max_household_size=...)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import DiseaseParams, InterventionThresholds, Params
from .engine.state import SimState, pack_sched
from .runtime import resolve_device
from .world.schema import World


def world_from_arrays(lanes: Mapping[str, np.ndarray], *, n_buildings: int,
                      n_rooms: int, n_output_areas: int,
                      max_household_size: int, device="cuda") -> World:
    """A port World from the JAX World's lanes (any subset of the port's
    lane names; the rest stay None), moved to ``device``."""
    dev = resolve_device(device)
    world = World(
        n_buildings=int(n_buildings), n_rooms=int(n_rooms),
        n_output_areas=int(n_output_areas),
        max_household_size=int(max_household_size),
        **{name: np.asarray(v) for name, v in lanes.items()},
    )
    return world.to(dev)


def params_from_values(disease: Mapping, thresholds: Mapping) -> Params:
    """Params from the JAX dataclasses' fields (numbers or 0-d arrays)."""
    num = lambda v: np.asarray(v).item()
    return Params(
        DiseaseParams(**{k: num(v) for k, v in disease.items()}),
        InterventionThresholds(**{k: num(v) for k, v in thresholds.items()}),
    )


def state_from_arrays(arrays: Mapping[str, np.ndarray], device="cuda") -> SimState:
    """A port SimState from the JAX SimState's lanes: status, timer,
    eligible, the five schedule bool lanes (or a packed ``sched``), hour,
    lockdown, vaccination_started, mask_status, ``rng_key`` as the key
    data (uint32[2], ``jax.random.key_data``) and, where present, the
    fixed-priority pool's ``vax_pool`` and ``vax_pool_size``."""
    dev = resolve_device(device)
    t = lambda name: torch.from_numpy(np.array(arrays[name])).to(dev)
    if "sched" in arrays and np.size(arrays["sched"]):
        sched = t("sched").to(torch.int8)
    else:
        # (0,)-shaped work-order twin lanes (a sharded state) pack as 0
        n = np.shape(arrays["status"])[0]
        sched = pack_sched(*(
            t(name) if np.shape(arrays[name])[0] == n
            else torch.zeros(n, dtype=torch.bool, device=dev)
            for name in ("at_work", "on_bus", "bus_to_work", "at_work_ws",
                         "on_bus_ws")))
    key = np.asarray(arrays["rng_key"], np.uint32)
    return SimState(
        status=t("status").to(torch.int8),
        timer=t("timer").to(torch.int32),
        sched=sched,
        eligible=t("eligible").to(torch.bool),
        vax_pool=(t("vax_pool").to(torch.int32) if "vax_pool" in arrays
                  else torch.zeros(0, dtype=torch.int32, device=dev)),
        vax_pool_size=(t("vax_pool_size").to(torch.int32).reshape(())
                       if "vax_pool_size" in arrays
                       else torch.zeros((), dtype=torch.int32, device=dev)),
        hour=int(np.asarray(arrays["hour"])),
        lockdown=bool(np.asarray(arrays["lockdown"])),
        vaccination_started=bool(np.asarray(arrays["vaccination_started"])),
        mask_status=int(np.asarray(arrays["mask_status"])),
        rng_key=(int(key[0]), int(key[1])),
    )

"""Simulation checkpoint and resume: the whole state is a handful of arrays.

The JAX package's npz layout (its ``engine/checkpoint.py``), key for key,
so that a checkpoint written by either package resumes in the other:

* the per-citizen lanes ``status``, ``timer`` and ``eligible``, and the
  five schedule bool lanes unpacked from ``sched`` (a sharded state, in
  its padded shard layout, has no work-order twin: its ``at_work_ws``
  and ``on_bus_ws`` are (0,), as the JAX package's sharded state has
  them);
* the scalars ``hour``, ``lockdown``, ``vaccination_started`` and
  ``mask_status``;
* ``rng_key_data``, the threefry key as uint32[2];
* the fixed-priority vaccination pool, ``vax_pool`` ((N,) int32, or
  (0,) when the pool is off) and ``vax_pool_size``;
* the JAX package's lanes that the port does not carry, as (0,)-shaped
  sentinels: the replicated-order twins and the packed ``sched``;
* optionally ``__seirv__``, the recorder's rows so far.

The file is written beside its destination and renamed into place.
"""

from __future__ import annotations

import os

import numpy as np

from ..bridge import state_from_arrays
from .state import SCHED_LANES, SimState, unpack_sched

#: lanes of the JAX package's state that the port does not carry, with
#: the dtypes its checkpoints give them.  Its default formulation never
#: reads the replicated-order twins (they keep the copy made at its
#: ``init_state``), so they are dropped on load whatever their shape.
_JAX_ONLY = {
    "status_ws": np.int8, "timer_ws": np.int16, "status_r": np.int8,
    "timer_r": np.int16, "on_bus_r": np.bool_,
}


def save_state(path: str, state: SimState, seirv_so_far=None, *,
               ws_lanes: bool = True) -> None:
    """``ws_lanes`` False writes the work-order twin's two schedule lanes
    as (0,) (a sharded state)."""
    host = lambda x: x.cpu().numpy()
    sched = {name: host(lane) for name, lane in unpack_sched(state.sched).items()}
    if not ws_lanes:
        sched.update(at_work_ws=np.zeros(0, bool), on_bus_ws=np.zeros(0, bool))
    arrays = {
        "status": host(state.status),
        "timer": host(state.timer),
        **sched,
        "eligible": host(state.eligible),
        "hour": np.asarray(state.hour, np.int32),
        "lockdown": np.asarray(state.lockdown, np.bool_),
        "vaccination_started": np.asarray(state.vaccination_started, np.bool_),
        "mask_status": np.asarray(state.mask_status, np.int8),
        "rng_key_data": np.asarray(state.rng_key, np.uint32),
        **{name: np.zeros(0, dtype) for name, dtype in _JAX_ONLY.items()},
        "vax_pool": host(state.vax_pool),
        "vax_pool_size": host(state.vax_pool_size),
        "sched": np.zeros(0, np.int8),
    }
    if seirv_so_far is not None:
        arrays["__seirv__"] = np.asarray(seirv_so_far)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_state(path: str, device="cuda") -> tuple[SimState, np.ndarray | None]:
    """``(state on device, the recorder's rows or None)``."""
    with np.load(path) as data:
        arrays = {name: data[name] for name in data.files}
    seirv = arrays.pop("__seirv__", None)
    arrays["rng_key"] = arrays.pop("rng_key_data")
    missing = [name for name in SCHED_LANES if name not in arrays]
    if missing and not np.size(arrays.get("sched", ())):
        raise ValueError(f"{path} lacks the schedule lanes {missing}")
    return state_from_arrays(arrays, device=device), seirv

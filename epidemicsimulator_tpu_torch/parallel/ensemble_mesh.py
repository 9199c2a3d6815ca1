"""Replica-sharded packed ensembles: the R axis split over ranks.

The port of the JAX package's ``parallel/ensemble_mesh.py``.  Replicas
never interact, so each rank packs and steps its own ``R_l = R / size``
whole replicas of the same base world with the one-card packed step
(``engine/packed.py``), and no step needs a collective:

* rank r holds replicas ``[r * R_l, (r + 1) * R_l)``; its packing has the
  layout of lanes ``[r * R_l * stride, (r + 1) * R_l * stride)`` of the
  whole R-replica packing, so it passes ``gid0 = r * R_l * stride`` and
  ``rider_gid0 = r * R_l * riders per replica``: every draw (home, work,
  vaccination scores, and the bus ties and draws, in id-keyed mode, which
  this runner forces on as the JAX runner does) hashes the whole
  packing's ids, and the run equals the one-card R-replica packing's
  under ``SimConfig.id_keyed_ensemble_rng`` bitwise;
* the initial state is the whole packing's (``init_packed_state`` draws
  the seeded infections replica by replica from one numpy stream), cut
  into the ranks' slices;
* after each chunk one ``all_gather`` of the (chunk, R_l, 5) SEIRV rows
  gives every rank the whole (chunk, R, 5), from which all ranks decide
  alike whether every replica is over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import InterventionThresholds, require_fast_path
from ..engine.ensemble import stack_params
from ..engine.packed import (
    LANES as LANE_WIDTH, PackedEnsemble, PackedState, ensemble_done,
    init_packed_state, make_packed_runner, pack_replicas,
)
from .launch import launch


def pack_replicas_params_only(param_list) -> dict:
    """The (R,) swept parameter rows of ``pack_replicas``, without the
    world (``ensemble_mesh.py:233``)."""
    ds = [p.disease for p in param_list]
    f32 = lambda name: np.array([getattr(d, name) for d in ds], np.float32)
    i32 = lambda name: np.array([int(getattr(d, name)) for d in ds], np.int32)
    return dict(
        chance=f32("exposure_chance"),
        exposed_time=i32("exposed_time"),
        infected_time=i32("infected_time"),
        mask_effectiveness=f32("mask_effectiveness"),
        vaccination_rate=i32("vaccination_rate"),
    )


def _host_world(world):
    """The world with numpy lanes: what a started rank unpickles."""
    return dataclasses.replace(world, **{
        name: getattr(world, name).cpu().numpy()
        for name in world.lane_names()
        if isinstance(getattr(world, name), torch.Tensor)})


def _state_slice(state: PackedState, lo: int, hi: int, width: int):
    """Replicas [lo, hi) of a packed state whose replicas are ``width``
    lanes wide, on the host."""
    lane = lambda x: x[lo * width:hi * width].clone()
    return dataclasses.replace(
        state, status=lane(state.status), timer=lane(state.timer),
        sched=lane(state.sched), eligible=lane(state.eligible),
        lockdown=state.lockdown[lo:hi].copy(),
        mask_status=state.mask_status[lo:hi].copy(),
        vaccination_started=state.vaccination_started[lo:hi].copy())


def run_ensemble_rank(group, base, cfg, block_rows, early_exit, params,
                      state, th, gid0, rider_gid0):
    """One rank's replicas: pack, step chunk by chunk, and gather every
    chunk's SEIRV rows.  Returns the (R, T, 5) series on rank 0."""
    pe = pack_replicas(base, params, block_rows=block_rows)
    dev = group.device
    state = dataclasses.replace(
        state, status=state.status.to(dev), timer=state.timer.to(dev),
        sched=state.sched.to(dev), eligible=state.eligible.to(dev))
    runner = make_packed_runner(pe, cfg, device=dev, gid0=gid0,
                                rider_gid0=rider_gid0)
    chunks, steps = [], 0
    while steps < cfg.max_steps:
        state, seirv = runner(th, state)
        rows = group.all_gather(seirv).cpu().numpy()  # (size, T, R_l, 5)
        rows = rows.transpose(1, 0, 2, 3).reshape(rows.shape[1], -1, 5)
        chunks.append(rows)
        steps += cfg.chunk_size
        if ensemble_done(rows[-1], early_exit):
            break
    if group.rank != 0:
        return None
    out = np.concatenate(chunks, axis=0)[:cfg.max_steps]
    return np.transpose(out, (1, 0, 2))


def run_packed_ensemble_sharded(base, param_list, cfg, *, n_devices: int,
                                seed: int = 0, block_rows: int = 128,
                                early_exit: str = "sei", device="cuda"):
    """Run R replicates over ``n_devices`` ranks, R_l = R / n_devices
    replicas each; returns the (R, T, 5) SEIRV series as numpy, bitwise
    the one-card packing's with ``id_keyed_ensemble_rng=True`` (which
    this runner forces)."""
    require_fast_path(cfg, "packed ensemble engine")
    R = len(param_list)
    if R % n_devices:
        raise ValueError(f"{R} replicates do not divide over {n_devices} "
                         "devices")
    R_l = R // n_devices
    cfg = dataclasses.replace(cfg, id_keyed_ensemble_rng=True)
    n = base.n_citizens
    block = block_rows * LANE_WIDTH
    stride = -(-max(n, 1) // block) * block  # pack_replicas's stride
    # init_packed_state reads only the replica count, size and stride
    shape = PackedEnsemble(world=None, n_replicas=R, rep_size=n,
                           rep_stride=stride, block_rows=block_rows,
                           **pack_replicas_params_only(param_list))
    state = init_packed_state(shape, seed=seed,
                              starting_infected=cfg.starting_infected,
                              device="cpu")
    th = stack_params(param_list).thresholds
    riders = base.n_riders
    rank_args = []
    for r in range(n_devices):
        lo, hi = r * R_l, (r + 1) * R_l
        th_r = InterventionThresholds(**{
            f.name: getattr(th, f.name)[lo:hi]
            for f in dataclasses.fields(th)})
        rank_args.append((param_list[lo:hi], _state_slice(state, lo, hi,
                                                          stride),
                          th_r, lo * stride, lo * riders))
    return launch(run_ensemble_rank, n_devices, device=device,
                  args=(_host_world(base), cfg, block_rows, early_exit),
                  rank_args=rank_args)

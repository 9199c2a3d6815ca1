"""Parameter ensembles: R replicates of one world in one run.

The port's copy of ``epidemicsimulator_tpu/engine/ensemble.py`` with its
default engine, ``"packed"`` (engine/packed.py), which steps the replicas
as one world.  The JAX package's vmapped engine, which the packed engine
superseded there, is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DiseaseParams, InterventionThresholds, Params, SimConfig


def stack_params(param_list: list[Params]) -> Params:
    """One Params whose every field is an (R,) numpy row, float32 for the
    float fields and int32 for the integer ones, as the JAX package's
    ``as_arrays`` types them."""
    def stack(cls, parts):
        return cls(**{
            f.name: np.array([getattr(p, f.name) for p in parts],
                             np.int32 if f.type in ("int", int) else np.float32)
            for f in dataclasses.fields(cls)})

    return Params(stack(DiseaseParams, [p.disease for p in param_list]),
                  stack(InterventionThresholds,
                        [p.thresholds for p in param_list]))


def run_ensemble(world, params_list: list[Params], cfg: SimConfig, *,
                 seed: int = 0, engine: str = "packed",
                 devices: int | None = None, device="cuda"):
    """Run R replicates to ``cfg.max_steps``; returns the (R, T, 5) SEIRV
    series as numpy.  The run stops after the chunk in which every
    replicate is over (S + E + I = 0).

    ``devices`` > 1 splits the replicas over that many ranks
    (``parallel/ensemble_mesh.py``: no per-step collectives; the replicas
    must divide evenly), whose trajectories run in id-keyed bus-RNG mode
    (``SimConfig.id_keyed_ensemble_rng``) and equal the one-card packing's
    in that mode bitwise.  ``engine="vmap"`` (the JAX package's vmapped
    formulation) raises NotImplementedError."""
    if devices is not None and devices > 1:
        if engine != "packed":
            raise ValueError("sharded ensembles require engine='packed'")
        from ..parallel.ensemble_mesh import run_packed_ensemble_sharded

        return run_packed_ensemble_sharded(world, params_list, cfg,
                                           n_devices=devices, seed=seed,
                                           device=device)
    if engine == "vmap":
        raise NotImplementedError(
            "the vmapped ensemble engine is not ported: the packed engine "
            "superseded it (ROADMAP.md, 'Not ported, on purpose')")
    if engine != "packed":
        raise ValueError(f"unknown ensemble engine {engine!r}")
    from .packed import run_packed_ensemble

    return run_packed_ensemble(world, params_list, cfg, seed=seed,
                               device=device)

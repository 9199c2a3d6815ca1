"""The PyTorch and CUDA port of epidemicsimulator_tpu, for one NVIDIA H100.

The main path: a synthetic world (``generate_synthetic_world``), moved to
the card (``World.to``), an initial state (``init_state``) and chunks of
fused steps (``make_chunk_runner`` / ``run``); from 16M citizens on the
state needs ``init_state(..., fixed_priority_vax=wants_fixed_priority_vax(
world, cfg))``.  ``Simulator`` runs that
path to the end of the epidemic and writes the reference's four JSON
artifacts; ``python -m epidemicsimulator_tpu_torch.cli`` drives it, on a
synthetic world or on one that ``world.preprocess.builder.build_world``
makes from census tables, an OSM extract and OA polygons (``data/``).
``run_ensemble`` steps R parameter replicates of a world as one packed
world (``engine/packed.py``), and ``calibrate.calibrate`` fits a
parameter to a target curve with it.  ``generate_synthetic_world_device``
builds a synthetic world on the card itself, up to the full UK.
``SimConfig(use_fast_path=False)`` (or a world ``without_index_tables``)
steps with the portable step, the formulation the JAX package's scalar
oracle checks, which ``parallel/mesh.py::run_sharded`` shards over ranks;
``viz/`` draws maps, graphs and a live GIF on the host.
Entry points run on the card unless the caller passes ``device="cpu"``,
where each CUDA kernel is replaced by its plain torch version.
"""

from .config import DiseaseParams, InterventionThresholds, Params, SimConfig
from .engine.ensemble import run_ensemble
from .engine.fastpath import wants_fixed_priority_vax
from .engine.scan import make_chunk_runner, run
from .engine.simulator import Simulator
from .engine.state import SimState, init_state
from .engine.step import StepOutput, step
from .runtime import launches, reset_launches, resolve_device
from .world.census_like import generate_census_like_world
from .world.device_build import (
    build_tables_device,
    generate_synthetic_world_device,
)
from .world.schema import World, make_world
from .world.synthetic import generate_synthetic_world

__all__ = [
    "DiseaseParams", "InterventionThresholds", "Params", "SimConfig",
    "SimState", "Simulator", "StepOutput", "World", "build_tables_device",
    "generate_census_like_world", "generate_synthetic_world",
    "generate_synthetic_world_device",
    "init_state", "launches", "make_chunk_runner", "make_world",
    "reset_launches", "resolve_device", "run", "run_ensemble", "step",
    "wants_fixed_priority_vax",
]

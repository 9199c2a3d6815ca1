"""Constants and parameters of the epidemic model, for the PyTorch port.

A copy of the parts of ``epidemicsimulator_tpu/config.py`` that the fused
main path reads.  Parameters are plain dataclasses of Python numbers; the
step turns them into float32/int32 values exactly where the JAX package
does, so both packages compute with the same bits.
"""

from __future__ import annotations

import dataclasses

# Static structural constants (the reference's sim/src/config.rs).
STARTING_INFECTED_COUNT = 10
HOUSEHOLD_SIZE = 4
MIN_WORKPLACE_OCCUPANT_COUNT = 20
PUBLIC_TRANSPORT_PERCENTAGE = 0.2
BUS_CAPACITY = 20
MAX_STUDENT_AGE = 18
MINIMUM_FLOOR_SPACE_SIZE = 2000
AVERAGE_CLASS_SIZE = 26.6
AVERAGE_OFFICE_SIZE = 12

# m^2 per employee for occupation index 0..8 (employment_densities.rs).
EMPLOYMENT_DENSITY_BY_OCCUPATION = (12, 12, 10, 12, 36, 47, 19, 36, 19)

OCC_TEACHING = 8
OCC_STUDENT = 9
OCC_UNEMPLOYED = 10

STATUS_SUSCEPTIBLE = 0
STATUS_EXPOSED = 1
STATUS_INFECTED = 2
STATUS_RECOVERED = 3
STATUS_VACCINATED = 4

MASK_NONE = 0
MASK_PUBLIC_TRANSPORT = 1
MASK_EVERYWHERE = 2


@dataclasses.dataclass(frozen=True)
class DiseaseParams:
    """SEIR(+V) disease parameters (disease.rs:96-129)."""

    exposure_chance: float = 0.00055
    death_rate: float = 0.2
    exposed_time: int = 4 * 24
    infected_time: int = 14 * 24
    vaccination_rate: int = 85 * 18
    mask_percentage: float = 0.8
    mask_effectiveness: float = 0.70

    @staticmethod
    def covid() -> "DiseaseParams":
        return DiseaseParams()


@dataclasses.dataclass(frozen=True)
class InterventionThresholds:
    """Infected fractions that trigger interventions; negative disables."""

    lockdown: float = 0.0034
    vaccination: float = 0.005
    mask_public_transport: float = 0.001
    mask_everywhere: float = 0.0022


#: v1.6-era exposure chance (see the JAX package's config.py).
V16_EXPOSURE_CHANCE = 0.003


@dataclasses.dataclass(frozen=True)
class Params:
    disease: DiseaseParams = dataclasses.field(default_factory=DiseaseParams)
    thresholds: InterventionThresholds = dataclasses.field(
        default_factory=InterventionThresholds
    )

    @staticmethod
    def covid() -> "Params":
        return Params(DiseaseParams.covid(), InterventionThresholds())

    @staticmethod
    def covid_v16() -> "Params":
        """The reference's v1.6-era parameters: 100x thresholds and
        5,100 vaccinations per step (85 x 60)."""
        return Params(
            DiseaseParams(exposure_chance=V16_EXPOSURE_CHANCE,
                          vaccination_rate=5100),
            InterventionThresholds(
                lockdown=0.60,
                vaccination=0.30,
                mask_public_transport=0.20,
                mask_everywhere=0.40,
            ),
        )

    @staticmethod
    def from_json(path: str) -> "Params":
        """Parameters from a JSON file of the layout ``to_json`` writes,
        ``{"disease": {...}, "thresholds": {...}}``; missing fields keep
        their defaults."""
        import json

        with open(path) as f:
            raw = json.load(f)
        return Params(
            disease=DiseaseParams(**raw.get("disease", {})),
            thresholds=InterventionThresholds(**raw.get("thresholds", {})),
        )

    def to_json(self, path: str) -> None:
        import json

        with open(path, "w") as f:
            json.dump(
                {
                    "disease": dataclasses.asdict(self.disease),
                    "thresholds": dataclasses.asdict(self.thresholds),
                },
                f,
                indent=2,
            )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The structural knobs that the steps and the Simulator read."""

    max_steps: int = 5000
    chunk_size: int = 250
    #: per-OA exposure counts per step (statistics.rs:181-195)
    record_exposures_per_oa: bool = True
    #: step with the fused fast step (engine/fastpath.py) when the world
    #: carries its tables; False, or a world without them, steps with the
    #: portable step (engine/step.py), the formulation the JAX package's
    #: scalar oracle checks.  The packed and the fast sharded engines have
    #: no portable form and refuse False.
    use_fast_path: bool = True
    #: the reference's inverted mask logic (citizen.rs:228-232)
    reference_mask_semantics: bool = True
    #: the reference's ``exposure_total as u8`` cast (citizen.rs:239)
    reference_u8_truncation: bool = True
    #: the reference's vaccine-pool quirks (simulator.rs:346-348, 524-553)
    faithful_vaccine_bugs: bool = True
    bus_capacity: int = BUS_CAPACITY
    #: the portable step's bound on vaccinations per step: it takes the
    #: min(this, N) lowest scores and vaccinates the first
    #: ``vaccination_rate`` of them (a reference quirk the port copies:
    #: a rate above the bound vaccinates only this many)
    max_vaccinations_per_step: int = 85 * 18
    #: infections seeded by the Simulator's initial state
    starting_infected: int = STARTING_INFECTED_COUNT
    #: the packed ensemble's bus streams (engine/packed.py): None or False
    #: draws the ties and the exposures from threefry counters over the
    #: whole packed rider lane, so they depend on its length; True hashes
    #: each rider's global id (ops/segments.py ``bus_hits`` with
    #: ``tie_bits`` and ``draw_seed``).  The two have the same law.
    id_keyed_ensemble_rng: bool | None = None
    #: Sampled vaccination draws: keep the eligible pool as a compacted
    #: index array (rebuilt by one stable partition only when the pool
    #: halves), and each step draw 8,192 uniform candidate slots, reject
    #: entries whose citizens left the pool (checked against the live
    #: ``eligible`` lane), and take the first k distinct: a uniform
    #: k-subset of the current pool, i.e. the same law as the default
    #: fresh-threshold selector, for both faithful and intended pool
    #: semantics.  The per-step work is K-sized instead of a pool-wide
    #: threshold search; the step falls back to the threshold selector on
    #: candidate shortfall (the fallback is also a uniform k-subset).
    #: Changes which individual citizens are picked (different draw
    #: stream), so trajectories differ from the default mode but match in
    #: law.  Requires init_state(..., fixed_priority_vax=True) for the
    #: lanes; the step raises without them.  None = auto: on for worlds with >= 16M citizens, as in the
    #: JAX package (``engine/fastpath.py::wants_fixed_priority_vax``).
    vaccination_fixed_priority: bool | None = None
    #: The population-sharded engine's vaccination selector
    #: (``parallel/fastmesh.py``, ``ops/select.py::kth_threshold_sharded``):
    #: None = auto (the sampled band for shards of 2**22 citizens or more,
    #: else the bisection with its count summed over the ranks); True or
    #: False forces one.  Both give the same exact threshold.
    use_sampled_vax_sharded: bool | None = None
    #: log2 of each rank's sample for the sampled band
    vax_sharded_sample_log2: int = 17
    #: Options of the JAX package that are off by default and not ported
    #: (the sharded engine's sortless branches, the sparse work-back and
    #: the ``debug_*`` probes, which also reach its one-device step):
    #: setting one makes this config raise NotImplementedError, so no run
    #: of any engine ignores it.
    use_sortless_sharded: bool | None = None
    use_sparse_workback: bool | None = None
    debug_shard_parts: int = -1
    debug_force_gates: tuple | None = None
    debug_bus_hit_slots: int | None = None

    def __post_init__(self):
        for name, off in NOT_PORTED.items():
            if getattr(self, name) not in off:
                raise NotImplementedError(
                    f"SimConfig.{name}={getattr(self, name)!r}: this option "
                    "of the JAX package is not ported")


def require_fast_path(cfg: SimConfig, engine: str) -> None:
    """Refuse ``use_fast_path=False`` in an engine that has only the fast
    formulation (the packed ensemble and the fast sharded engine, as in
    the JAX package), so that no run ignores the field."""
    if not cfg.use_fast_path:
        raise NotImplementedError(
            f"SimConfig.use_fast_path=False: the {engine} has no portable "
            "form (the portable step runs through step, run, the Simulator "
            "and parallel/mesh.py's run_sharded)")


#: the JAX package's options that the port does not carry, with the values
#: that mean "off"
NOT_PORTED = {
    "use_sortless_sharded": (None, False),
    "use_sparse_workback": (None, False),
    "debug_shard_parts": (-1, 0),
    "debug_force_gates": (None,),
    "debug_bus_hit_slots": (None,),
}

"""Census-like synthetic world: the reference world-builder's structural
statistics without census/OSM inputs.

A numpy copy of ``epidemicsimulator_tpu/world/census_like.py``: the same
arguments give the same world, lane for lane and dtype for dtype.

The toy generator (synthetic.py) matches the reference's *mechanics* but
uses uniform/constant choices where the reference samples census-shaped
distributions.  Those choices shape epidemic takeoff timing (VERDICT round 1
weak #1): household mixing-group sizes, the heavy-tailed workplace-size
distribution, hub-structured commuting and the work-from-home fraction all
set the early growth rate.  This generator reproduces the distributions the
reference derives from its inputs, per its own semantics:

* per-OA population ~ English OA sizes (mean ~309 residents/OA);
* age from the England 2011 QS103 pyramid (5-year bands, ONS published
  aggregates), students below MAX_STUDENT_AGE (config.rs:38);
* occupations from KS608 national shares, including the reference's
  "Teaching" mislabel of elementary occupations (occupation_count.rs:54-55);
* household size = floor(OA pop / OA household-building count) + 1, the
  reference's exact rule (output_area.rs:139), with the housing stock drawn
  so the ratio spans ~2-3 like English OAs;
* workplace OA from a hub + distance-decay commuting mixture mimicking the
  sparse WF01BEW matrix (resides_vs_workplace.rs:100-151); sampling
  failures (out-of-region commuters) keep work == home, the reference's
  50-try rejection fallback (simulator_builder.rs:758-772) that produced
  7.4% work-from-home at Y&H (simulation_results/summary.md V1.3.0);
* workplace buildings with lognormal floor areas (OSM-building-shaped),
  scaled to 1.1x required space and packed per occupation with capacity
  floorspace/density min 20 (simulator_builder.rs:932-1000,
  building.rs:244-250);
* schools/classes/offices identical to the toy generator (shared
  build_schools);
* 20% public transport (citizen.rs:159), 80% mask compliance
  (output_area.rs:119).
"""

from __future__ import annotations

import numpy as np

from ..config import (
    EMPLOYMENT_DENSITY_BY_OCCUPATION,
    MAX_STUDENT_AGE,
    MIN_WORKPLACE_OCCUPANT_COUNT,
    MINIMUM_FLOOR_SPACE_SIZE,
    OCC_STUDENT,
    PUBLIC_TRANSPORT_PERCENTAGE,
)
from .schema import World, make_world
from .synthetic import _cumcount, _unique_sorted, build_schools

# England & Wales 2011 census age pyramid, 5-year bands 0-4 .. 85-89, 90+
# (QS103EW national aggregate, per mille).  Uniform within band.
_AGE_BAND_SHARES = np.array(
    [63, 56, 58, 63, 68, 69, 66, 67, 73, 73, 64, 57, 60, 47, 39, 33, 24, 15, 8],
    np.float64,
)

# KS608EW national occupation shares in OCC_* order (managers, professional,
# associate prof/tech, admin, skilled trades, caring/leisure, sales,
# process/plant, elementary -- the category the reference mislabels
# "Teaching", occupation_count.rs:54-55).
_OCCUPATION_SHARES = np.array(
    [0.109, 0.175, 0.128, 0.115, 0.114, 0.093, 0.084, 0.072, 0.111],
    np.float64,
)

#: fraction of workers whose commuting-area sampling fails (out-of-region
#: work OAs) and who therefore stay work == home
#: (simulator_builder.rs:758-772; 7.4% measured in the reference's own
#: Y&H init log, simulation_results/summary.md V1.3.0)
WORK_FROM_HOME_FRACTION = 0.074

#: reference's overcapacity factor when scaling buildings to required floor
#: space (simulator_builder.rs:892 BUILDING_PER_OCCUPATION_OVERCAPACITY)
_OVERCAPACITY = 1.1


def _sample_ages(rng, n: int) -> np.ndarray:
    band = rng.choice(
        len(_AGE_BAND_SHARES), size=n,
        p=_AGE_BAND_SHARES / _AGE_BAND_SHARES.sum(),
    )
    return (band * 5 + rng.integers(0, 5, n)).astype(np.int16)


def generate_census_like_world(
    n_citizens: int,
    n_output_areas: int = 64,
    *,
    seed: int = 42,
    oas_per_school: int = 4,
    mask_percentage: float = 0.8,
    commute_decay: float = 3.0,
    hub_fraction: float = 0.20,
    self_fraction: float = 0.25,
    mean_occupancy_ratio: float = 2.35,
    mega_fraction: float = 0.12,
    n_mega: int = 10,
) -> World:
    """Build a census-shaped :class:`World` of ``n_citizens``.

    ``commute_decay`` is the Laplace scale (in OA-grid units) of local
    commuting moves; ``hub_fraction`` of workers commute to
    attractiveness-weighted hub OAs regardless of distance;
    ``self_fraction`` work inside their home OA.  ``mean_occupancy_ratio``
    is the mean residents-per-household-building ratio (England 2011: 2.4
    per household; the reference's +1 rule then yields size-3 households
    for ratios in [2, 3), output_area.rs:139).
    """
    rng = np.random.default_rng(seed)
    n = int(n_citizens)
    n_oa = int(n_output_areas)
    side = int(np.ceil(np.sqrt(n_oa)))

    # --- per-OA populations: tight lognormal around the mean OA size ------
    oa_weight = rng.lognormal(0.0, 0.25, n_oa)
    oa_pop = rng.multinomial(n, oa_weight / oa_weight.sum())
    home_oa = np.repeat(
        np.arange(n_oa, dtype=np.int32), oa_pop
    )  # sorted by construction

    # --- citizens ----------------------------------------------------------
    age = _sample_ages(rng, n)
    is_student = age < MAX_STUDENT_AGE
    occ = np.empty(n, np.int8)
    occ[is_student] = OCC_STUDENT
    adults = ~is_student
    # every adult samples a KS608 occupation, like get_random_occupation for
    # every generated citizen (output_area.rs:157-163) -- the reference has
    # no unemployment
    occ[adults] = rng.choice(
        9, size=int(adults.sum()),
        p=_OCCUPATION_SHARES / _OCCUPATION_SHARES.sum(),
    ).astype(np.int8)
    mask_compliant = rng.random(n) < mask_percentage
    uses_transport = rng.random(n) < PUBLIC_TRANSPORT_PERCENTAGE

    # --- households: size = pop // buildings + 1 per OA (output_area.rs:139)
    ratio = np.clip(rng.normal(mean_occupancy_ratio, 0.35, n_oa), 1.5, 3.5)
    hh_size_per_oa = (oa_pop // np.maximum(oa_pop / ratio, 1).astype(np.int64)
                      + 1).astype(np.int64)
    pos_in_oa = _cumcount(home_oa)
    hh_in_oa = pos_in_oa // np.maximum(hh_size_per_oa[home_oa], 1)
    hh_key = home_oa.astype(np.int64) * (n + 2) + hh_in_oa
    _, household = _unique_sorted(hh_key)
    household = household.astype(np.int32)
    n_households = int(household.max()) + 1 if n else 0

    # --- commuting: self / local-decay / hub mixture -----------------------
    # Hub attractiveness: lognormal with a heavy tail (city centres).
    attract = rng.lognormal(0.0, 1.0, n_oa)
    attract /= attract.sum()

    hx, hy = home_oa % side, home_oa // side
    u = rng.random(n)
    # local move: discretised 2D Laplace on the OA grid, clipped inside
    dx = np.rint(rng.laplace(0.0, commute_decay, n)).astype(np.int64)
    dy = np.rint(rng.laplace(0.0, commute_decay, n)).astype(np.int64)
    wx = np.clip(hx + dx, 0, side - 1)
    wy = np.clip(hy + dy, 0, side - 1)
    local_oa = np.minimum(wy * side + wx, n_oa - 1).astype(np.int32)
    hub_oa = rng.choice(n_oa, size=n, p=attract).astype(np.int32)
    work_oa = np.where(
        u < self_fraction, home_oa,
        np.where(u < self_fraction + hub_fraction, hub_oa, local_oa),
    ).astype(np.int32)

    # teachers and students skip workplace-area sampling
    # (simulator_builder.rs:751-756); out-of-region sampling failures keep
    # work == home (:758-772)
    wfh = rng.random(n) < WORK_FROM_HOME_FRACTION
    is_worker = adults & ~wfh
    worker_idx = np.flatnonzero(is_worker)

    # --- workplaces: lognormal building stock, scaled + packed -------------
    # OSM-shaped floor areas: median ~250 m^2 with a heavy upper tail
    # (workplaces span corner shops to factories); capacity =
    # max(size, MINIMUM_FLOOR_SPACE_SIZE-clamp) * scale / density, min 20
    # (building.rs:237-250).
    w_bucket = work_oa[worker_idx].astype(np.int64) * 16 + occ[worker_idx]
    order = np.argsort(w_bucket, kind="stable")
    w_sorted = worker_idx[order]
    b_sorted = w_bucket[order]
    uniq_bucket, bucket_inv, bucket_counts = _unique_sorted(
        b_sorted, return_counts=True
    )
    dens = np.asarray(EMPLOYMENT_DENSITY_BY_OCCUPATION, np.int64)
    bucket_occ = (uniq_bucket % 16).astype(np.int64)
    required_space = bucket_counts * dens[bucket_occ]

    # Building stock per bucket: enough lognormal buildings to cover the
    # required space after the reference's ceil(required/available * 1.1)
    # scale.  Drawing per bucket keeps relative sizes (and therefore the
    # occupant-count distribution) heavy-tailed exactly like real stock fed
    # through assign_buildings_per_output_area.
    mean_floor = 400.0  # lognormal(5.5, 1.0) mean ~= e^6 ~ 403 m^2
    n_bld_per_bucket = np.maximum(
        (required_space / (mean_floor * 4)).astype(np.int64), 1
    )
    total_buildings = int(n_bld_per_bucket.sum())
    sizes = np.maximum(
        rng.lognormal(5.5, 1.0, total_buildings), MINIMUM_FLOOR_SPACE_SIZE
    )
    bld_bucket = np.repeat(
        np.arange(len(uniq_bucket), dtype=np.int64), n_bld_per_bucket
    )
    # per-bucket available space and the reference's integer scale
    avail = np.zeros(len(uniq_bucket))
    np.add.at(avail, bld_bucket, sizes)
    scale = np.ceil(required_space / avail * _OVERCAPACITY).astype(np.int64)
    cap = np.maximum(
        (sizes * scale[bld_bucket] / dens[bucket_occ[bld_bucket]]).astype(
            np.int64
        ),
        MIN_WORKPLACE_OCCUPANT_COUNT,
    )

    # Fill workers into buildings first-fit within their bucket: worker with
    # rank r in the bucket goes to the first building whose cumulative
    # capacity exceeds r (assign_workplaces_to_citizens_per_occupation,
    # simulator_builder.rs:1042-1109).
    bld_base = np.concatenate([[0], np.cumsum(n_bld_per_bucket)[:-1]])
    cumcap = np.cumsum(cap)
    bucket_cum0 = np.concatenate([[0], cumcap])[bld_base]
    rank = _cumcount(b_sorted)
    # searchsorted within each bucket's cumcap slice, done globally:
    # global position = first j with cumcap[j] - bucket_cum0 > rank
    target = bucket_cum0[bucket_inv] + rank
    w_building_global = np.searchsorted(cumcap, target, side="right")
    # overflow beyond total bucket capacity lands in the bucket's last
    # building (capacity was scaled to fit, so this is rare)
    last_bld = bld_base + n_bld_per_bucket - 1
    w_building_global = np.minimum(
        w_building_global, last_bld[bucket_inv]
    ).astype(np.int64)
    # compact to used buildings only (some may be empty)
    used, w_bld_compact = np.unique(w_building_global, return_inverse=True)
    n_workplaces = len(used)

    # --- mega sites: a handful of giant employers in the hub OAs -----------
    # Two real structures motivate this: (a) the v1.6-era builder crammed
    # overflow workers into whatever workplaces existed ("Ran out of
    # Workplaces 1 to assign workers", logs/v1.6_no_jabs_timing_steps.log),
    # producing buildings far beyond the floor-space rule; (b) real cities
    # have single-site mega-employers (York: university ~20k, hospital ~9k)
    # that the lognormal stock cannot produce.  Epidemiologically they set
    # the *deceleration* of the epidemic: mega sites ignite early, saturate,
    # and then contribute nothing — the measured v1.6 signature (early
    # r~0.016/h falling to ~0.005/h by 30% prevalence,
    # statistics_results/york_stats_results/v1.6).
    if mega_fraction > 0 and n_mega > 0 and len(worker_idx):
        pick = rng.random(len(w_sorted)) < mega_fraction
        k = int(pick.sum())
        if k:
            site_w = 1.0 / np.arange(1, n_mega + 1)  # Zipf: one dominant site
            site = rng.choice(n_mega, size=k, p=site_w / site_w.sum())
            mega_oa = np.argsort(attract)[::-1][:n_mega].astype(np.int32)
            w_bld_compact[pick] = n_workplaces + site
            work_oa[w_sorted[pick]] = mega_oa[site]
            n_workplaces += n_mega

    schools = build_schools(
        age=age, occ=occ, home_oa=home_oa, work_oa=work_oa,
        is_student=is_student, is_worker=is_worker, n_oa=n_oa,
        oas_per_school=oas_per_school,
    )

    # --- assemble: ids [households | workplaces | schools] -----------------
    workplace_base = n_households
    school_base = workplace_base + n_workplaces
    n_buildings = school_base + schools.n_schools

    home_building = household.astype(np.int32)
    work_building = home_building.copy()  # WFH default: work == home
    work_oa_final = home_oa.copy()

    work_building[w_sorted] = (workplace_base + w_bld_compact).astype(np.int32)
    work_oa_final[w_sorted] = work_oa[w_sorted]

    room, is_school_work = schools.apply(
        work_building, work_oa_final, school_base
    )

    return make_world(
        age=age,
        occupation=occ,
        home_building=home_building,
        work_building=work_building,
        home_oa=home_oa,
        work_oa=work_oa_final,
        room=room,
        is_school_work=is_school_work,
        uses_transport=uses_transport,
        mask_compliant=mask_compliant,
        n_buildings=n_buildings,
        n_rooms=schools.n_rooms,
        n_output_areas=n_oa,
    )

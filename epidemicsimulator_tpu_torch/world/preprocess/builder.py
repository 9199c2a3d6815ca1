"""World builder: census + OSM + OA polygons -> World arrays.

Host-side preprocessor reproducing the 8-phase init of
`sim/src/simulator_builder.rs:1162-1292` as vectorised numpy:

1.  OA setup from census + boundary polygons (:76-106)
2.  building -> OA assignment by polygon containment (:111-174; native C++
    grid index instead of the parallel quadtree)
3.  citizens + households per OA (:177-263 / output_area.rs:128-197:
    household_size = pop//buildings + 1, whole households generated until
    the population target is reached, ages/occupations sampled from the
    weighted census distributions, students when age < 18)
4.  schools: nearest school by centroid for students and Teaching-occupation
    workers (:265-710; scipy cKDTree replaces the Voronoi diagram — the
    nearest-seed query semantics are identical), classes of ~26.6 per age
    group plus 12-person staff offices (building.rs:344-443)
5.  workplace OA per remaining worker sampled from the commuting
    distribution (:717-860)
6.  workplaces first-fit packed per (OA, occupation) with
    floor-space/density capacities (:865-1109, building.rs:244-250);
    overflow creates standard-size synthetic buildings (the reference
    rotates through its building list and errors out — we keep everyone
    employed and note the count)
7.  initial infections are seeded by engine.state.init_state (:1111-1142)
8.  the World's own validation asserts (:1187-1201 analog)

Output: a cached, deterministic World (.npz) — the analog of the
reference's bincode OSM cache (osm_data/src/lib.rs:395-474).

The port's copy of ``epidemicsimulator_tpu/world/preprocess/builder.py``:
the same draws from ``np.random.default_rng(seed)`` in the same order and
the same ``cKDTree`` queries, so the same inputs give the JAX package's
``World`` bit for bit.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np

from ...config import (
    EMPLOYMENT_DENSITY_BY_OCCUPATION,
    MAX_STUDENT_AGE,
    MIN_WORKPLACE_OCCUPANT_COUNT,
    MINIMUM_FLOOR_SPACE_SIZE,
    OCC_STUDENT,
    OCC_TEACHING,
    OCC_UNEMPLOYED,
    PUBLIC_TRANSPORT_PERCENTAGE,
    AVERAGE_CLASS_SIZE,
    AVERAGE_OFFICE_SIZE,
)
from ...data.census.container import PERSON_ALL, CensusData
from ...data.osm.native import (
    CLASS_HOUSEHOLD,
    CLASS_SCHOOL,
    CLASS_WORKPLACE,
    assign_points_to_polygons,
)
from ..schema import World, make_world
from ...errors import SimInitializationError

log = logging.getLogger(__name__)


@dataclasses.dataclass
class OSMBuildings:
    """Classified buildings in national-grid coordinates."""

    classes: np.ndarray   # (B,) int32 CLASS_*
    east: np.ndarray      # (B,) float64
    north: np.ndarray     # (B,) float64
    areas: np.ndarray     # (B,) float64 m^2 (0 for node-only buildings)


def build_world(
    census: CensusData,
    osm: OSMBuildings,
    oa_rings: np.ndarray,
    oa_ring_starts: np.ndarray,
    oa_codes: list[str],
    *,
    seed: int = 0,
    mask_percentage: float = 0.8,
    timings: dict | None = None,
) -> World:
    """``timings``: optional dict filled with per-phase wall seconds — the
    analog of the reference's per-init-stage Timer prints
    (simulator_builder.rs:1168-1290); also logged at INFO."""
    t_last = time.perf_counter()

    def _mark(phase: str):
        nonlocal t_last
        now = time.perf_counter()
        dt = now - t_last
        t_last = now
        if timings is not None:
            timings[phase] = round(dt, 3)
        log.info("builder phase %s: %.2fs", phase, dt)

    rng = np.random.default_rng(seed)
    census = census.filter_incomplete_output_areas()
    n_oa = census.n_output_areas
    _mark("1_oa_setup")

    # ---- phase 2: building -> OA assignment --------------------------------
    poly_idx = assign_points_to_polygons(
        osm.east, osm.north, oa_rings, oa_ring_starts
    )
    # map polygon indices (oa_codes order) -> census OA rows
    code_to_row = {c: i for i, c in enumerate(census.oa_codes)}
    poly_row = np.array(
        [code_to_row.get(c, -1) for c in oa_codes], np.int64
    )
    b_oa = np.where(poly_idx >= 0, poly_row[np.clip(poly_idx, 0, None)], -1)
    keep = b_oa >= 0
    b_cls = osm.classes[keep]
    b_oa = b_oa[keep]
    b_area = osm.areas[keep]
    b_e, b_n = osm.east[keep], osm.north[keep]
    log.info("assigned %d/%d buildings to OAs", keep.sum(), len(keep))
    _mark("2_building_to_oa")

    households_mask = b_cls == CLASS_HOUSEHOLD
    workplace_mask = b_cls == CLASS_WORKPLACE
    school_mask = b_cls == CLASS_SCHOOL

    # ---- phase 3: citizens + households ------------------------------------
    pop = census.population_counts[:, PERSON_ALL].astype(np.int64)
    hh_per_oa = np.bincount(b_oa[households_mask], minlength=n_oa)

    ages_all, occs_all, home_oa_all, hh_all = [], [], [], []
    hh_counter = 0
    age_cdf = np.cumsum(census.age_histogram, axis=1).astype(np.float64)
    occ_cdf = np.cumsum(census.occupation_counts, axis=1).astype(np.float64)

    for oa in range(n_oa):
        p, nb = int(pop[oa]), int(hh_per_oa[oa])
        if p == 0:
            continue
        if nb == 0:
            log.warning("OA %s has no household buildings", census.oa_codes[oa])
            continue
        hs = p // nb + 1  # output_area.rs:139
        # whole households of size hs until the population target is met
        n_households = min(int(np.ceil(p / hs)), nb)
        n_cit = n_households * hs
        # ages from the weighted census histogram (age_structure.rs:51-62)
        u = rng.random(n_cit) * age_cdf[oa, -1]
        ages = np.searchsorted(age_cdf[oa], u, side="right").astype(np.int64)
        # occupations for adults (occupation_count.rs:112-124); the census
        # occupation table covers employed residents — citizens beyond it
        # stay unemployed in proportion
        u = rng.random(n_cit) * occ_cdf[oa, -1]
        occ = np.searchsorted(occ_cdf[oa], u, side="right").astype(np.int64)
        occs = np.where(ages < MAX_STUDENT_AGE, OCC_STUDENT, occ)
        ages_all.append(ages)
        occs_all.append(occs)
        home_oa_all.append(np.full(n_cit, oa, np.int64))
        hh_all.append(hh_counter + np.arange(n_cit) // hs)
        hh_counter += n_households

    age = np.concatenate(ages_all).astype(np.int16)
    occupation = np.concatenate(occs_all).astype(np.int8)
    home_oa = np.concatenate(home_oa_all).astype(np.int64)
    household = np.concatenate(hh_all).astype(np.int64)
    n = len(age)
    n_households = hh_counter
    log.info("generated %d citizens in %d households", n, n_households)
    _mark("3_citizens_households")

    mask_compliant = rng.random(n) < mask_percentage
    uses_transport = rng.random(n) < PUBLIC_TRANSPORT_PERCENTAGE

    home_building = household
    work_building = household.copy()       # default: unemployed work at home
    work_oa = home_oa.copy()
    room = np.full(n, -1, np.int64)
    is_school_work = np.zeros(n, bool)

    # ---- phase 4: schools ---------------------------------------------------
    school_ids = np.flatnonzero(school_mask)
    n_schools = len(school_ids)
    students = np.flatnonzero(occupation == OCC_STUDENT)
    teachers = np.flatnonzero(occupation == OCC_TEACHING)
    school_of = None
    if n_schools and len(students):
        from scipy.spatial import cKDTree

        # citizen position ~ a household building centroid of their OA: use
        # the OA centroid of its household buildings (nearest-school query
        # matches the reference's Voronoi-of-schools seed lookup)
        oa_cx = np.zeros(n_oa)
        oa_cy = np.zeros(n_oa)
        cnts = np.bincount(b_oa[households_mask], minlength=n_oa).clip(1)
        np.add.at(oa_cx, b_oa[households_mask], b_e[households_mask])
        np.add.at(oa_cy, b_oa[households_mask], b_n[households_mask])
        oa_cx /= cnts
        oa_cy /= cnts
        tree = cKDTree(np.c_[b_e[school_ids], b_n[school_ids]])
        _, school_of_oa = tree.query(np.c_[oa_cx, oa_cy])
        school_of = school_of_oa  # (n_oa,) nearest school index

    if school_of is not None:
        s_school = school_of[home_oa[students]]
        # classes per (school, age): reference splitting (building.rs:366-417)
        key = s_school.astype(np.int64) * 256 + age[students]
        order = np.argsort(key, kind="stable")
        s_sorted = students[order]
        key_sorted = key[order]
        uniq, inv, counts = np.unique(
            key_sorted, return_inverse=True, return_counts=True
        )
        class_counts = np.maximum(
            np.ceil(counts / AVERAGE_CLASS_SIZE).astype(np.int64), 1
        )
        class_sizes = np.ceil(counts / class_counts).astype(np.int64)
        pos = _cumcount(key_sorted)
        class_in_group = pos // class_sizes[inv]
        class_base = np.concatenate([[0], np.cumsum(class_counts)[:-1]])
        class_id = class_base[inv] + class_in_group
        n_classes = int(class_counts.sum())
        school_of_class = np.zeros(n_classes, np.int64)
        grp_school = (uniq // 256).astype(np.int64)
        for g in range(len(uniq)):
            school_of_class[class_base[g] : class_base[g] + class_counts[g]] = (
                grp_school[g]
            )

        # teachers: nearest school by home OA; one per class, two-pass like
        # the reference (class teachers first, leftovers to offices)
        t_school = school_of[home_oa[teachers]]
        t_order = np.argsort(t_school, kind="stable")
        teachers_sorted = teachers[t_order]
        t_school_sorted = t_school[t_order]
        t_rank = _cumcount(t_school_sorted)
        need = np.bincount(school_of_class, minlength=n_schools)
        take = t_rank < need[t_school_sorted]
        class_teachers = teachers_sorted[take]
        sch_class_base = np.concatenate([[0], np.cumsum(need)[:-1]])
        teacher_class = (
            sch_class_base[t_school_sorted[take]] + t_rank[take]
        )
        # deficit: conscript other workers of the same home OA group
        deficit = need - np.bincount(t_school_sorted[take], minlength=n_schools)
        if deficit.sum() > 0:
            others = np.flatnonzero(
                (occupation != OCC_STUDENT)
                & (occupation != OCC_TEACHING)
                & (occupation != OCC_UNEMPLOYED)
            )
            o_school = school_of[home_oa[others]]
            o_order = np.argsort(o_school, kind="stable")
            others, o_school = others[o_order], o_school[o_order]
            o_rank = _cumcount(o_school)
            already = np.bincount(t_school_sorted[take], minlength=n_schools)
            o_take = o_rank < deficit[o_school]
            class_teachers = np.concatenate([class_teachers, others[o_take]])
            teacher_class = np.concatenate(
                [
                    teacher_class,
                    sch_class_base[o_school[o_take]]
                    + already[o_school[o_take]]
                    + o_rank[o_take],
                ]
            )
            if len(class_teachers) < n_classes:
                raise SimInitializationError(
                    f"cannot staff {n_classes} classes with "
                    f"{len(class_teachers)} teachers"
                )
        # leftover teachers -> offices of 12 per school
        leftover = teachers_sorted[~take]
        lo_school = t_school_sorted[~take]
        lo_rank = _cumcount(lo_school)
        office_in_school = lo_rank // AVERAGE_OFFICE_SIZE
        offices_per_school = np.zeros(n_schools, np.int64)
        if len(leftover):
            np.maximum.at(offices_per_school, lo_school, office_in_school + 1)
        office_base = n_classes + np.concatenate(
            [[0], np.cumsum(offices_per_school)[:-1]]
        )
        n_rooms = int(n_classes + offices_per_school.sum())
    else:
        n_rooms = 0
        class_teachers = np.zeros(0, np.int64)
    _mark("4_schools")

    # ---- phases 5+6: workplace OA sampling + first-fit packing -------------
    school_citizen = np.zeros(n, bool)
    if school_of is not None:
        school_citizen[s_sorted] = True
        school_citizen[class_teachers] = True
        if len(leftover):
            school_citizen[leftover] = True
    workers = np.flatnonzero(
        (occupation != OCC_STUDENT)
        & (occupation != OCC_UNEMPLOYED)
        & ~school_citizen
    )

    # sample work OA from each home OA's commuting distribution
    ch, cw, cc = census.commute_matrix()
    order = np.argsort(ch, kind="stable")
    ch, cw, cc = ch[order], cw[order], cc[order]
    row_starts = np.searchsorted(ch, np.arange(n_oa + 1))
    w_oa = np.empty(len(workers), np.int64)
    for oa in range(n_oa):
        sel = np.flatnonzero(home_oa[workers] == oa)
        if not len(sel):
            continue
        lo, hi = row_starts[oa], row_starts[oa + 1]
        if lo == hi:
            w_oa[sel] = oa
            continue
        weights = cc[lo:hi].astype(np.float64)
        cdf = np.cumsum(weights)
        u = rng.random(len(sel)) * cdf[-1]
        w_oa[sel] = cw[lo + np.searchsorted(cdf, u, side="right")]
    _mark("5_workplace_oa_sampling")

    # first-fit pack real OSM workplace buildings per (work OA, occupation);
    # overflow beyond physical capacity -> synthetic standard buildings
    wp_ids = np.flatnonzero(workplace_mask)
    wp_oa = b_oa[wp_ids]
    wp_area = np.maximum(b_area[wp_ids], MINIMUM_FLOOR_SPACE_SIZE)
    densities = np.asarray(EMPLOYMENT_DENSITY_BY_OCCUPATION, np.int64)

    # order workers by (work_oa, occupation) and buildings by work OA
    wk_key = w_oa * 16 + occupation[workers]
    wk_order = np.argsort(wk_key, kind="stable")
    workers_sorted = workers[wk_order]
    wkey_sorted = wk_key[wk_order]

    bp_order = np.argsort(wp_oa, kind="stable")
    wp_ids, wp_oa, wp_area = wp_ids[bp_order], wp_oa[bp_order], wp_area[bp_order]
    bld_starts = np.searchsorted(wp_oa, np.arange(n_oa + 1))

    workplace_base = n_households
    next_wp = 0
    overflow = 0
    wp_assign = np.empty(len(workers_sorted), np.int64)
    wp_table_oa: list[int] = []
    pos_in_key = _cumcount(wkey_sorted)
    grp_uniq, grp_inv, grp_counts = np.unique(
        wkey_sorted, return_inverse=True, return_counts=True
    )
    for g in range(len(grp_uniq)):
        oa = int(grp_uniq[g] // 16)
        occ = int(grp_uniq[g] % 16)
        count = int(grp_counts[g])
        lo, hi = bld_starts[oa], bld_starts[oa + 1]
        caps = np.maximum(
            wp_area[lo:hi] // densities[occ], MIN_WORKPLACE_OCCUPANT_COUNT
        ).astype(np.int64)
        std_cap = max(
            MINIMUM_FLOOR_SPACE_SIZE // int(densities[occ]),
            MIN_WORKPLACE_OCCUPANT_COUNT,
        )
        # cumulative capacities over this OA's buildings, then synthetic
        cum = np.concatenate([[0], np.cumsum(caps)])
        total_real = int(cum[-1])
        sel = slice(
            int(np.searchsorted(grp_inv, g)),
            int(np.searchsorted(grp_inv, g, side="right")),
        )
        ranks = pos_in_key[sel]
        in_real = ranks < total_real
        b_index = np.searchsorted(cum, ranks[in_real], side="right") - 1
        ids = np.empty(count, np.int64)
        ids[in_real] = next_wp + b_index
        n_real_used = int(b_index.max()) + 1 if in_real.any() else 0
        extra = ranks[~in_real] - total_real
        n_extra = int(extra.max() // std_cap) + 1 if (~in_real).any() else 0
        ids[~in_real] = next_wp + n_real_used + (extra // std_cap)
        overflow += int((~in_real).sum())
        wp_assign[sel] = workplace_base + ids
        next_wp += n_real_used + n_extra
        wp_table_oa.extend([oa] * (n_real_used + n_extra))

    n_workplaces = next_wp
    work_building[workers_sorted] = wp_assign
    work_oa[workers_sorted] = w_oa[wk_order]
    if overflow:
        log.info("%d workers placed in synthetic overflow workplaces", overflow)
    _mark("6_workplace_packing")

    # ---- schools get building ids after workplaces --------------------------
    school_b_base = n_households + n_workplaces
    if school_of is not None:
        sch_oa = b_oa[school_ids]
        work_building[s_sorted] = school_b_base + school_of_class[class_id]
        work_oa[s_sorted] = sch_oa[school_of_class[class_id]]
        room[s_sorted] = class_id
        is_school_work[s_sorted] = True
        work_building[class_teachers] = (
            school_b_base + school_of_class[teacher_class]
        )
        work_oa[class_teachers] = sch_oa[school_of_class[teacher_class]]
        room[class_teachers] = teacher_class
        is_school_work[class_teachers] = True
        if len(leftover):
            work_building[leftover] = school_b_base + lo_school
            work_oa[leftover] = sch_oa[lo_school]
            room[leftover] = office_base[lo_school] + office_in_school
            is_school_work[leftover] = True

    n_buildings = school_b_base + max(n_schools, 1)
    room = np.where(room < 0, n_rooms, room)
    _mark("7_school_building_ids")

    world = make_world(
        age=age,
        occupation=occupation,
        home_building=home_building,
        work_building=work_building,
        home_oa=home_oa,
        work_oa=work_oa,
        room=room,
        is_school_work=is_school_work,
        uses_transport=uses_transport,
        mask_compliant=mask_compliant,
        n_buildings=n_buildings,
        n_rooms=n_rooms,
        n_output_areas=n_oa,
    )
    _mark("8_world_tables")
    return world


def _cumcount(sorted_ids: np.ndarray) -> np.ndarray:
    n = len(sorted_ids)
    if n == 0:
        return np.zeros(0, np.int64)
    idx = np.arange(n, dtype=np.int64)
    boundary = np.empty(n, np.bool_)
    boundary[0] = True
    boundary[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = np.maximum.accumulate(np.where(boundary, idx, 0))
    return idx - seg_start


def dedupe_close_buildings(
    classes, east, north, which=(1, 2), radius=500.0
):
    """Merge Schools/Hospitals within `radius` manhattan metres
    (osm_data/src/lib.rs:59-67, :413-458)."""
    keep = np.ones(len(classes), bool)
    for cls in which:
        ids = np.flatnonzero(classes == cls)
        if len(ids) < 2:
            continue
        from scipy.spatial import cKDTree

        # manhattan metric == minkowski p=1
        tree = cKDTree(np.c_[east[ids], north[ids]])
        pairs = tree.query_pairs(radius, p=1.0)
        dead = set()
        for a, b in sorted(pairs):
            if a not in dead:
                dead.add(b)
        keep[ids[list(dead)]] = False
    return keep

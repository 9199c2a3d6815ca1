"""Synthetic world generator: distribution-faithful toy worlds.

A numpy copy of ``epidemicsimulator_tpu/world/synthetic.py``: the same
seed gives the same world, lane for lane.

Produces a :class:`World` with the same structural statistics as the
reference's world builder (sim/src/simulator_builder.rs:1144-1292) without
census/OSM inputs: households of ~HOUSEHOLD_SIZE (output_area.rs:139),
age-dependent student/worker split (config.rs:38), occupation-sampled
workplaces bin-packed to employment-density capacities
(simulator_builder.rs:865-1109, building.rs:244-250), schools with
age-grouped classes of ~26.6 students plus a teacher and 12-person staff
offices (building.rs:344-443), 20% public-transport use (citizen.rs:159) and
80% mask compliance (output_area.rs:119 with disease.mask_percentage).

Fully vectorised numpy so the 3.5M-citizen benchmark world builds in seconds
on one host core.
"""

from __future__ import annotations

import numpy as np

from ..config import (
    AVERAGE_CLASS_SIZE,
    AVERAGE_OFFICE_SIZE,
    EMPLOYMENT_DENSITY_BY_OCCUPATION,
    HOUSEHOLD_SIZE,
    MAX_STUDENT_AGE,
    MIN_WORKPLACE_OCCUPANT_COUNT,
    MINIMUM_FLOOR_SPACE_SIZE,
    OCC_STUDENT,
    OCC_TEACHING,
    OCC_UNEMPLOYED,
    PUBLIC_TRANSPORT_PERCENTAGE,
)
from .schema import World, make_world


class WorldBuildError(RuntimeError):
    """The synthetic world cannot be built as asked."""

# Rough adult occupation mix (KS608-shaped; exact values irrelevant for the
# toy world — the census preprocessor supplies real ones).
_OCCUPATION_WEIGHTS = np.array(
    [0.11, 0.20, 0.13, 0.11, 0.11, 0.09, 0.08, 0.07, 0.05], np.float64
)
_UNEMPLOYED_FRACTION = 0.06

# Capacity of a standard synthetic workplace: the reference assumes
# WORKPLACE_BUILDING_SIZE=1000 m^2 clamped up to MINIMUM_FLOOR_SPACE_SIZE
# (building.rs:239), divided by the occupation density, min 20 occupants.
_WORKPLACE_CAPACITY = tuple(
    max(MINIMUM_FLOOR_SPACE_SIZE // d, MIN_WORKPLACE_OCCUPANT_COUNT)
    for d in EMPLOYMENT_DENSITY_BY_OCCUPATION
)


def _unique_sorted(keys: np.ndarray, return_counts: bool = False):
    """np.unique(keys, return_inverse=True[, return_counts]) for PRE-SORTED
    keys — one boundary pass instead of np.unique's internal re-sort."""
    n = len(keys)
    if n == 0:
        empty = np.zeros(0, keys.dtype)
        inv = np.zeros(0, np.int64)
        return (empty, inv, inv.copy()) if return_counts else (empty, inv)
    boundary = np.empty(n, np.bool_)
    boundary[0] = True
    np.not_equal(keys[1:], keys[:-1], out=boundary[1:])
    inv = np.cumsum(boundary) - 1
    uniq = keys[boundary]
    if return_counts:
        starts = np.flatnonzero(boundary)
        counts = np.diff(np.append(starts, n))
        return uniq, inv, counts
    return uniq, inv


def _cumcount(sorted_group_ids: np.ndarray) -> np.ndarray:
    """Position of each element within its run of equal ids (ids sorted)."""
    n = len(sorted_group_ids)
    if n == 0:
        return np.zeros(0, np.int64)
    idx = np.arange(n, dtype=np.int64)
    boundary = np.empty(n, np.bool_)
    boundary[0] = True
    boundary[1:] = sorted_group_ids[1:] != sorted_group_ids[:-1]
    seg_start = np.maximum.accumulate(np.where(boundary, idx, 0))
    return idx - seg_start


def generate_synthetic_world(
    n_citizens: int,
    n_output_areas: int = 64,
    *,
    seed: int = 42,
    oas_per_school: int = 4,
    commute_spread: float = 3.0,
    mask_percentage: float = 0.8,
) -> World:
    rng = np.random.default_rng(seed)
    n = int(n_citizens)
    n_oa = int(n_output_areas)

    # --- citizens: age, occupation, compliance, transport ---------------
    age = rng.integers(0, 90, n).astype(np.int16)
    is_student = age < MAX_STUDENT_AGE

    occ = np.empty(n, np.int8)
    occ[is_student] = OCC_STUDENT
    adults = ~is_student
    n_adult = int(adults.sum())
    u = rng.random(n_adult)
    unemployed = u < _UNEMPLOYED_FRACTION
    occ_adult = rng.choice(
        9, size=n_adult, p=_OCCUPATION_WEIGHTS / _OCCUPATION_WEIGHTS.sum()
    ).astype(np.int8)
    occ_adult[unemployed] = OCC_UNEMPLOYED
    occ[adults] = occ_adult

    mask_compliant = rng.random(n) < mask_percentage
    uses_transport = rng.random(n) < PUBLIC_TRANSPORT_PERCENTAGE

    # --- households and home OAs ----------------------------------------
    # Citizens fill households of HOUSEHOLD_SIZE in home-OA order, the
    # synthetic analog of generate_citizens_with_households
    # (output_area.rs:128-197).
    home_oa = np.sort(rng.integers(0, n_oa, n, dtype=np.int32))
    # Household runs never cross OA boundaries: chunk positions within each
    # OA, then enumerate (oa, chunk) pairs.
    pos_in_oa = _cumcount(home_oa)
    hh_in_oa = pos_in_oa // HOUSEHOLD_SIZE
    hh_key = home_oa.astype(np.int64) * (n // HOUSEHOLD_SIZE + 2) + hh_in_oa
    _, household = _unique_sorted(hh_key)  # hh_key is sorted (home_oa is)
    household = household.astype(np.int32)
    n_households = int(household.max()) + 1 if n else 0

    # --- commuting: work OA from a locally-concentrated distribution ----
    # (resides_vs_workplace.rs:100-151 is a sparse, geographically local
    # commuting matrix; a discretised Laplace over OA index mimics it.)
    shift = np.rint(rng.laplace(0.0, commute_spread, n)).astype(np.int64)
    work_oa = np.clip(home_oa.astype(np.int64) + shift, 0, n_oa - 1).astype(np.int32)

    # --- workplaces: bucket by (work_oa, occupation), pack to capacity ---
    is_worker = adults & (occ != OCC_UNEMPLOYED)
    worker_idx = np.flatnonzero(is_worker)
    w_bucket = work_oa[worker_idx].astype(np.int64) * 16 + occ[worker_idx]
    order = np.argsort(w_bucket, kind="stable")
    w_sorted = worker_idx[order]
    b_sorted = w_bucket[order]
    pos = _cumcount(b_sorted)
    caps = np.asarray(_WORKPLACE_CAPACITY, np.int64)[occ[w_sorted]]
    slot = pos // caps
    # Enumerate workplaces: unique (bucket, slot) pairs in sorted order.
    pair = b_sorted * (n // MIN_WORKPLACE_OCCUPANT_COUNT + 2) + slot
    uniq, inv = _unique_sorted(pair)  # b_sorted sorted, slot rises within run
    n_workplaces = len(uniq)

    schools = build_schools(
        age=age, occ=occ, home_oa=home_oa, work_oa=work_oa,
        is_student=is_student, is_worker=is_worker, n_oa=n_oa,
        oas_per_school=oas_per_school,
    )

    # --- assemble global building table ----------------------------------
    # ids: [households | workplaces | schools]
    workplace_base = n_households
    school_base = workplace_base + n_workplaces
    n_buildings = school_base + schools.n_schools

    home_building = household.astype(np.int32)
    work_building = home_building.copy()  # unemployed default: work == home
    work_oa_final = home_oa.copy()

    work_building[w_sorted] = (workplace_base + inv).astype(np.int32)
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


class SchoolAssignment:
    """School/class/office assignment shared by the synthetic generators
    (the reference's build_schools phase, simulator_builder.rs:265-710):
    classes of ~26.6 students per (school, age), one teacher per class drawn
    from Teaching-occupation workers, leftovers in 12-person offices."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def apply(self, work_building, work_oa_final, school_base):
        """Write school workers into the building/room lanes.  Mutates
        ``work_building``/``work_oa_final``; returns (room, is_school_work).
        """
        n = len(work_building)
        room = np.full(n, self.n_rooms, np.int32)
        is_school_work = np.zeros(n, np.bool_)

        work_building[self.s_sorted] = (
            school_base + self.school_of_class[self.class_id]
        ).astype(np.int32)
        work_oa_final[self.s_sorted] = self.school_oa[
            self.school_of_class[self.class_id]
        ]
        room[self.s_sorted] = self.class_id.astype(np.int32)
        is_school_work[self.s_sorted] = True

        work_building[self.class_teachers] = (
            school_base + self.school_of_class[self.teacher_class]
        ).astype(np.int32)
        work_oa_final[self.class_teachers] = self.school_oa[
            self.school_of_class[self.teacher_class]
        ]
        room[self.class_teachers] = self.teacher_class.astype(np.int32)
        is_school_work[self.class_teachers] = True

        if len(self.leftover):
            work_building[self.leftover] = (
                school_base + self.leftover_school
            ).astype(np.int32)
            work_oa_final[self.leftover] = self.school_oa[self.leftover_school]
            room[self.leftover] = self.leftover_room.astype(np.int32)
            is_school_work[self.leftover] = True
        return room, is_school_work


def build_schools(
    *, age, occ, home_oa, work_oa, is_student, is_worker, n_oa,
    oas_per_school,
) -> SchoolAssignment:
    n_schools = max(1, (n_oa + oas_per_school - 1) // oas_per_school)
    school_of_oa = (np.arange(n_oa) // oas_per_school).astype(np.int32)
    school_oa = (np.arange(n_schools, dtype=np.int32) * oas_per_school).clip(
        0, n_oa - 1
    )

    student_idx = np.flatnonzero(is_student)
    s_school = school_of_oa[home_oa[student_idx]]
    # Classes per (school, age) group: ceil(n/26.6) classes, students chunked
    # into ceil(n/classes)-sized classes (building.rs:366-417).
    s_key = s_school.astype(np.int64) * 256 + age[student_idx]
    s_order = np.argsort(s_key, kind="stable")
    s_sorted = student_idx[s_order]
    key_sorted = s_key[s_order]
    group_uniq, group_inv, group_counts = _unique_sorted(
        key_sorted, return_counts=True
    )
    class_counts = np.maximum(
        np.ceil(group_counts / AVERAGE_CLASS_SIZE).astype(np.int64), 1
    )
    class_sizes = np.ceil(group_counts / class_counts).astype(np.int64)
    pos_in_group = _cumcount(key_sorted)
    class_in_group = pos_in_group // class_sizes[group_inv]
    class_base = np.concatenate([[0], np.cumsum(class_counts)[:-1]])
    class_id = (class_base[group_inv] + class_in_group).astype(np.int64)
    n_classes = int(class_counts.sum())

    # Teachers: one per class, drawn from Teaching-occupation workers whose
    # work OA falls in the school's group; shortfall conscripted from other
    # workers in the group (the toy stand-in for the reference's
    # nearest-school Voronoi assignment, simulator_builder.rs:265-710).
    school_of_group = (group_uniq // 256).astype(np.int64)
    school_of_class = np.repeat(school_of_group, class_counts)

    teacher_pool = np.flatnonzero(is_worker & (occ == OCC_TEACHING))
    pool_school = school_of_oa[work_oa[teacher_pool]].astype(np.int64)
    classes_per_school = np.bincount(school_of_class, minlength=n_schools)

    # Assign: sort pool by school, take the first classes_per_school[s].
    p_order = np.argsort(pool_school, kind="stable")
    teacher_pool = teacher_pool[p_order]
    pool_school = pool_school[p_order]
    pool_rank = _cumcount(pool_school)
    needed = classes_per_school[pool_school]
    take = pool_rank < needed
    class_teachers = teacher_pool[take]
    # Map each taken teacher to a concrete class id of its school.
    sch_class_base = np.concatenate([[0], np.cumsum(classes_per_school)[:-1]])
    # class ids are grouped by (school, age) which is school-major, so the
    # classes of school s are exactly [sch_class_base[s], +classes_per_school)
    teacher_class = sch_class_base[pool_school[take]] + pool_rank[take]

    deficit_schools = classes_per_school - np.bincount(
        pool_school[take], minlength=n_schools
    )
    if deficit_schools.sum() > 0:
        # Conscript non-teaching workers by work-OA group for missing classes.
        extra_needed = deficit_schools.sum()
        others = np.flatnonzero(is_worker & (occ != OCC_TEACHING))
        o_school = school_of_oa[work_oa[others]].astype(np.int64)
        o_order = np.argsort(o_school, kind="stable")
        others, o_school = others[o_order], o_school[o_order]
        o_rank = _cumcount(o_school)
        already = np.bincount(pool_school[take], minlength=n_schools)
        o_take = o_rank < deficit_schools[o_school]
        conscripts = others[o_take]
        conscript_class = (
            sch_class_base[o_school[o_take]] + already[o_school[o_take]] + o_rank[o_take]
        )
        class_teachers = np.concatenate([class_teachers, conscripts])
        teacher_class = np.concatenate([teacher_class, conscript_class])
        if len(class_teachers) < n_classes:
            raise WorldBuildError(
                f"synthetic world cannot staff {n_classes} classes with "
                f"{len(class_teachers)} teachers"
            )

    # Leftover teachers go to offices of AVERAGE_OFFICE_SIZE per school
    # (building.rs:421-432).
    leftover = teacher_pool[~take]
    leftover_school = pool_school[~take]
    lo_rank = _cumcount(leftover_school)  # still sorted by school
    office_in_school = lo_rank // AVERAGE_OFFICE_SIZE
    offices_per_school = np.zeros(n_schools, np.int64)
    if len(leftover):
        np.maximum.at(offices_per_school, leftover_school, office_in_school + 1)
    office_base = n_classes + np.concatenate(
        [[0], np.cumsum(offices_per_school)[:-1]]
    )
    leftover_room = office_base[leftover_school] + office_in_school
    n_rooms = int(n_classes + offices_per_school.sum())

    return SchoolAssignment(
        n_schools=n_schools,
        n_rooms=n_rooms,
        school_oa=school_oa,
        school_of_class=school_of_class,
        s_sorted=s_sorted,
        class_id=class_id,
        class_teachers=class_teachers,
        teacher_class=teacher_class,
        leftover=leftover,
        leftover_school=leftover_school,
        leftover_room=leftover_room,
    )

"""Teachers-per-local-authority table (DfE school workforce census).

Counterpart of `load_census_data/src/tables/teachers_per_local_authority.rs`.
The reference declares the full DfE "School Workforce in England" CSV row
schema (teachers_per_local_authority.rs:31-123: per-LA, per-school-type FTE
and headcount staffing columns) keyed by ``new_la_code``
(:126-129 ``get_geography_code``), but the table is commented out of the
build (tables/mod.rs:36) and its aggregation body is bit-rotted — it is a
copy of the age-structure parser referencing fields the record type does not
have, so it never compiled.  What is reimplemented here is the *intended*
surface:

* the same CSV schema, keyed by ``new_la_code``;
* per-LA aggregation over school types into a ``TeacherRecord`` carrying the
  staffing quantities the world-builder could consume (teacher counts feed
  the school-construction phase, simulator_builder.rs:265-710, which today
  derives teacher demand purely from class counts);
* the reference's validation semantics: an empty record list and mismatched
  geography codes are typed parse errors (taxonomy from
  parsing_error.rs via ``errors.py``).

Numbers are FTE (full-time-equivalent) unless prefixed ``hc_`` (headcount),
matching the DfE column naming preserved in the schema.

The port's copy of ``epidemicsimulator_tpu/data/census/teachers.py``.
``parse_teachers`` takes the CSV's rows, as dicts of column to text (None
where pandas would read a missing value), instead of a DataFrame; the
records are the same.
"""

from __future__ import annotations

import csv
import dataclasses

import numpy as np

from ...errors import MismatchedDataError, MissingDataError
from .container import NA_STRINGS, to_numbers

# The DfE workforce columns the aggregation consumes; the full reference
# schema (teachers_per_local_authority.rs:31-123) has ~100 columns — all
# others ride along in the rows untouched.
_REQUIRED = (
    "new_la_code",
    "la_name",
    "school_type",
    "number_schools",
    "fte_all_teachers",
    "fte_classroom_teachers",
    "fte_teaching_assistants",
    "hc_all_teachers",
)

# The reference rejects this region outright (teachers_per_local_authority.rs
# :163-165 "Area code is not supported!") — the workforce table has no
# Yorkshire & Humber rows at OA granularity.
_UNSUPPORTED_REGIONS = frozenset({"Yorkshire and The Humber"})


@dataclasses.dataclass(frozen=True)
class TeacherRecord:
    """Per-local-authority teacher staffing aggregate."""

    local_authority_code: str
    la_name: str
    number_schools: int
    fte_all_teachers: float
    fte_classroom_teachers: float
    fte_teaching_assistants: float
    hc_all_teachers: int
    # per-school-type breakdown: school_type -> fte_all_teachers
    fte_by_school_type: dict[str, float] = dataclasses.field(
        default_factory=dict
    )

    @property
    def teachers_per_school(self) -> float:
        """Mean FTE teachers per school in this LA — the quantity the
        school-builder would calibrate class/office staffing against."""
        return self.fte_all_teachers / max(self.number_schools, 1)


def _num(rows: list[dict], column: str) -> np.ndarray:
    # DfE publishes suppressed cells as "x"/"z"/".."; treat as 0 like any
    # missing observation.
    return to_numbers(["" if r[column] is None else r[column] for r in rows])


def _text(value) -> str:
    return "nan" if value is None else str(value)


def parse_teachers(rows: list[dict]) -> dict[str, TeacherRecord]:
    """Aggregate raw workforce rows into one ``TeacherRecord`` per LA.

    Mirrors the TableEntry group-by-geography generation (tables/mod.rs:39-76)
    with the validation the reference's try_from intended: empty input and
    geography mismatches raise typed errors.
    """
    if len(rows) == 0:
        raise MissingDataError(
            "PreProcessingRecord list is empty, can't build a TeacherRecord!"
        )
    missing = [c for c in _REQUIRED if c not in rows[0]]
    if missing:
        raise MissingDataError(f"teacher workforce CSV lacks columns {missing}")
    if "region_name" in rows[0]:
        bad = {r["region_name"] for r in rows} & _UNSUPPORTED_REGIONS
        if bad:
            raise MismatchedDataError(f"Area code is not supported: {bad}")

    groups: dict[str, list[dict]] = {}
    for r in rows:
        if r["new_la_code"] is not None:  # groupby drops missing keys
            groups.setdefault(r["new_la_code"], []).append(r)

    out: dict[str, TeacherRecord] = {}
    for code in sorted(groups):
        grp = groups[code]
        names = list(dict.fromkeys(r["la_name"] for r in grp))
        if len(names) > 1:
            raise MismatchedDataError(
                f"Mis matching geography codes for pre processing records: "
                f"LA {code} maps to names {sorted(names)}"
            )
        fte = _num(grp, "fte_all_teachers")
        types = [_text(r["school_type"]) for r in grp]
        by_type = {t: float(v) for t, v in zip(types, fte)}
        # "Total" rows (DfE publishes per-type + a Total row) are the
        # aggregate; without one, sum the types.
        if "Total" in by_type:
            tot = [r for r, t in zip(grp, types) if t == "Total"]
            n_schools = int(_num(tot, "number_schools")[0])
            fte_all = float(_num(tot, "fte_all_teachers")[0])
            fte_cls = float(_num(tot, "fte_classroom_teachers")[0])
            fte_ta = float(_num(tot, "fte_teaching_assistants")[0])
            hc_all = int(_num(tot, "hc_all_teachers")[0])
        else:
            n_schools = int(_num(grp, "number_schools").sum())
            fte_all = float(fte.sum())
            fte_cls = float(_num(grp, "fte_classroom_teachers").sum())
            fte_ta = float(_num(grp, "fte_teaching_assistants").sum())
            hc_all = int(_num(grp, "hc_all_teachers").sum())
        out[str(code)] = TeacherRecord(
            local_authority_code=str(code),
            la_name=_text(names[0]),
            number_schools=n_schools,
            fte_all_teachers=fte_all,
            fte_classroom_teachers=fte_cls,
            fte_teaching_assistants=fte_ta,
            hc_all_teachers=hc_all,
            fte_by_school_type={
                k: v for k, v in by_type.items() if k != "Total"
            },
        )
    return out


def read_rows(path: str) -> list[dict]:
    """The rows of a CSV file as ``pd.read_csv(path, dtype=str)`` reads
    them: pandas' default missing-value strings become None."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        return [{k: None if v is None or v in NA_STRINGS else v
                 for k, v in row.items()} for row in csv.DictReader(f)]


def load_teachers(path: str) -> dict[str, TeacherRecord]:
    """Read a DfE workforce CSV from disk and aggregate per LA."""
    return parse_teachers(read_rows(path))

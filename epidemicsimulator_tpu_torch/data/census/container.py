"""CensusData: per-output-area aggregates of the four NOMIS tables.

The numpy equivalent of `load_census_data/src/lib.rs` — long-format CSV
rows are grouped by output area into dense arrays:

* age histogram, 101 bins (age_structure.rs:118-131: C_AGE is 1-based,
  bin 100 is "100 and over")
* occupation counts, 9 categories (occupation_count.rs:140-188; the "All"
  row is skipped)
* person-type population counts + area/density (KS101,
  population_and_density rs:100-160)
* residence->workplace commuting counts as a sparse matrix
  (resides_vs_workplace.rs:100-151; zero-count entries dropped)

``filter_incomplete_output_areas`` keeps only OAs present in all tables
(lib.rs:393-446).

The port's copy of ``epidemicsimulator_tpu/data/census/container.py``,
read with the ``csv`` module instead of pandas: the same files give the
same ``CensusData``, array for array and dtype for dtype.  The parsers
return a dict of columns (lists or numpy arrays) where the JAX package's
return a DataFrame.  One deliberate difference: a missing table file
raises :class:`MissingDataError` naming the table.
"""

from __future__ import annotations

import bisect
import csv
import dataclasses
import os
import re

import numpy as np

from ...errors import MissingDataError, OutOfBoundsError
from .tables import (
    AREA_CELL,
    DENSITY_CELL,
    OCCUPATION_ALL_CELL,
    OCCUPATION_CELL_NAMES,
    PERSON_TYPE_CELLS,
    CensusTable,
    TABLE_SPECS,
)

PERSON_ALL, PERSON_MALE, PERSON_FEMALE = 0, 1, 2
PERSON_HOUSEHOLD, PERSON_COMMUNAL, PERSON_SCHOOLCHILD = 3, 4, 5


@dataclasses.dataclass
class CensusData:
    """Dense per-OA census aggregates, aligned on ``oa_codes``."""

    oa_codes: list[str]                    # sorted unique codes
    age_histogram: np.ndarray              # (n_oa, 101) int32
    occupation_counts: np.ndarray          # (n_oa, 9) int32
    population_counts: np.ndarray          # (n_oa, 6) int32 person types
    area_hectares: np.ndarray              # (n_oa,) float32
    density: np.ndarray                    # (n_oa,) float32
    # sparse commuting matrix in COO: home row index, work OA code string
    # kept separately because workplace OAs may lie outside the region
    commute_home: np.ndarray               # (nnz,) int32 row index
    commute_work_code: np.ndarray          # (nnz,) object: workplace OA code
    commute_count: np.ndarray              # (nnz,) int32

    @property
    def n_output_areas(self) -> int:
        return len(self.oa_codes)

    def index_of(self, code: str) -> int:
        i = bisect.bisect_left(self.oa_codes, code)
        if i == len(self.oa_codes) or self.oa_codes[i] != code:
            raise KeyError(code)
        return i

    # ------------------------------------------------------------------
    def filter_incomplete_output_areas(self) -> "CensusData":
        """Intersect OAs complete in all tables (lib.rs:393-446), and drop
        commuting entries whose workplace OA is outside the intersection."""
        ok = (
            (self.age_histogram.sum(axis=1) > 0)
            & (self.occupation_counts.sum(axis=1) > 0)
            & (self.population_counts[:, PERSON_ALL] > 0)
        )
        has_commute = np.zeros(self.n_output_areas, bool)
        has_commute[np.unique(self.commute_home)] = True
        ok &= has_commute

        keep = np.flatnonzero(ok)
        remap = -np.ones(self.n_output_areas, np.int64)
        remap[keep] = np.arange(len(keep))
        codes = [self.oa_codes[i] for i in keep]
        code_set = set(codes)

        cm_keep = remap[self.commute_home] >= 0
        cm_keep &= np.array(
            [c in code_set for c in self.commute_work_code], bool
        )
        return CensusData(
            oa_codes=codes,
            age_histogram=self.age_histogram[keep],
            occupation_counts=self.occupation_counts[keep],
            population_counts=self.population_counts[keep],
            area_hectares=self.area_hectares[keep],
            density=self.density[keep],
            commute_home=remap[self.commute_home[cm_keep]].astype(np.int32),
            commute_work_code=self.commute_work_code[cm_keep],
            commute_count=self.commute_count[cm_keep],
        )

    def commute_matrix(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """COO (home_idx, work_idx, count) with work codes resolved to local
        indices; entries with unknown work OAs are dropped."""
        idx = {c: i for i, c in enumerate(self.oa_codes)}
        work_idx = np.array(
            [idx.get(c, -1) for c in self.commute_work_code], np.int64
        )
        keep = work_idx >= 0
        return (
            self.commute_home[keep].astype(np.int64),
            work_idx[keep],
            self.commute_count[keep].astype(np.int64),
        )


# ---------------------------------------------------------------------------
# CSV reading with pandas' semantics
# ---------------------------------------------------------------------------

# the strings pandas.read_csv reads as a missing value by default
NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
))

# what pandas.to_numeric(errors="coerce") reads as a number
_DECIMAL = re.compile(r"\s*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?\s*")
_INFINITY = re.compile(r"[+-]?inf(?:inity)?", re.IGNORECASE)


def is_number(text: str) -> bool:
    return bool(_DECIMAL.fullmatch(text) or _INFINITY.fullmatch(text))


def to_numbers(values) -> np.ndarray:
    """float64 of ``pd.to_numeric(values, errors="coerce").fillna(0)``:
    text that is no number (``""``, ``"x"``, ``".."``) counts 0."""
    return np.array([float(v) if is_number(v) else 0.0 for v in values],
                    np.float64)


def to_ints(values) -> np.ndarray:
    """int64 of ``pd.to_numeric(...).fillna(0).astype(int)``: truncated
    toward zero, so ``"12.7"`` counts 12; an infinite value raises
    ValueError as pandas does."""
    x = to_numbers(values)
    if not np.isfinite(x).all():
        raise ValueError("Cannot convert non-finite values (NA or inf) to integer")
    return x.astype(np.int64)


def read_csv(path: str) -> dict[str, list[str]]:
    """Columns of a CSV file as lists of strings, as
    ``pd.read_csv(path, dtype=str, keep_default_na=False)`` reads it: a
    UTF-8 byte-order mark before the header is dropped, quoted fields may
    hold commas, blank lines are skipped, a short row is padded with
    empty fields and a long one raises ValueError."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [row for row in csv.reader(f) if row]
    if not rows:
        raise ValueError(f"No columns to parse from file {path}")
    header, body = rows[0], rows[1:]
    width = len(header)
    for i, row in enumerate(body):
        if len(row) > width:
            raise ValueError(
                f"Error tokenizing data. Expected {width} fields in line "
                f"{i + 2}, saw {len(row)}")
        if len(row) < width:
            body[i] = row + [""] * (width - len(row))
    return {name: [row[j] for row in body] for j, name in enumerate(header)}


def _where(df: dict, keep: np.ndarray) -> dict:
    return {k: [v for v, m in zip(col, keep) if m] for k, col in df.items()}


def _equal(col: list[str], value: str) -> np.ndarray:
    return np.array([v == value for v in col], bool)


# ---------------------------------------------------------------------------
# Long-format (NOMIS API download) parsers
# ---------------------------------------------------------------------------

def parse_age_structure(path: str) -> dict:
    """-> {code, age 0..100, count} (age_structure.rs:117-124)."""
    df = read_csv(path)
    if "RURAL_URBAN_NAME" in df:
        df = _where(df, _equal(df["RURAL_URBAN_NAME"], "Total"))
    age = np.array([int(v) for v in df["C_AGE"]], np.int64) - 1  # under-1 is C_AGE 1
    if (age > 100).any():
        raise OutOfBoundsError("age bin", 100, int(age.max()))
    return {"code": df["GEOGRAPHY_NAME"], "age": age,
            "count": to_ints(df["OBS_VALUE"])}


def parse_occupation(path: str) -> dict:
    df = read_csv(path)
    if "MEASURES_NAME" in df:
        df = _where(df, _equal(df["MEASURES_NAME"], "Value"))
    df = _where(df, ~_equal(df["CELL_NAME"], OCCUPATION_ALL_CELL))
    unknown = [c for c in df["CELL_NAME"] if c not in OCCUPATION_CELL_NAMES]
    if unknown:
        bad = list(dict.fromkeys(unknown))[:5]
        raise MissingDataError(f"unknown occupation cells: {bad}")
    return {
        "code": df["GEOGRAPHY_NAME"],
        "occupation": np.array(
            [OCCUPATION_CELL_NAMES[c] for c in df["CELL_NAME"]], np.int64),
        "count": to_ints(df["OBS_VALUE"]),
    }


def parse_population(path: str) -> dict:
    df = read_csv(path)
    if "RURAL_URBAN_NAME" in df:
        df = _where(df, _equal(df["RURAL_URBAN_NAME"], "Total"))
    if "MEASURES_NAME" in df:
        df = _where(df, _equal(df["MEASURES_NAME"], "Value"))
    return {"code": df["GEOGRAPHY_NAME"], "cell": df["CELL_NAME"],
            "value": to_numbers(df["OBS_VALUE"])}


def parse_commuting(path: str, bulk: bool = False) -> dict:
    df = read_csv(path)
    if bulk:
        home = df["Area of usual residence"]
        work = df["Area of workplace"]
        count = to_ints(df["count"])
    else:
        home = df["CURRENTLY_RESIDING_IN_CODE"]
        work = df["PLACE_OF_WORK_NAME"]
        count = to_ints(df["OBS_VALUE"])
    keep = count > 0
    return {"home": [h for h, m in zip(home, keep) if m],
            "work": [w for w, m in zip(work, keep) if m],
            "count": count[keep]}


def load_census_data(
    directory: str, *, bulk: bool = False, bulk_commuting: bool | None = None
) -> CensusData:
    """Read the four tables from ``directory`` and build aligned arrays.

    ``bulk=True`` reads the wide whole-England files (lib.rs:235-343 path,
    get_bulk_filename names) instead of the long NOMIS API downloads.
    Raises :class:`MissingDataError` naming the first table whose file is
    not there.
    """
    if bulk_commuting is None:
        bulk_commuting = bulk

    def path(table, use_bulk):
        spec = TABLE_SPECS[table]
        p = os.path.join(
            directory, spec.bulk_filename if use_bulk else spec.filename
        )
        if not os.path.exists(p):
            raise MissingDataError(
                f"census table {table.value} not found: {p} (download it "
                f"with --download, or pass --synthetic N)")
        return p

    if bulk:
        from .bulk import parse_bulk_age, parse_bulk_occupation, parse_bulk_population

        ages = parse_bulk_age(path(CensusTable.AGE_STRUCTURE, True))
        occs = parse_bulk_occupation(path(CensusTable.OCCUPATION_COUNT, True))
        pops = parse_bulk_population(path(CensusTable.POPULATION_DENSITY, True))
    else:
        ages = parse_age_structure(path(CensusTable.AGE_STRUCTURE, False))
        occs = parse_occupation(path(CensusTable.OCCUPATION_COUNT, False))
        pops = parse_population(path(CensusTable.POPULATION_DENSITY, False))
    commute = parse_commuting(
        path(CensusTable.RESIDES_VS_WORKPLACE, bulk_commuting),
        bulk=bulk_commuting,
    )

    codes = sorted(
        set(ages["code"]) | set(occs["code"]) | set(pops["code"])
        | set(commute["home"])
    )
    idx = {c: i for i, c in enumerate(codes)}
    n = len(codes)

    def rows_of(col):
        return np.array([idx[c] for c in col], np.int64)

    age_h = np.zeros((n, 101), np.int32)
    np.add.at(age_h, (rows_of(ages["code"]), ages["age"]), ages["count"])

    occ_c = np.zeros((n, 9), np.int32)
    np.add.at(occ_c, (rows_of(occs["code"]), occs["occupation"]), occs["count"])

    pop_c = np.zeros((n, 6), np.int32)
    area = np.zeros(n, np.float32)
    dens = np.zeros(n, np.float32)
    rows = rows_of(pops["code"])
    cells = np.array(pops["cell"], dtype=object)
    vals = pops["value"]
    for cell_name, col in PERSON_TYPE_CELLS.items():
        m = cells == cell_name
        pop_c[rows[m], col] = vals[m].astype(np.int32)
    m = cells == AREA_CELL
    area[rows[m]] = vals[m]
    m = cells == DENSITY_CELL
    dens[rows[m]] = vals[m]

    return CensusData(
        oa_codes=codes,
        age_histogram=age_h,
        occupation_counts=occ_c,
        population_counts=pop_c,
        area_hectares=area,
        density=dens,
        commute_home=rows_of(commute["home"]).astype(np.int32),
        commute_work_code=np.array(commute["work"], dtype=object),
        commute_count=commute["count"].astype(np.int32),
    )

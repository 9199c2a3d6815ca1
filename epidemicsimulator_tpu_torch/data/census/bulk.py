"""Bulk-table parsers: the wide per-OA CSVs used for the England path.

The reference loads whole-England data from bulk files
(lib.rs:235-343 threaded path, tables/mod.rs:105-117 get_bulk_filename) whose
rows are one-per-OA with one column per census cell.  Two header styles are
supported:

* NOMIS cell codes: ``GeographyCode, KS101EW0001, KS101EW0002, ...``
* descriptive headers: ``"Occupation: 1. managers, ...; measures: Value"``
  (the aliases of the reference's PreProcessingOccupationCountRecordOLD,
  occupation_count.rs:59-90)

The port's copy of ``epidemicsimulator_tpu/data/census/bulk.py``, read with
the ``csv`` module: a column's values convert as pandas converts a column
it read with its default inference (``df[c].astype(int)`` truncates a
column of decimals, and raises ValueError on a missing value or on text
that is no number).  Geography codes stay text.
"""

from __future__ import annotations

import numpy as np

from ...errors import MissingDataError
from .container import NA_STRINGS as _NA, is_number, read_csv
from .tables import AREA_CELL, DENSITY_CELL, PERSON_TYPE_CELLS

# NOMIS cell-code column maps (QS103EW: 0001=All, 0002.. = age 0..100;
# KS608EW: 0001=All, 0002..0010 = occupations 1..9; KS101EW: usual residents
# split then area/density).
_KS608_DESCRIPTIVE = {
    "Occupation: 1. managers, directors and senior officials; measures: Value": 0,
    "Occupation: 2. professional occupations; measures: Value": 1,
    "Occupation: 3. Associate professional and technical occupations; measures: Value": 2,
    "Occupation: 4. administrative and secretarial occupations; measures: Value": 3,
    "Occupation: 5. Skilled trades occupations; measures: Value": 4,
    "Occupation: 6. caring, leisure and other service occupations; measures: Value": 5,
    "Occupation: 7. sales and customer service occupations; measures: Value": 6,
    "Occupation: 8. Process plant and machine operatives; measures: Value": 7,
    "Occupation: 9. Elementary occupations; measures: Value": 8,
}

_KS101_DESCRIPTIVE = {
    "Variable: All usual residents; measures: Value": 0,
    "Variable: Males; measures: Value": 1,
    "Variable: Females; measures: Value": 2,
    "Variable: Lives in a household; measures: Value": 3,
    "Variable: Lives in a communal establishment; measures: Value": 4,
    "Variable: Schoolchild or full-time student aged 4 and over at their non term-time address; measures: Value": 5,
    "Variable: Area (Hectares); measures: Value": "area",
    "Variable: Density (number of persons per hectare); measures: Value": "density",
}

def _column(values: list[str]):
    """A column as pandas infers it: float64 with NaN for missing values
    when every other value is a number, else the strings."""
    if all(v in _NA or is_number(v) for v in values):
        return np.array([np.nan if v in _NA else float(v) for v in values],
                        np.float64)
    return values


def _as_int(values: list[str]) -> np.ndarray:
    """int64 of ``df[c].astype(int)``."""
    col = _column(values)
    if isinstance(col, np.ndarray):
        if not np.isfinite(col).all():
            raise ValueError(
                "Cannot convert non-finite values (NA or inf) to integer")
        return col.astype(np.int64)
    return np.array([int(v) for v in col], np.int64)


def _as_float(values: list[str]) -> np.ndarray:
    """float64 of ``df[c].astype(float)``."""
    col = _column(values)
    if isinstance(col, np.ndarray):
        return col
    return np.array([np.nan if v in _NA else float(v) for v in col], np.float64)


def _geography_column(df: dict) -> str:
    for cand in ("GeographyCode", "geography code", "geography_code", "mnemonic"):
        if cand in df:
            return cand
    raise MissingDataError(
        f"no geography column among {list(df)[:6]}"
    )


def _long(df: dict, geo: str, cols: dict, key: str, convert) -> dict:
    """The wide columns ``cols`` (column -> key value) stacked into one
    long table, column after column, as the JAX package's concat does."""
    codes = df[geo]
    out = {"code": [], key: [], "value": []}
    for c, what in cols.items():
        out["code"] += codes
        out[key] += [what] * len(codes)
        out["value"].append(convert(df[c]))
    out["value"] = (np.concatenate(out["value"]) if out["value"]
                    else np.zeros(0))
    return out


def parse_bulk_age(path: str) -> dict:
    """Wide QS103EW -> long {code, age, count}."""
    df = read_csv(path)
    geo = _geography_column(df)
    cols = {}
    for c in df:
        if c.upper().startswith("QS103EW"):
            code = int(c[-4:])
            if code >= 2:  # 0001 = All categories
                cols[c] = code - 2  # age 0..100
        elif c.startswith("Age: Age "):
            # "Age: Age under 1; measures: Value", "Age: Age 1; ..."
            body = c[len("Age: Age ") :].split(";")[0]
            cols[c] = 0 if body.startswith("under") else int(body)
        elif c == "Age: Age 100 and over; measures: Value":
            cols[c] = 100
    if not cols:
        raise MissingDataError("no QS103 age columns found")
    out = _long(df, geo, cols, "age", _as_int)
    return {"code": out["code"], "age": np.array(out["age"], np.int64),
            "count": out["value"]}


def parse_bulk_occupation(path: str) -> dict:
    df = read_csv(path)
    geo = _geography_column(df)
    cols = {}
    for c in df:
        if c.upper().startswith("KS608EW") or c.upper().startswith("KS608UK"):
            code = int(c[-4:])
            if 2 <= code <= 10:
                cols[c] = code - 2
        elif c in _KS608_DESCRIPTIVE:
            cols[c] = _KS608_DESCRIPTIVE[c]
    if not cols:
        raise MissingDataError("no KS608 occupation columns found")
    out = _long(df, geo, cols, "occupation", _as_int)
    return {"code": out["code"],
            "occupation": np.array(out["occupation"], np.int64),
            "count": out["value"]}


def parse_bulk_population(path: str) -> dict:
    """Wide KS101EW -> long {code, cell, value} with the same cell names
    as the API format."""
    inv_person = {v: k for k, v in PERSON_TYPE_CELLS.items()}
    df = read_csv(path)
    geo = _geography_column(df)
    cols = {}
    for c in df:
        if c.upper().startswith("KS101EW"):
            code = int(c[-4:])
            mapping = {1: 0, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5, 7: "area", 8: "density"}
            if code in mapping:
                cols[c] = mapping[code]
        elif c in _KS101_DESCRIPTIVE:
            cols[c] = _KS101_DESCRIPTIVE[c]
    if not cols:
        raise MissingDataError("no KS101 population columns found")
    cells = {
        c: AREA_CELL if what == "area"
        else DENSITY_CELL if what == "density"
        else inv_person[what]
        for c, what in cols.items()
    }
    out = _long(df, geo, cells, "cell", _as_float)
    return {"code": out["code"], "cell": out["cell"], "value": out["value"]}

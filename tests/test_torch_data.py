"""The port's data layer against the JAX package's, on the CPU: census
tables (API and bulk formats, malformed inputs), teachers, the NOMIS
downloader, coordinates, shapefiles, the OSM PBF parser and polygon
assignment.  Every comparison is bitwise unless it says otherwise."""

import dataclasses
import http.server
import re
import struct
import threading

import numpy as np
import pandas as pd
import pytest

import epidemicsimulator_tpu.data.census.nomis as j_nomis
from epidemicsimulator_tpu import errors as j_errors
from epidemicsimulator_tpu.data.census import bulk as j_bulk
from epidemicsimulator_tpu.data.census import container as j_container
from epidemicsimulator_tpu.data.census import teachers as j_teachers
from epidemicsimulator_tpu.data.census.tables import CensusTable as JTable
from epidemicsimulator_tpu.data.geo import convert as j_convert
from epidemicsimulator_tpu.data.osm import native as j_native
from epidemicsimulator_tpu.data.osm import shapefile as j_shapefile
from pbf_writer import build_pbf

import epidemicsimulator_tpu_torch.data.census.nomis as t_nomis
from epidemicsimulator_tpu_torch import errors as t_errors
from epidemicsimulator_tpu_torch import runtime
from epidemicsimulator_tpu_torch.data.census import bulk as t_bulk
from epidemicsimulator_tpu_torch.data.census import container as t_container
from epidemicsimulator_tpu_torch.data.census import teachers as t_teachers
from epidemicsimulator_tpu_torch.data.census.tables import (
    TABLE_SPECS,
    CensusTable,
)
from epidemicsimulator_tpu_torch.data.geo import convert as t_convert
from epidemicsimulator_tpu_torch.data.osm import native as t_native
from epidemicsimulator_tpu_torch.data.osm import shapefile as t_shapefile

OCC_NAMES = [
    "1. Managers, directors and senior officials",
    "2. Professional occupations",
    "3. Associate professional and technical occupations",
    "4. Administrative and secretarial occupations",
    "5. Skilled trades occupations",
    "6. Caring, leisure and other service occupations",
    "7. Sales and customer service occupations",
    "8. Process plant and machine operatives",
    "9. Elementary occupations",
]
AGE_HEADER = ("GEOGRAPHY_NAME,GEOGRAPHY_TYPE,C_AGE,OBS_VALUE,RURAL_URBAN_NAME,"
              "OBS_STATUS,RECORD_OFFSET,RECORD_COUNT")
OCC_HEADER = ("GEOGRAPHY_NAME,GEOGRAPHY_TYPE,CELL_NAME,MEASURES_NAME,OBS_VALUE,"
              "OBS_STATUS,RECORD_OFFSET,RECORD_COUNT")
POP_HEADER = ("GEOGRAPHY_NAME,GEOGRAPHY_TYPE,RURAL_URBAN_NAME,CELL_NAME,"
              "MEASURES_NAME,OBS_VALUE,OBS_STATUS,RECORD_OFFSET,RECORD_COUNT")
COMMUTE_HEADER = ("CURRENTLY_RESIDING_IN_CODE,PLACE_OF_WORK_TYPE,"
                  "PLACE_OF_WORK_NAME,OBS_VALUE,RECORD_OFFSET,RECORD_COUNT")


def _write(directory, table, rows, bom=False):
    path = directory / TABLE_SPECS[table].filename
    path.write_text(("﻿" if bom else "") + "\n".join(rows), encoding="utf-8")


def _census_dir(d, *, bom=False, odd_cells=False):
    """The tables of tests/test_data_layer.py; with ``bom`` every file
    starts with a UTF-8 byte-order mark; with ``odd_cells`` the values
    are suppressed ("", "x", ".."), decimal or signed, a code holds a
    quoted comma, and rows of other geography or measure are mixed in."""
    codes = ("E00000001", "E00000002")
    rows = [AGE_HEADER]
    for code in codes:
        for c_age in range(1, 102):
            v = 3 if code == "E00000001" else (1 if c_age < 30 else 0)
            if odd_cells and c_age % 17 == 0:
                v = ("x", "..", "", "4.9", " 7", "+2")[c_age // 17 - 1]
            rows.append(f"{code},output area,{c_age},{v},Total,A,0,202")
    if odd_cells:
        rows += ['"E0,comma",output area,5,9,Total,A,0,0',
                 "E00000001,output area,5,50,Urban,A,0,0"]
    _write(d, CensusTable.AGE_STRUCTURE, rows, bom)

    rows = [OCC_HEADER]
    for code in codes:
        rows.append(f"{code},output area,All categories: Occupation,Value,45,A,0,0")
        for i, name in enumerate(OCC_NAMES):
            v = ("..", "x", "3.5")[i % 3] if odd_cells and i < 3 else i + 1
            rows.append(f'{code},output area,"{name}",Value,{v},A,0,0')
    if odd_cells:
        rows.append(f'E00000002,output area,"{OCC_NAMES[0]}",Percent,99,A,0,0')
    _write(d, CensusTable.OCCUPATION_COUNT, rows, bom)

    rows = [POP_HEADER]
    for code, pop in (("E00000001", 303), ("E00000002", 29)):
        rows.append(f"{code},output area,Total,All usual residents,Value,{pop},A,0,0")
        rows.append(f"{code},output area,Total,Males,Value,{pop // 2},A,0,0")
        rows.append(f"{code},output area,Total,Females,Value,{pop - pop // 2},A,0,0")
        rows.append(f"{code},output area,Total,Lives in a household,Value,{pop},A,0,0")
        rows.append(f"{code},output area,Total,Area (Hectares),Value,12.5,A,0,0")
        rows.append(f"{code},output area,Total,Density (number of persons "
                    f"per hectare),Value,{'x' if odd_cells else 4.2},A,0,0")
    if odd_cells:
        rows += ["E00000001,output area,Total,Males,Percent,50.5,A,0,0",
                 "E00000002,output area,Rural,Males,Value,1,A,0,0",
                 "E00000002,output area,Total,Lives in a communal "
                 "establishment,Value,3.9,A,0,0"]
    _write(d, CensusTable.POPULATION_DENSITY, rows, bom)

    rows = [COMMUTE_HEADER,
            "E00000001,OA,E00000001,30,0,0",
            "E00000001,OA,E00000002,12,0,0",
            "E00000002,OA,E00000001,5,0,0",
            "E00000002,OA,E00000009,0,0,0"]
    if odd_cells:
        rows += ["E00000002,OA,E00000001,x,0,0", "E00000002,OA,E00000001,2.5,0,0",
                 '"E0,comma",OA,E00000001,7,0,0', "E00000003,OA,E00000001,-4,0,0"]
    _write(d, CensusTable.RESIDES_VS_WORKPLACE, rows, bom)
    return str(d)


def _assert_census_equal(t, j):
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, list):
            assert b == a, f.name
        else:
            assert b.dtype == a.dtype and b.shape == a.shape, f.name
            assert list(b) == list(a) if a.dtype == object else \
                b.tobytes() == a.tobytes(), f.name


# -- census, API format -------------------------------------------------------
@pytest.mark.parametrize("bom,odd_cells", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_census_api_matches_jax(tmp_path, bom, odd_cells):
    d = _census_dir(tmp_path, bom=bom, odd_cells=odd_cells)
    j, t = j_container.load_census_data(d), t_container.load_census_data(d)
    _assert_census_equal(t, j)
    if odd_cells:
        assert "E0,comma" in t.oa_codes
    _assert_census_equal(t.filter_incomplete_output_areas(),
                         j.filter_incomplete_output_areas())
    for a, b in zip(t.commute_matrix(), j.commute_matrix()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a knocked-out table row, as tests/test_data_layer.py filters it
    t.occupation_counts[1] = 0
    j.occupation_counts[1] = 0
    _assert_census_equal(t.filter_incomplete_output_areas(),
                         j.filter_incomplete_output_areas())


TEXT = ["12", "12.0", "12.7", "", "x", "..", " 5", "5 ", "+3", "-2", "1e3",
        "nan", "inf", "-Infinity", "1_000", "0x10", "NaN", "None", "-12.7",
        "1,000", "1.", ".5", "1e", "e3", "1 2", "\t7\n", "+.5e+2", "00012",
        "1d3", "++1"]


def test_to_numbers_is_pandas_to_numeric():
    want = pd.to_numeric(pd.Series(TEXT, dtype=str), errors="coerce").fillna(0)
    got = t_container.to_numbers(TEXT)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want.to_numpy(np.float64))


# -- census, bulk format --------------------------------------------------------
def _bulk_files(d):
    """The wide files of tests/test_bulk_tables.py, written by pandas."""
    import os

    def put(table, cols):
        path = d / TABLE_SPECS[table].bulk_filename
        os.makedirs(path.parent, exist_ok=True)
        pd.DataFrame(cols).to_csv(path, index=False)

    cols = {"GeographyCode": ["E1", "E2"], "QS103EW0001": [10, 20]}
    for a in range(101):
        cols[f"QS103EW{a + 2:04d}"] = [a % 3, (a + 1) % 3]
    put(CensusTable.AGE_STRUCTURE, cols)
    cols = {"GeographyCode": ["E1", "E2"],
            "KS608EW0001": [45, 50], "KS608EW0011": [1, 1]}
    for i in range(9):
        cols[f"KS608EW{i + 2:04d}"] = [i + 1, 2.5 * i]
    put(CensusTable.OCCUPATION_COUNT, cols)
    put(CensusTable.POPULATION_DENSITY, {
        "GeographyCode": ["E1", "E2"], "KS101EW0001": [202, 55],
        "KS101EW0002": [100, 27], "KS101EW0007": [10.0, 3.25],
        "KS101EW0008": [20.2, None]})
    pd.DataFrame({"Area of usual residence": ["E1", "E2", "E2"],
                  "Area of workplace": ["E1", "E1", "E2"],
                  "count": [50, 0, 7]}).to_csv(
        d / TABLE_SPECS[CensusTable.RESIDES_VS_WORKPLACE].bulk_filename,
        index=False)


def test_census_bulk_matches_jax(tmp_path):
    _bulk_files(tmp_path)
    j = j_container.load_census_data(str(tmp_path), bulk=True)
    t = t_container.load_census_data(str(tmp_path), bulk=True)
    _assert_census_equal(t, j)
    assert t.oa_codes == ["E1", "E2"] and t.age_histogram.sum() > 0
    _assert_census_equal(t.filter_incomplete_output_areas(),
                         j.filter_incomplete_output_areas())


def _descriptive_occupation(p):
    cols = {"date": [2011], "geography": ["x"], "geography code": ["E9"],
            "Occupation: all categories: Occupation; measures: Value": [45]}
    for name, occ in j_bulk._KS608_DESCRIPTIVE.items():
        cols[name] = [occ + 1]
    pd.DataFrame(cols).to_csv(p, index=False)


def _descriptive_population(p):
    cols = {"mnemonic": ["E3", "E4"]}
    for k, (name, _) in enumerate(j_bulk._KS101_DESCRIPTIVE.items()):
        cols[name] = [k * 10 + 0.5, k]
    pd.DataFrame(cols).to_csv(p, index=False)


def _descriptive_age(p):
    cols = {"geography_code": ["E5"], "Age: Age under 1; measures: Value": [4]}
    for a in range(1, 100):
        cols[f"Age: Age {a}; measures: Value"] = [a % 5]
    pd.DataFrame(cols).to_csv(p, index=False)


@pytest.mark.parametrize("writer,parser,key", [
    (_descriptive_occupation, "parse_bulk_occupation", "occupation"),
    (_descriptive_population, "parse_bulk_population", "cell"),
    (_descriptive_age, "parse_bulk_age", "age"),
])
def test_bulk_descriptive_headers_match_jax(tmp_path, writer, parser, key):
    p = tmp_path / "wide.csv"
    writer(p)
    j = getattr(j_bulk, parser)(str(p))
    t = getattr(t_bulk, parser)(str(p))
    value = "value" if key == "cell" else "count"
    assert t["code"] == list(j["code"])
    assert list(t[key]) == list(j[key])
    want = j[value].to_numpy()
    assert t[value].dtype == want.dtype
    np.testing.assert_array_equal(t[value], want)


# -- malformed inputs raise the same class --------------------------------------
def _frame_csv(cols):
    def write(p):
        pd.DataFrame(cols).to_csv(p, index=False)
    return write


def _bytes(data):
    def write(p):
        p.write_bytes(data)
    return write


MALFORMED = {
    "bulk, no geography column": (
        "bulk.parse_bulk_age", _frame_csv({"foo": [1], "bar": [2]})),
    "bulk, no age columns": (
        "bulk.parse_bulk_age",
        _frame_csv({"GeographyCode": ["E00000001"], "junk": [3]})),
    "bulk, no occupation columns": (
        "bulk.parse_bulk_occupation", _frame_csv({"GeographyCode": ["E1"]})),
    "bulk, no population columns": (
        "bulk.parse_bulk_population", _frame_csv({"mnemonic": ["E1"]})),
    # the "100 and over" column reads as "Age: Age <n>" first, in both
    "bulk, age 100 and over": (
        "bulk.parse_bulk_age",
        _frame_csv({"GeographyCode": ["E1"],
                    "Age: Age 100 and over; measures: Value": [1]})),
    "bulk, missing count": (
        "bulk.parse_bulk_age",
        _frame_csv({"GeographyCode": ["E1", "E2"], "QS103EW0002": [1, None]})),
    "bulk, text count": (
        "bulk.parse_bulk_occupation",
        _frame_csv({"GeographyCode": ["E1", "E2"], "KS608EW0002": ["1.5", "x"]})),
    "age bin out of bounds": (
        "container.parse_age_structure",
        _frame_csv({"GEOGRAPHY_NAME": ["E00000001"], "C_AGE": [150],
                    "OBS_VALUE": [5]})),
    "age not an integer": (
        "container.parse_age_structure",
        _frame_csv({"GEOGRAPHY_NAME": ["E1"], "C_AGE": ["3.0"], "OBS_VALUE": [5]})),
    "unknown occupation cell": (
        "container.parse_occupation",
        _frame_csv({"GEOGRAPHY_NAME": ["E00000001"],
                    "CELL_NAME": ["Not a real occupation"], "OBS_VALUE": ["4"]})),
    "infinite count": (
        "container.parse_commuting",
        _frame_csv({"CURRENTLY_RESIDING_IN_CODE": ["E1"],
                    "PLACE_OF_WORK_NAME": ["E1"], "OBS_VALUE": ["inf"]})),
    "missing column": (
        "container.parse_population", _frame_csv({"GEOGRAPHY_NAME": ["E1"]})),
    "row too long": (
        "container.parse_occupation", _bytes(b"A,B\n1,2\n3,4,5\n")),
    "truncated shapefile header": (
        "shapefile.read_polygons", _bytes(b"\x00" * 10)),
    "wrong shapefile magic": (
        "shapefile.read_polygons", _bytes(struct.pack(">i", 1234) + b"\x00" * 96)),
    "malformed pbf": (
        "native.parse_pbf", _bytes(b"\x00\x00\x00\x10" + b"garbage!" * 4)),
}
J_MODULES = {"bulk": j_bulk, "container": j_container,
             "shapefile": j_shapefile, "native": j_native}
T_MODULES = {"bulk": t_bulk, "container": t_container,
             "shapefile": t_shapefile, "native": t_native}


def _raised(fn, path):
    with pytest.raises(Exception) as info:
        fn(str(path))
    return info.value


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_input_raises_the_same_class(tmp_path, case):
    target, write = MALFORMED[case]
    module, name = target.split(".")
    path = tmp_path / "input.csv"
    write(path)
    j = _raised(getattr(J_MODULES[module], name), path)
    t = _raised(getattr(T_MODULES[module], name), path)
    if type(j).__module__ == j_errors.__name__:
        assert type(t).__module__ == t_errors.__name__
        assert type(t).__name__ == type(j).__name__, (t, j)
        assert [c.__name__ for c in type(t).__mro__] == \
            [c.__name__ for c in type(j).__mro__]
    else:
        # pandas' own errors are ValueErrors (ParserError, IntCastingNaNError)
        assert isinstance(j, (ValueError, KeyError)), j
        assert type(t) is (KeyError if isinstance(j, KeyError) else ValueError), t
    if isinstance(j, j_errors.OutOfBoundsError):
        assert (t.max_size, t.actual_size) == (j.max_size, j.actual_size)


def test_error_taxonomy_matches_jax():
    """Every class of the JAX package's errors.py, with the same bases,
    so that a caller catches at the same granularity."""
    def classes(mod):
        return {name: [b.__name__ for b in cls.__mro__]
                for name, cls in vars(mod).items()
                if isinstance(cls, type) and issubclass(cls, Exception)
                and cls.__module__ == mod.__name__}
    assert classes(t_errors) == classes(j_errors)
    for cls in (t_errors.MissingDataError, t_errors.OutOfBoundsError,
                t_errors.MismatchedDataError, t_errors.ShapeFileError,
                t_errors.ValueParsingError, t_errors.NetworkError):
        assert issubclass(cls, t_errors.DataLoadingError)
    e = t_errors.MismatchedDataError("m", 1, 2)
    assert str(e) == str(j_errors.MismatchedDataError("m", 1, 2))


def test_missing_table_names_it(tmp_path):
    d = _census_dir(tmp_path)
    (tmp_path / TABLE_SPECS[CensusTable.OCCUPATION_COUNT].filename).unlink()
    with pytest.raises(t_errors.MissingDataError, match="OccupationCount"):
        t_container.load_census_data(d)


# -- teachers -----------------------------------------------------------------
TEACHER_COLS = ["new_la_code", "la_name", "region_name", "school_type",
                "number_schools", "fte_all_teachers", "fte_classroom_teachers",
                "fte_teaching_assistants", "hc_all_teachers"]
BRADFORD = [
    ["E08000032", "Bradford", "North", "Primary", "100", "900.5", "800.0", "400.0", "950"],
    ["E08000032", "Bradford", "North", "Secondary", "40", "700.0", "600.0", "200.0", "720"],
    ["E08000032", "Bradford", "North", "Total", "140", "1600.5", "1400.0", "600.0", "1670"],
]
TEACHER_CASES = {
    "total row wins": BRADFORD,
    "sum and suppressed cells": [
        ["E06000014", "York", "North", "Primary", "50", "400.0", "350.0", "150.0", "420"],
        ["E06000014", "York", "North", "Secondary", "20", "x", "..", "z", "310"],
    ],
    "several LAs": [
        ["E08000032", "Bradford", "North", "Total", "140", "1600.5", "1400.0", "600.0", "1670"],
        ["E06000014", "York", "North", "Total", "70", "710.0", "620.0", "250.0", "730"],
    ] + BRADFORD[:2],
    "empty": [],
    "unsupported region": [
        ["E08000032", "Bradford", "Yorkshire and The Humber", "Total",
         "140", "1600.5", "1400.0", "600.0", "1670"]],
    "mismatched LA name": [
        ["E06000014", "York", "North", "Primary", "50", "400.0", "350.0", "150.0", "420"],
        ["E06000014", "NotYork", "North", "Secondary", "20", "300.0", "260.0", "100.0", "310"],
    ],
}


def _teachers_or_error(fn, arg):
    try:
        return {k: dataclasses.asdict(v) for k, v in fn(arg).items()}
    except (j_errors.DataLoadingError, t_errors.DataLoadingError) as e:
        return type(e).__name__


@pytest.mark.parametrize("case", list(TEACHER_CASES))
def test_teachers_match_jax(tmp_path, case):
    rows = TEACHER_CASES[case]
    frame = pd.DataFrame(rows, columns=TEACHER_COLS)
    want = _teachers_or_error(j_teachers.parse_teachers, frame)
    got = _teachers_or_error(t_teachers.parse_teachers,
                             [dict(zip(TEACHER_COLS, r)) for r in rows])
    assert got == want
    if rows:
        path = tmp_path / "workforce.csv"
        frame.to_csv(path, index=False)
        assert _teachers_or_error(t_teachers.load_teachers, str(path)) == \
            _teachers_or_error(j_teachers.load_teachers, str(path))


def test_teachers_from_disk_with_missing_cells(tmp_path):
    path = tmp_path / "workforce.csv"
    path.write_text(
        "﻿" + ",".join(TEACHER_COLS[:2] + TEACHER_COLS[3:]) + "\n"
        "E1,York,Primary,5,1.5,NA,,n/a\n,NoCode,Primary,1,1,1,1,1\n"
        "E1,York,,3,2,2,2,2\n\nE0,Leeds,Total,7,3.5,3,1,9\n")
    assert _teachers_or_error(t_teachers.load_teachers, str(path)) == \
        _teachers_or_error(j_teachers.load_teachers, str(path))
    assert _teachers_or_error(t_teachers.parse_teachers,
                              [{"new_la_code": "E1"}]) == "MissingDataError"


# -- NOMIS --------------------------------------------------------------------
HEADER = "GEOGRAPHY_NAME,C_AGE,OBS_VALUE"


def _row(i):
    return f"E{i:08d},1,5"


def _page(url, n_rows):
    """The fake NOMIS server of tests/test_nomis_download.py: exact
    RecordOffset/recordlimit paging, the header unless
    ExcludeColumnHeadings, an empty body past the end."""
    offset = int(re.search(r"RecordOffset=(\d+)", url).group(1))
    limit = int(re.search(r"recordlimit=(\d+)", url).group(1))
    rows = [_row(i) for i in range(offset, min(offset + limit, n_rows))]
    if not rows:
        return b""
    head = [] if "ExcludeColumnHeadings=true" in url else [HEADER]
    return ("\n".join(head + rows) + "\n").encode()


class FakeNomisServer:
    def __init__(self, n_rows, failures=0):
        self.n_rows, self.failures, self.calls = n_rows, failures, []

    def get(self, url, timeout=None):
        self.calls.append(url)
        if self.failures > 0:
            self.failures -= 1
            return FakeResponse(500)
        return FakeResponse(200, _page(url, self.n_rows))


class FakeResponse:
    def __init__(self, status, content=b""):
        self.status_code = status
        self.content = content


@pytest.mark.parametrize("table", list(CensusTable))
@pytest.mark.parametrize("index", [0, 3])
@pytest.mark.parametrize("key", [None, "abc123"])
def test_table_url_matches_jax(monkeypatch, table, index, key):
    if key:
        monkeypatch.setenv("NOMIS_API_KEY", key)
    else:
        monkeypatch.delenv("NOMIS_API_KEY", raising=False)
    for geography in list(t_nomis.GEOGRAPHY_CODES.values()) + ["TYPE299"]:
        assert t_nomis.table_url(table, geography, index) == \
            j_nomis.table_url(JTable[table.name], geography, index)
    assert t_nomis.GEOGRAPHY_CODES == j_nomis.GEOGRAPHY_CODES


# (page size, rows, transient failures, resume row, existing rows)
DOWNLOADS = {
    "single page": (100, 10, 0, None, 0),
    "three pages": (10, 25, 0, None, 0),
    "exact multiple of a page": (10, 20, 0, None, 0),
    "retry then success": (100, 3, 2, None, 0),
    "retries exhausted": (100, 3, 5, None, 0),
    "resume at a page boundary": (10, 25, 0, 10, 10),
    "resume mid-page": (10, 25, 0, 15, 10),
    "resume at row 0 starts afresh": (10, 12, 0, 0, 10),
}


def _download(module, table, tmp_path, monkeypatch, case):
    page, n_rows, failures, resume, existing = DOWNLOADS[case]
    monkeypatch.setattr(module, "PAGE_SIZE", page)
    sleeps = []
    monkeypatch.setattr(module.time, "sleep", sleeps.append)
    dest = tmp_path / f"{module.__name__}.csv"
    if existing:
        dest.write_text("\n".join([HEADER] + [_row(i) for i in range(existing)]) + "\n")
    server = FakeNomisServer(n_rows, failures)
    try:
        module.download_table(table, "TYPE299", str(dest),
                              resume_from_row=resume, session=server)
        error = None
    except Exception as e:  # noqa: BLE001 - compared across the packages
        error = (type(e).__name__, str(e))
    return dest.read_bytes() if dest.exists() else None, server.calls, sleeps, error


@pytest.mark.parametrize("case", list(DOWNLOADS))
def test_downloader_matches_jax(tmp_path, monkeypatch, case):
    """Same bytes on disk, same requests, same back-off and the same
    error against the fake server."""
    j = _download(j_nomis, JTable.AGE_STRUCTURE, tmp_path, monkeypatch, case)
    t = _download(t_nomis, CensusTable.AGE_STRUCTURE, tmp_path, monkeypatch, case)
    assert t == j
    if case == "retries exhausted":
        assert t[3][0] == "NetworkError" and t[2] == [1, 2, 4]
    else:
        assert t[3] is None


def test_default_session_downloads_over_http(tmp_path, monkeypatch):
    """The port's default session (urllib) against the fake server over
    HTTP on localhost, with one transient 500."""
    state = {"failures": 1, "calls": []}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            state["calls"].append(self.path)
            if state["failures"]:
                state["failures"] -= 1
                self.send_response(500)
                self.end_headers()
                return
            body = _page(self.path, 25)
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        monkeypatch.setattr(t_nomis, "NOMIS_API",
                            f"http://127.0.0.1:{server.server_address[1]}/dataset")
        monkeypatch.setattr(t_nomis, "PAGE_SIZE", 10)
        monkeypatch.setattr(t_nomis.time, "sleep", lambda s: None)
        dest = tmp_path / "t.csv"
        t_nomis.download_table(CensusTable.AGE_STRUCTURE, "TYPE299", str(dest))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert dest.read_text() == "\n".join([HEADER] + [_row(i) for i in range(25)]) + "\n"
    assert len(state["calls"]) == 5  # a 500, three pages, the empty page


# -- coordinates --------------------------------------------------------------
def test_national_grid_matches_jax_bitwise():
    rng = np.random.default_rng(11)
    grid_lat, grid_lon = np.meshgrid(np.linspace(49.8, 60.9, 40),
                                     np.linspace(-8.2, 1.8, 40))
    lat = np.concatenate([grid_lat.ravel(), rng.uniform(49.8, 60.9, 4000)])
    lon = np.concatenate([grid_lon.ravel(), rng.uniform(-8.2, 1.8, 4000)])
    for fn in ("wgs84_to_national_grid", "wgs84_to_osgb36_latlon",
               "osgb36_to_grid"):
        for a, b in zip(getattr(t_convert, fn)(lat, lon),
                        getattr(j_convert, fn)(lat, lon)):
            assert a.dtype == np.float64 and a.tobytes() == b.tobytes(), fn
    # the OS worked example (Caister water tower), OSGB36 -> grid
    lat0 = 52 + 39 / 60 + 27.2531 / 3600
    lon0 = 1 + 43 / 60 + 4.5177 / 3600
    e, n = t_convert.osgb36_to_grid(lat0, lon0)
    assert (float(e), float(n)) == tuple(map(float, j_convert.osgb36_to_grid(lat0, lon0)))
    assert abs(float(e) - 651409.903) < 0.005 and abs(float(n) - 313177.270) < 0.005
    x, y, z = t_convert.latlon_to_cartesian(lat, lon, t_convert.AIRY_A, t_convert.AIRY_B)
    back = t_convert.cartesian_to_latlon(x, y, z, t_convert.AIRY_A, t_convert.AIRY_B)
    want = j_convert.cartesian_to_latlon(x, y, z, j_convert.AIRY_A, j_convert.AIRY_B)
    for a, b in zip(back, want):
        assert a.tobytes() == b.tobytes()


# -- shapefiles ---------------------------------------------------------------
def _polygons(rng, n):
    polys = []
    for k in range(n):
        m = 3 + k % 5
        ang = np.sort(rng.uniform(0, 2 * np.pi, m))
        r = rng.uniform(50, 400, m)
        polys.append(np.c_[450_000 + 1000 * k + r * np.cos(ang),
                           450_000 + r * np.sin(ang)])
    return polys


def test_shapefile_round_trips_across_packages(tmp_path):
    rng = np.random.default_rng(3)
    polys = _polygons(rng, 12)
    codes = [f"E00{k:06d}" for k in range(12)]
    t_path, j_path = str(tmp_path / "t.shp"), str(tmp_path / "j.shp")
    t_shapefile.write_polygons(t_path, codes, polys)
    j_shapefile.write_polygons(j_path, codes, polys)
    for ext in (".shp", ".dbf"):
        assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    for reader, path in ((t_shapefile.read_polygons, j_path),
                         (j_shapefile.read_polygons, t_path)):
        got_codes, rings, starts = reader(path)
        assert got_codes == codes
        assert starts.dtype == np.int64 and rings.dtype == np.float64
        np.testing.assert_array_equal(rings, np.concatenate(polys))
        np.testing.assert_array_equal(starts, np.cumsum([0] + [len(p) for p in polys]))
    # the dbf's code field found by its fall-back names
    t_shapefile.write_polygons(t_path, codes, polys, code_field="OA11CD")
    assert t_shapefile.read_polygons(t_path)[0] == j_shapefile.read_polygons(t_path)[0]


# -- OSM ----------------------------------------------------------------------
def _tiny(compress=True):
    nodes = [
        (1, 53.00010, -1.00010, {}), (2, 53.00010, -1.00000, {}),
        (3, 53.00000, -1.00000, {}), (4, 53.00000, -1.00010, {}),
        (10, 53.1, -1.1, {"amenity": "school"}),
        (11, 53.2, -1.2, {"shop": "bakery"}),
        (12, 53.3, -1.3, {"amenity": "hospital"}),
        (13, 53.4, -1.4, {"building": "house"}),
        (14, 60.0, 10.0, {"shop": "excluded_by_bounds"}),
    ]
    ways = [
        (100, [1, 2, 3, 4, 1], {"building": "office"}),
        (101, [1, 2, 3, 4, 1], {"building": "residential"}),
        (102, [1, 2, 3, 4, 1], {"building": "weird_type"}),
    ]
    return build_pbf(nodes, ways, compress=compress)


def _multi_blob():
    rng = np.random.default_rng(7)
    nodes = [(i + 1, 53.0 + rng.uniform(0, 0.05), -1.0 - rng.uniform(0, 0.05),
              {"building": "house"} if i % 7 == 0 else {}) for i in range(500)]
    ways = []
    for w in range(40):
        refs = [1 + (w * 97 + k * 13) % 500 for k in range(4)]
        ways.append((10_000 + w, refs + [refs[0]], {"building": "office"}))
    return build_pbf(nodes, ways, max_entities=64, with_header=True)


PBFS = {
    "tiny, compressed": (_tiny, (50.0, 56.0, -6.0, 2.0)),
    "tiny, uncompressed": (lambda: _tiny(compress=False), (50.0, 56.0, -6.0, 2.0)),
    "tiny, no bounds": (_tiny, None),
    "one raw node": (lambda: build_pbf([(1, 51.0, 0.5, {"building": "office"})],
                                       [], compress=False), None),
    "header and 64-entity blobs": (_multi_blob, (50.0, 56.0, -6.0, 2.0)),
}


@pytest.mark.parametrize("case", list(PBFS))
def test_parse_pbf_matches_jax(tmp_path, case):
    make, bounds = PBFS[case]
    path = tmp_path / "x.osm.pbf"
    path.write_bytes(make())
    kw = {} if bounds is None else {"bounds": bounds}
    got, want = t_native.parse_pbf(str(path), **kw), j_native.parse_pbf(str(path), **kw)
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert t_native.BUILDING_CLASSES == j_native.BUILDING_CLASSES


def test_assign_points_matches_jax():
    rng = np.random.default_rng(0)
    rings, starts = [], [0]
    for gy in range(10):
        for gx in range(10):
            rings.extend([(gx, gy), (gx + 1, gy), (gx + 1, gy + 1), (gx, gy + 1)])
            starts.append(len(rings))
    rings = np.array(rings, np.float64)
    starts = np.array(starts, np.int64)
    pts = np.concatenate([rng.uniform(-0.5, 10.5, (5000, 2)),
                          rng.integers(0, 11, (200, 2)).astype(np.float64)])
    got = t_native.assign_points_to_polygons(pts[:, 0], pts[:, 1], rings, starts)
    want = j_native.assign_points_to_polygons(pts[:, 0], pts[:, 1], rings, starts)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and (got >= 0).any()
    polys = _polygons(rng, 30)
    rings = np.concatenate(polys)
    starts = np.cumsum([0] + [len(p) for p in polys]).astype(np.int64)
    px = rng.uniform(449_000, 480_000, 3000)
    py = rng.uniform(449_500, 450_500, 3000)
    np.testing.assert_array_equal(
        t_native.assign_points_to_polygons(px, py, rings, starts),
        j_native.assign_points_to_polygons(px, py, rings, starts))


def test_parser_builds_into_the_host_library():
    """The port's parser comes from its own copy of the source, built
    into the port's host library, never from native/."""
    lib = runtime.host_library()
    path = runtime.host_library_path()
    assert path.exists() and path.parent == runtime.BUILD_DIR
    assert (runtime.CSRC / "osm_native.cpp") in sorted(runtime.CSRC.glob("*.cpp"))
    assert hasattr(lib, "esucd_parse_pbf") and hasattr(lib, "es_benes_route")

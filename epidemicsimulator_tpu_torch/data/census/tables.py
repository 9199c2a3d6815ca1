"""Census table registry: filenames, NOMIS API codes and column selections.

Mirrors `load_census_data/src/tables/mod.rs:79-140` (CensusTableNames) so a
data directory prepared for the reference works unchanged.

The port's copy of ``epidemicsimulator_tpu/data/census/tables.py``.
"""

from __future__ import annotations

import dataclasses
from enum import Enum


class CensusTable(Enum):
    OCCUPATION_COUNT = "OccupationCount"
    POPULATION_DENSITY = "PopulationDensity"
    OUTPUT_AREA_MAP = "OutputAreaMap"
    RESIDES_VS_WORKPLACE = "ResidentialAreaVsWorkplaceArea"
    AGE_STRUCTURE = "AgeStructure"


@dataclasses.dataclass(frozen=True)
class TableSpec:
    filename: str
    bulk_filename: str
    api_code: str
    api_columns: str | None


TABLE_SPECS = {
    CensusTable.POPULATION_DENSITY: TableSpec(
        filename="ks101ew_population_144.csv",
        bulk_filename="ks101ew_2011oa/KS101EWDATA.CSV",
        api_code="NM_144_1",
        api_columns=(
            "GEOGRAPHY_NAME,GEOGRAPHY_TYPE,RURAL_URBAN_NAME,CELL_NAME,"
            "MEASURES_NAME,OBS_VALUE,OBS_STATUS,RECORD_OFFSET,RECORD_COUNT"
        ),
    ),
    CensusTable.OCCUPATION_COUNT: TableSpec(
        filename="ks608uk_occupation_count_NM_1518_1.csv",
        bulk_filename="KS608ew_2011_oa/KS608EWDATA.CSV",
        api_code="NM_1518_1",
        api_columns=None,
    ),
    CensusTable.OUTPUT_AREA_MAP: TableSpec(
        filename="data/census_map_areas_converted/TestOutputAreas.shp",
        bulk_filename="data/census_map_areas_converted/TestOutputAreas.shp",
        api_code="data/census_map_areas/England_oa_2011/england_oa_2011.shp",
        api_columns=(
            "GEOGRAPHY_NAME,GEOGRAPHY_TYPE,CELL_NAME,MEASURES_NAME,"
            "OBS_VALUE,OBS_STATUS,RECORD_OFFSET,RECORD_COUNT"
        ),
    ),
    CensusTable.RESIDES_VS_WORKPLACE: TableSpec(
        filename="wf01bew_residential_vs_workplace_NM_1228_1.csv",
        bulk_filename="wf01bew_oa.csv",
        api_code="NM_1228_1",
        api_columns=(
            "CURRENTLY_RESIDING_IN_CODE,PLACE_OF_WORK_TYPE,PLACE_OF_WORK_NAME,"
            "OBS_VALUE,RECORD_OFFSET,RECORD_COUNT"
        ),
    ),
    CensusTable.AGE_STRUCTURE: TableSpec(
        filename="qs103ew_age_structure_NUM_503_1.csv",
        bulk_filename="qs103ew_2011_oa/QS103EWDATA.CSV",
        api_code="NM_503_1",
        api_columns=(
            "GEOGRAPHY_NAME,GEOGRAPHY_TYPE,C_AGE,OBS_VALUE,RURAL_URBAN_NAME,"
            "OBS_STATUS,RECORD_OFFSET,RECORD_COUNT"
        ),
    ),
}

# KS608 occupation CELL_NAME -> occupation index 0..8.  The reference maps
# "9. Elementary occupations" to its Teaching variant
# (occupation_count.rs:54-55) — a mislabel kept for fidelity; index 8 is the
# Teaching slot.
OCCUPATION_CELL_NAMES = {
    "1. Managers, directors and senior officials": 0,
    "2. Professional occupations": 1,
    "3. Associate professional and technical occupations": 2,
    "4. Administrative and secretarial occupations": 3,
    "5. Skilled trades occupations": 4,
    "6. Caring, leisure and other service occupations": 5,
    "7. Sales and customer service occupations": 6,
    "8. Process plant and machine operatives": 7,
    "9. Elementary occupations": 8,
}
OCCUPATION_ALL_CELL = "All categories: Occupation"

# KS101 person-type CELL_NAME -> column (population_and_density rs:33-47)
PERSON_TYPE_CELLS = {
    "All usual residents": 0,
    "Males": 1,
    "Females": 2,
    "Lives in a household": 3,
    "Lives in a communal establishment": 4,
    "Schoolchild or full-time student aged 4 and over at their non term-time address": 5,
}
AREA_CELL = "Area (Hectares)"
DENSITY_CELL = "Density (number of persons per hectare)"

"""NOMIS census-table downloader: paged CSV fetch with retry and resume.

Equivalent of `load_census_data/src/nomis_download.rs`: 1,000,000-row pages
(nomis_download.rs:43 PAGE_SIZE), up to 3 retries per page (:46), resumable
from a row offset (:119-180), API key from the NOMIS_API_KEY env var (dotenv
supported by simply exporting it).  Geography codes for the areas the
reference ships (:274-314).

The port's copy of ``epidemicsimulator_tpu/data/census/nomis.py``.  Its
default session is :class:`UrllibSession`, so it needs no ``requests``;
any object with ``.get(url, timeout)`` returning ``.status_code`` and
``.content`` serves as well.
"""

from __future__ import annotations

import logging
import os
import time
import urllib.error
import urllib.request

from .tables import CensusTable, TABLE_SPECS
from ...errors import NetworkError

log = logging.getLogger(__name__)

NOMIS_API = "https://www.nomisweb.co.uk/api/v01/dataset"
PAGE_SIZE = 1_000_000
MAX_RETRIES = 3

# Geography code ranges per area (nomis_download.rs:274-314).
GEOGRAPHY_CODES = {
    "1946157112": "1254162148...1254162748,1254262205...1254262240",  # York
    "2013265923": "1254132824...1254159668,1254258198...1254261743",  # Yorkshire & Humber
    "2092957699": "TYPE299",  # England (all OAs)
}


def table_url(table: CensusTable, geography: str, index: int = 0) -> str:
    """URL for page ``index`` — exact ``index * PAGE_SIZE`` offsets and
    server-side header exclusion on continuation pages, matching
    nomis_download.rs:229-234 (`RecordOffset=index*PAGE_SIZE` +
    `ExcludeColumnHeadings=true` for index != 0)."""
    spec = TABLE_SPECS[table]
    params = [
        f"geography={geography}",
        f"recordlimit={PAGE_SIZE}",
        f"RecordOffset={index * PAGE_SIZE}",
    ]
    if index != 0:
        params.append("ExcludeColumnHeadings=true")
    if spec.api_columns:
        params.append(f"select={spec.api_columns}")
    key = os.environ.get("NOMIS_API_KEY")
    if key:
        params.append(f"uid={key}")
    return f"{NOMIS_API}/{spec.api_code}.data.csv?" + "&".join(params)


class _Response:
    def __init__(self, status_code: int, content: bytes):
        self.status_code = status_code
        self.content = content


class UrllibSession:
    """The part of a ``requests.Session`` the downloader uses, over
    ``urllib``: an HTTP error status is a response, not an exception."""

    def get(self, url: str, timeout: float | None = None) -> _Response:
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return _Response(r.status, r.read())
        except urllib.error.HTTPError as e:
            return _Response(e.code, b"")


def download_table(
    table: CensusTable,
    geography: str,
    dest_path: str,
    *,
    resume_from_row: int | None = None,
    session=None,
) -> str:
    """Download all pages of ``table`` into ``dest_path``.

    Page-index driven like download_and_save_table
    (nomis_download.rs:171-259): page ``index`` requests exact offset
    ``index * PAGE_SIZE``; resume starts at page
    ``resume_from_row // PAGE_SIZE`` and appends to the existing file
    (run/src/main.rs:200-211 --resume semantics — page-granular, like the
    reference); the loop ends on the first empty response body
    (execute_request's ``data.is_empty()`` exit).  Raises
    :class:`~epidemicsimulator_tpu_torch.errors.NetworkError` after
    MAX_RETRIES failures on a page.
    """
    sess = session or UrllibSession()
    # resume_from_row in (None, 0) means a fresh download: appending from
    # page 0 would duplicate the whole table (including the page-0 CSV
    # header mid-file, since ExcludeColumnHeadings is only sent past page 0).
    index = (resume_from_row or 0) // PAGE_SIZE
    mode = "ab" if resume_from_row else "wb"
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)

    with open(dest_path, mode) as f:
        while True:
            url = table_url(table, geography, index)
            body = _fetch_with_retry(sess, url)
            if not body:
                break
            f.write(body)
            log.info(
                "fetched %d rows on page %d for %s",
                body.count(b"\n"), index, table,
            )
            index += 1
    return dest_path


def _fetch_with_retry(sess, url: str) -> bytes:
    last = None
    for attempt in range(MAX_RETRIES):
        try:
            r = sess.get(url, timeout=300)
            if r.status_code == 200:
                return r.content
            last = RuntimeError(f"HTTP {r.status_code}")
        except Exception as e:  # noqa: BLE001
            last = e
        time.sleep(2**attempt)
    raise NetworkError(
        f"download failed after {MAX_RETRIES} retries: {last}"
    )


def download_all_tables(directory: str, area: str) -> None:
    geography = GEOGRAPHY_CODES.get(area, area)
    for table in (
        CensusTable.AGE_STRUCTURE,
        CensusTable.OCCUPATION_COUNT,
        CensusTable.POPULATION_DENSITY,
        CensusTable.RESIDES_VS_WORKPLACE,
    ):
        dest = os.path.join(directory, TABLE_SPECS[table].filename)
        if os.path.exists(dest):
            log.info("%s already present, skipping", dest)
            continue
        download_table(table, geography, dest)

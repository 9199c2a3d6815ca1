"""Minimal ESRI shapefile reader: polygons + one character attribute.

Replaces the reference's `shapefile` crate usage (polygon_lookup.rs:253-362):
reads the output-area boundary polygons (national-grid coordinates) and their
``code`` attribute.  No geopandas/pyshp is needed — the format is simple
enough to parse directly.  The port's copy of
``epidemicsimulator_tpu/data/osm/shapefile.py``.
"""

from __future__ import annotations

import os
import struct

import numpy as np
from ...errors import MismatchedDataError, MissingDataError, ShapeFileError

SHAPE_POLYGON = 5


def read_polygons(shp_path: str, code_field: str = "code"):
    """-> (codes: list[str], rings: (M,2) float64, ring_starts: (P+1,) int64)

    Only each polygon's outer ring (first part) is kept — matching how the
    reference uses OA boundaries for containment (holes in OA polygons are
    other OAs, resolved by first-match containment order as in the quadtree
    variant).
    """
    rings = []
    starts = [0]
    with open(shp_path, "rb") as f:
        header = f.read(100)
        if len(header) < 100:
            raise ShapeFileError("truncated shapefile header")
        (magic,) = struct.unpack(">i", header[:4])
        if magic != 9994:
            raise ShapeFileError("not a shapefile")
        while True:
            rec = f.read(8)
            if len(rec) < 8:
                break
            _, content_len = struct.unpack(">ii", rec)
            content = f.read(content_len * 2)
            (shape_type,) = struct.unpack("<i", content[:4])
            if shape_type == 0:  # null shape
                rings.append(np.zeros((0, 2)))
                starts.append(starts[-1])
                continue
            if shape_type != SHAPE_POLYGON:
                raise ShapeFileError(f"unsupported shape type {shape_type}")
            num_parts, num_points = struct.unpack("<ii", content[36:44])
            parts = np.frombuffer(content, "<i4", num_parts, offset=44)
            pts = np.frombuffer(
                content, "<f8", num_points * 2, offset=44 + 4 * num_parts
            ).reshape(num_points, 2)
            end_first = parts[1] if num_parts > 1 else num_points
            outer = pts[: int(end_first)]
            rings.append(outer)
            starts.append(starts[-1] + len(outer))

    codes = _read_dbf_codes(os.path.splitext(shp_path)[0] + ".dbf", code_field)
    if len(codes) != len(starts) - 1:
        raise MismatchedDataError(
            "dbf record count vs shp shape count",
            len(codes), len(starts) - 1,
        )
    all_rings = (
        np.concatenate(rings, axis=0) if rings else np.zeros((0, 2))
    )
    return codes, all_rings, np.asarray(starts, np.int64)


def _read_dbf_codes(dbf_path: str, field_name: str) -> list[str]:
    with open(dbf_path, "rb") as f:
        header = f.read(32)
        n_records = struct.unpack("<I", header[4:8])[0]
        header_size, record_size = struct.unpack("<HH", header[8:12])
        fields = []
        pos = 32
        while pos < header_size - 1:
            fd = f.read(32)
            if fd[:1] == b"\r":
                break
            name = fd[:11].split(b"\x00")[0].decode("ascii", "replace")
            length = fd[16]
            fields.append((name, length))
            pos += 32
        f.seek(header_size)

        # locate the code field (case-insensitive; fall back to *code*/OA11CD)
        names = [n for n, _ in fields]
        target = None
        for cand in (field_name, field_name.upper(), "OA11CD", "oa11cd"):
            if cand in names:
                target = names.index(cand)
                break
        if target is None:
            for i, n in enumerate(names):
                if "code" in n.lower() or "oa" in n.lower():
                    target = i
                    break
        if target is None:
            raise MissingDataError(f"no code field among {names}")

        offsets = np.cumsum([1] + [l for _, l in fields])
        off, ln = offsets[target], fields[target][1]
        codes = []
        for _ in range(n_records):
            rec = f.read(record_size)
            codes.append(rec[off : off + ln].decode("ascii", "replace").strip())
    return codes


def write_polygons(shp_path: str, codes, polys, code_field: str = "code"):
    """Write a polygon shapefile + dbf (used by tests and the converter
    pipeline; the reference ships pre-converted national-grid shapefiles)."""
    recs = []
    total_len = 50
    for i, poly in enumerate(polys):
        poly = np.asarray(poly, np.float64)
        num_points = len(poly)
        content = struct.pack("<i", SHAPE_POLYGON)
        content += struct.pack(
            "<4d", poly[:, 0].min(), poly[:, 1].min(), poly[:, 0].max(), poly[:, 1].max()
        )
        content += struct.pack("<ii", 1, num_points)
        content += struct.pack("<i", 0)
        content += poly.tobytes()
        recs.append(content)
        total_len += 4 + len(content) // 2

    xs = np.concatenate([np.asarray(p)[:, 0] for p in polys])
    ys = np.concatenate([np.asarray(p)[:, 1] for p in polys])
    with open(shp_path, "wb") as f:
        f.write(struct.pack(">7i", 9994, 0, 0, 0, 0, 0, total_len))
        f.write(struct.pack("<2i", 1000, SHAPE_POLYGON))
        f.write(struct.pack("<4d", xs.min(), ys.min(), xs.max(), ys.max()))
        f.write(struct.pack("<4d", 0, 0, 0, 0))
        for i, content in enumerate(recs):
            f.write(struct.pack(">ii", i + 1, len(content) // 2))
            f.write(content)

    dbf_path = os.path.splitext(shp_path)[0] + ".dbf"
    width = max(len(c) for c in codes)
    with open(dbf_path, "wb") as f:
        f.write(
            struct.pack(
                "<BBBBIHH20x", 3, 24, 1, 1, len(codes), 32 + 32 + 1, 1 + width
            )
        )
        name = code_field.encode().ljust(11, b"\x00")
        f.write(name + b"C" + b"\x00" * 4 + bytes([width]) + b"\x00" * 15)
        f.write(b"\r")
        for c in codes:
            f.write(b" " + c.encode().ljust(width))
        f.write(b"\x1a")

"""ctypes bindings to the native geometry engine (csrc/osm_native.cpp).

The port's copy of ``epidemicsimulator_tpu/data/osm/native.py``.  The
source is the port's own copy of the JAX package's
``native/esucd_native.cc``; :func:`runtime.host_library` compiles it with
the other host sources into the port's host library, under
``build/kernels/`` and named by the hash of its sources and flags, at
first use (plain C ABI + ctypes).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ... import runtime
from ...errors import ValueParsingError

BUILDING_CLASSES = ("Shop", "School", "Hospital", "Household", "WorkPlace", "Unknown")
CLASS_SHOP, CLASS_SCHOOL, CLASS_HOSPITAL, CLASS_HOUSEHOLD, CLASS_WORKPLACE = range(5)

_F64 = ctypes.POINTER(ctypes.c_double)


def parse_pbf(path, bounds=(-90.0, 90.0, -180.0, 180.0)):
    """Parse an OSM PBF extract into (classes, lats, lons, areas) arrays.

    ``bounds``: (min_lat, max_lat, min_lon, max_lon) pre-filter
    (osm_data/src/lib.rs:69-108 boundary filtering).
    """
    lib = runtime.host_library()
    classes = ctypes.POINTER(ctypes.c_int32)()
    lats, lons, areas = _F64(), _F64(), _F64()
    n = ctypes.c_int64()
    rc = lib.esucd_parse_pbf(
        str(path).encode(), bounds[0], bounds[1], bounds[2], bounds[3],
        ctypes.byref(classes), ctypes.byref(lats), ctypes.byref(lons),
        ctypes.byref(areas), ctypes.byref(n),
    )
    if rc != 0:
        raise ValueParsingError(f"esucd_parse_pbf failed with code {rc}")
    count = n.value
    out = (
        np.ctypeslib.as_array(classes, (count,)).copy(),
        np.ctypeslib.as_array(lats, (count,)).copy(),
        np.ctypeslib.as_array(lons, (count,)).copy(),
        np.ctypeslib.as_array(areas, (count,)).copy(),
    )
    for p in (classes, lats, lons, areas):
        lib.esucd_free(p)
    return out


def assign_points_to_polygons(px, py, rings, ring_starts):
    """out[i] = index of the polygon containing point i, or -1.

    ``rings``: (M, 2) concatenated exterior-ring vertices; ``ring_starts``:
    (n_polys+1,) offsets.  Grid-indexed ray casting in C++ — the batch
    replacement for the reference's quadtree containment pass
    (simulator_builder.rs:1322-1366).
    """
    lib = runtime.host_library()
    px = np.ascontiguousarray(px, np.float64)
    py = np.ascontiguousarray(py, np.float64)
    rx = np.ascontiguousarray(rings[:, 0], np.float64)
    ry = np.ascontiguousarray(rings[:, 1], np.float64)
    starts = np.ascontiguousarray(ring_starts, np.int64)
    if len(py) != len(px) or (len(starts) and starts[-1] > len(rx)):
        raise ValueError("assign_points_to_polygons: inconsistent lengths")
    out = np.empty(len(px), np.int32)
    lib.esucd_assign_points(
        px.ctypes.data_as(_F64), py.ctypes.data_as(_F64), len(px),
        rx.ctypes.data_as(_F64), ry.ctypes.data_as(_F64),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(starts) - 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out

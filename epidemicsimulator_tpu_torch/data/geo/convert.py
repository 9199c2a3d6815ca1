"""WGS84 lat/lon -> OSGB36 National Grid easting/northing, vectorised numpy.

The functional equivalent of `osm_data/src/convert.rs` (lat/lon -> cartesian
-> 7-parameter Helmert datum shift -> transverse-Mercator projection), built
from the standard Ordnance Survey formulation ("A guide to coordinate systems
in Great Britain") rather than a port.  Golden tests pin the OS worked
example and round-trips, matching the reference's own test strategy
(convert.rs:221-405).

No pyproj is needed; these ~100 lines are the whole dependency.  The
port's copy of ``epidemicsimulator_tpu/data/geo/convert.py``, operation for
operation, so both give the same float64 bits.
"""

from __future__ import annotations

import numpy as np

# Ellipsoids
WGS84_A, WGS84_B = 6378137.000, 6356752.3142
AIRY_A, AIRY_B = 6377563.396, 6356256.909

# National Grid parameters
NG_F0 = 0.9996012717
NG_LAT0 = np.radians(49.0)
NG_LON0 = np.radians(-2.0)
NG_E0 = 400_000.0
NG_N0 = -100_000.0

# WGS84 -> OSGB36 Helmert parameters (tx m, ty m, tz m, s ppm, rx ry rz arcsec)
HELMERT_WGS84_TO_OSGB36 = (-446.448, 125.157, -542.060, 20.4894,
                           -0.1502, -0.2470, -0.8421)


def latlon_to_cartesian(lat, lon, a, b, h=0.0):
    lat, lon = np.radians(np.asarray(lat, np.float64)), np.radians(
        np.asarray(lon, np.float64)
    )
    e2 = 1 - (b * b) / (a * a)
    nu = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    x = (nu + h) * np.cos(lat) * np.cos(lon)
    y = (nu + h) * np.cos(lat) * np.sin(lon)
    z = ((1 - e2) * nu + h) * np.sin(lat)
    return x, y, z


def cartesian_to_latlon(x, y, z, a, b, iterations=10):
    e2 = 1 - (b * b) / (a * a)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(iterations):
        nu = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
        lat = np.arctan2(z + e2 * nu * np.sin(lat), p)
    lon = np.arctan2(y, x)
    nu = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    h = p / np.cos(lat) - nu
    return np.degrees(lat), np.degrees(lon), h


def helmert(x, y, z, params):
    tx, ty, tz, s_ppm, rx_s, ry_s, rz_s = params
    s = s_ppm * 1e-6
    rx, ry, rz = (np.radians(v / 3600.0) for v in (rx_s, ry_s, rz_s))
    x2 = tx + (1 + s) * x - rz * y + ry * z
    y2 = ty + rz * x + (1 + s) * y - rx * z
    z2 = tz - ry * x + rx * y + (1 + s) * z
    return x2, y2, z2


def osgb36_to_grid(lat, lon):
    """OSGB36 geodetic lat/lon (degrees) -> National Grid (E, N) metres."""
    a, b, f0 = AIRY_A, AIRY_B, NG_F0
    lat = np.radians(np.asarray(lat, np.float64))
    lon = np.radians(np.asarray(lon, np.float64))
    e2 = 1 - (b * b) / (a * a)
    n = (a - b) / (a + b)
    sin_lat, cos_lat, tan_lat = np.sin(lat), np.cos(lat), np.tan(lat)

    nu = a * f0 / np.sqrt(1 - e2 * sin_lat**2)
    rho = a * f0 * (1 - e2) * (1 - e2 * sin_lat**2) ** -1.5
    eta2 = nu / rho - 1

    dlat, slat = lat - NG_LAT0, lat + NG_LAT0
    m = (
        b
        * f0
        * (
            (1 + n + 1.25 * n**2 + 1.25 * n**3) * dlat
            - (3 * n + 3 * n**2 + 21 / 8 * n**3)
            * np.sin(dlat)
            * np.cos(slat)
            + (15 / 8 * (n**2 + n**3)) * np.sin(2 * dlat) * np.cos(2 * slat)
            - (35 / 24 * n**3) * np.sin(3 * dlat) * np.cos(3 * slat)
        )
    )

    i = m + NG_N0
    ii = nu / 2 * sin_lat * cos_lat
    iii = nu / 24 * sin_lat * cos_lat**3 * (5 - tan_lat**2 + 9 * eta2)
    iiia = nu / 720 * sin_lat * cos_lat**5 * (61 - 58 * tan_lat**2 + tan_lat**4)
    iv = nu * cos_lat
    v = nu / 6 * cos_lat**3 * (nu / rho - tan_lat**2)
    vi = (
        nu
        / 120
        * cos_lat**5
        * (5 - 18 * tan_lat**2 + tan_lat**4 + 14 * eta2 - 58 * tan_lat**2 * eta2)
    )

    dl = lon - NG_LON0
    northing = i + ii * dl**2 + iii * dl**4 + iiia * dl**6
    easting = NG_E0 + iv * dl + v * dl**3 + vi * dl**5
    return easting, northing


def wgs84_to_osgb36_latlon(lat, lon):
    x, y, z = latlon_to_cartesian(lat, lon, WGS84_A, WGS84_B)
    x, y, z = helmert(x, y, z, HELMERT_WGS84_TO_OSGB36)
    lat2, lon2, _ = cartesian_to_latlon(x, y, z, AIRY_A, AIRY_B)
    return lat2, lon2


def wgs84_to_national_grid(lat, lon):
    """WGS84 degrees -> National Grid (easting, northing) in metres.

    The full chain used when placing OSM buildings (convert.rs:68-77).
    """
    lat2, lon2 = wgs84_to_osgb36_latlon(lat, lon)
    return osgb36_to_grid(lat2, lon2)

"""Generate a full offline data-directory fixture at arbitrary scale:
census CSVs (NOMIS API long format) + an OSM PBF extract (real-encoding
shape: OSMHeader blob + multi-blob dense groups) + an OA boundary
shapefile — the complete input surface of the real CLI data path
(run/src/load_data.rs:31-125 analog) without network egress.

York scale is 637 OAs x ~310 residents (197,603 citizens,
simulator_builder.rs / BASELINE.md); tests use the same generator at toy
scale.  Distribution choices follow the census tables the reference
parses: 101-bin ages (QS103EW), 9 occupations (KS608 incl. the Teaching
mislabel at index 8), population/area/density (KS101EW), and a
distance-decayed commuting matrix (WF01BEW).

The PyTorch port's copy of ``tools/gen_fixture.py``: it writes the same
files, byte for byte, through the port's modules and its own copy of the
minimal PBF writer (``build_pbf`` below), and imports nothing of JAX.

Usage (library): write_fixture(dir, n_oas=637, pop_per_oa=310, seed=0)
Usage (CLI):     python tools/gen_fixture_torch.py --dir out/fx --oas 637
"""

import argparse
import os
import pathlib
import struct
import sys
import zlib

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

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
# plausible UK occupation mix (KS608 England aggregate, rounded)
OCC_WEIGHTS = np.array([11, 17, 13, 11, 11, 9, 8, 7, 13], np.float64)


# ---- minimal OSM PBF writer ----------------------------------------------

def _varint(x: int) -> bytes:
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _zigzag(x: int) -> int:
    return (x << 1) ^ (x >> 63)


def _field(num: int, wire: int, payload) -> bytes:
    tag = _varint((num << 3) | wire)
    if wire == 0:
        return tag + _varint(payload)
    return tag + _varint(len(payload)) + payload


def _packed(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _primitive_block(nodes, ways) -> bytes:
    """One PrimitiveBlock: a DenseNodes group + one group per way."""
    strings = [b""]
    s_idx = {b"": 0}

    def intern(s: str) -> int:
        b = s.encode()
        if b not in s_idx:
            s_idx[b] = len(strings)
            strings.append(b)
        return s_idx[b]

    groups = []
    if nodes:
        # DenseNodes (delta coded, granularity default 100 -> lat=1e-9*100*v)
        ids, lats, lons, kvs = [], [], [], []
        prev = (0, 0, 0)
        for nid, lat, lon, tags in nodes:
            ilat, ilon = round(lat * 1e7), round(lon * 1e7)
            ids.append(_zigzag(nid - prev[0]))
            lats.append(_zigzag(ilat - prev[1]))
            lons.append(_zigzag(ilon - prev[2]))
            prev = (nid, ilat, ilon)
            for k, v in tags.items():
                kvs.append(intern(k))
                kvs.append(intern(v))
            kvs.append(0)
        dense = (
            _field(1, 2, _packed(ids))
            + _field(8, 2, _packed(lats))
            + _field(9, 2, _packed(lons))
            + _field(10, 2, _packed(kvs))
        )
        groups.append(_field(2, 2, dense))

    for wid, refs, tags in ways:
        keys = _packed([intern(k) for k in tags])
        vals = _packed([intern(v) for v in tags.values()])
        deltas = []
        prev_ref = 0
        for r in refs:
            deltas.append(_zigzag(r - prev_ref))
            prev_ref = r
        way = (
            _field(1, 0, wid)
            + _field(2, 2, keys)
            + _field(3, 2, vals)
            + _field(8, 2, _packed(deltas))
        )
        groups.append(_field(3, 2, way))

    stringtable = b"".join(_field(1, 2, s) for s in strings)
    return _field(1, 2, stringtable) + b"".join(
        _field(2, 2, g) for g in groups
    )


def _blob(type_name: bytes, block: bytes, compress: bool) -> bytes:
    if compress:
        z = zlib.compress(block)
        blob = _field(2, 0, len(block)) + _field(3, 2, z)
    else:
        blob = _field(1, 2, block)
    header = _field(1, 2, type_name) + _field(3, 0, len(blob))
    return struct.pack(">I", len(header)) + header + blob


def _header_block() -> bytes:
    """HeaderBlock with the required_features (4) every real extract
    carries — readers must skip the OSMHeader blob, not choke on it."""
    return (
        _field(4, 2, b"OsmSchema-V0.6")
        + _field(4, 2, b"DenseNodes")
        + _field(16, 2, b"esucd-fixture-writer")
    )


def build_pbf(nodes, ways, compress=True, max_entities=None,
              with_header=False) -> bytes:
    """nodes: [(id, lat, lon, {tags})]; ways: [(id, [refs], {tags})].

    Default: one OSMData blob holding everything (the minimal shape the
    unit tests use).  Real-encoding shape (``with_header=True,
    max_entities=8000``): a leading OSMHeader blob, then multiple OSMData
    blobs with <= max_entities primitives per block — the structure of
    actual planet extracts (osmpbf splits at 8,000 entities/group)."""
    out = b""
    if with_header:
        out += _blob(b"OSMHeader", _header_block(), compress)
    if max_entities is None:
        return out + _blob(
            b"OSMData", _primitive_block(nodes, ways), compress
        )
    chunks = []
    for i in range(0, len(nodes), max_entities):
        chunks.append((nodes[i : i + max_entities], []))
    for i in range(0, len(ways), max_entities):
        chunks.append(([], ways[i : i + max_entities]))
    if not chunks:
        chunks = [([], [])]
    for ns, ws in chunks:
        out += _blob(b"OSMData", _primitive_block(ns, ws), compress)
    return out


def _age_histogram(rng, pop):
    """A UK-ish age pyramid over 101 bins: flat-ish to 50, tapering to 100."""
    bins = np.arange(101, dtype=np.float64)
    w = np.where(bins < 50, 1.3, np.maximum(0.05, 1.3 - (bins - 50) * 0.026))
    w = w * rng.uniform(0.85, 1.15, 101)
    h = np.floor(w / w.sum() * pop).astype(np.int64)
    h[rng.integers(0, 101, int(pop - h.sum()))] += 0  # keep <= pop
    short = int(pop - h.sum())
    if short > 0:
        idx = rng.integers(0, 60, short)
        np.add.at(h, idx, 1)
    return h


def write_fixture(
    dirpath,
    n_oas=637,
    pop_per_oa=310,
    seed=0,
    workplaces_per_oa=6,
    oas_per_school=9,
    lat0=53.90,
    lon0=-1.15,
    mean_occupancy_ratio=2.35,
    hub_fraction=0.20,
    self_fraction=0.25,
    n_hubs=10,
    commute_decay=3.0,
):
    """Write census CSVs + PBF + shapefile into ``dirpath``; returns
    (pbf_path, shp_path, oa_codes).

    Commuting structure mirrors what docs/FIDELITY.md established as
    necessary for the v1.6 trigger anatomy (and what
    `world/census_like.py` encodes): ``self_fraction`` of each OA's
    flows stay home, ``hub_fraction`` go to ``n_hubs`` central hub OAs
    with Zipf attractiveness (the mega-employer structure — York's
    university ~20k / hospital ~9k), and the rest decay with grid
    distance at Laplace scale ``commute_decay``.  Each hub OA carries
    one giant commercial building sized so the hub commuters fit in
    real floorspace (simulator_builder.rs:717-860 first-fit packing
    then turns them into a handful of large mixing groups).
    ``mean_occupancy_ratio`` sets houses per OA so the reference's
    pop/buildings+1 rule (output_area.rs:139) yields size-3 households
    as in the 2011 census."""
    from epidemicsimulator_tpu_torch.data.census.tables import (
        CensusTable, TABLE_SPECS,
    )
    from epidemicsimulator_tpu_torch.data.geo.convert import wgs84_to_national_grid
    from epidemicsimulator_tpu_torch.data.osm.shapefile import write_polygons

    dirpath = pathlib.Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    codes = [f"E00{100000 + i}" for i in range(n_oas)]

    # --- OA grid: gx x gy cells of ~250m over a box near York -------------
    gx = int(np.ceil(np.sqrt(n_oas)))
    gy = int(np.ceil(n_oas / gx))
    dlat, dlon = 0.0023, 0.0038  # ~250m cells
    cell = np.arange(n_oas)
    cx, cy = cell % gx, cell // gx
    lo_lat, lo_lon = lat0 + cy * dlat, lon0 + cx * dlon

    # --- buildings ---------------------------------------------------------
    nodes, ways = [], []
    nid = 1

    def add_node(lat, lon, tags=None):
        nonlocal nid
        nodes.append((nid, lat, lon, tags or {}))
        nid += 1
        return nid - 1

    # hub OAs: the most central grid cells, Zipf attractiveness (one
    # dominant site, census_like.py:250-259 analog)
    center = np.array([gx / 2.0, gy / 2.0])
    cdist = np.abs(cx - center[0]) + np.abs(cy - center[1])
    hub_ids = np.argsort(cdist, kind="stable")[:n_hubs]
    hub_w = 1.0 / np.arange(1, n_hubs + 1)
    hub_w = hub_w / hub_w.sum()

    houses_per_oa = max(2, int(pop_per_oa / mean_occupancy_ratio))
    hub_workers_total = int(n_oas * pop_per_oa * 0.55 * hub_fraction)
    for oa in range(n_oas):
        la0, lo0 = lo_lat[oa], lo_lon[oa]
        for la, lo in zip(
            rng.uniform(la0 + 1e-4, la0 + dlat - 1e-4, houses_per_oa),
            rng.uniform(lo0 + 1e-4, lo0 + dlon - 1e-4, houses_per_oa),
        ):
            add_node(la, lo, {"building": "house"})
        for _ in range(workplaces_per_oa):
            la = rng.uniform(la0 + 2e-4, la0 + dlat - 2e-4)
            lo = rng.uniform(lo0 + 2e-4, lo0 + dlon - 2e-4)
            ring = [
                add_node(la, lo), add_node(la + 8e-5, lo),
                add_node(la + 8e-5, lo + 8e-5), add_node(la, lo + 8e-5),
            ]
            ways.append(
                (10**7 + oa * 64 + len(ways) % 64, ring + [ring[0]],
                 {"building": "commercial"})
            )
        if oa % oas_per_school == 0:
            add_node(la0 + dlat / 2, lo0 + dlon / 2, {"amenity": "school"})
            if oa % (oas_per_school * 8) == 0:
                # a nearby duplicate: exercises dedupe_close_buildings
                add_node(
                    la0 + dlat / 2 + 5e-5, lo0 + dlon / 2 + 5e-5,
                    {"amenity": "school"},
                )
        if oa % 200 == 100:
            add_node(la0 + dlat / 3, lo0 + dlon / 3, {"amenity": "hospital"})

    # mega employers: one giant commercial footprint per hub OA, Zipf-sized
    # so the hub commuters fit in REAL floorspace (first-fit packing then
    # produces a handful of large mixing groups instead of synthetic
    # overflow shards — the deceleration structure of FIDELITY.md)
    for k, hub in enumerate(hub_ids):
        la0, lo0 = lo_lat[hub], lo_lon[hub]
        workers_k = max(50, int(hub_w[k] * hub_workers_total))
        area_m2 = max(2000.0, workers_k * 25.0)
        side_m = float(np.sqrt(area_m2))
        dla = side_m / 111_000.0
        dlo = side_m / (111_000.0 * np.cos(np.radians(la0)))
        cla, clo = la0 + dlat / 2, lo0 + dlon / 2  # centroid in the hub cell
        ring = [
            add_node(cla - dla / 2, clo - dlo / 2),
            add_node(cla + dla / 2, clo - dlo / 2),
            add_node(cla + dla / 2, clo + dlo / 2),
            add_node(cla - dla / 2, clo + dlo / 2),
        ]
        ways.append(
            (2 * 10**7 + k, ring + [ring[0]], {"building": "commercial"})
        )

    pbf_path = dirpath / "fixture.osm.pbf"
    pbf_path.write_bytes(
        build_pbf(nodes, ways, max_entities=8000, with_header=True)
    )

    # --- OA polygons (national grid shapefile) -----------------------------
    polys = []
    for oa in range(n_oas):
        la0, lo0 = lo_lat[oa], lo_lon[oa]
        lats = np.array([la0, la0, la0 + dlat, la0 + dlat])
        lons = np.array([lo0, lo0 + dlon, lo0 + dlon, lo0])
        e, n = wgs84_to_national_grid(lats, lons)
        polys.append(np.c_[e, n])
    shp_path = dirpath / "areas.shp"
    write_polygons(str(shp_path), codes, polys)

    # --- census CSVs (NOMIS API long format) -------------------------------
    rows = ["GEOGRAPHY_NAME,GEOGRAPHY_TYPE,C_AGE,OBS_VALUE,RURAL_URBAN_NAME,"
            "OBS_STATUS,RECORD_OFFSET,RECORD_COUNT"]
    for i, c in enumerate(codes):
        h = _age_histogram(rng, pop_per_oa)
        for c_age in range(1, 102):
            rows.append(
                f"{c},output area,{c_age},{h[c_age - 1]},Total,A,0,0"
            )
    (dirpath / TABLE_SPECS[CensusTable.AGE_STRUCTURE].filename).write_text(
        "\n".join(rows)
    )

    rows = ["GEOGRAPHY_NAME,GEOGRAPHY_TYPE,CELL_NAME,MEASURES_NAME,"
            "OBS_VALUE,OBS_STATUS,RECORD_OFFSET,RECORD_COUNT"]
    for c in codes:
        w = OCC_WEIGHTS * rng.uniform(0.7, 1.3, 9)
        occ = np.floor(w / w.sum() * pop_per_oa * 0.55).astype(int)
        for i, name in enumerate(OCC_NAMES):
            rows.append(
                f'{c},output area,"{name}",Value,{occ[i]},A,0,0'
            )
    (dirpath / TABLE_SPECS[CensusTable.OCCUPATION_COUNT].filename).write_text(
        "\n".join(rows)
    )

    rows = ["GEOGRAPHY_NAME,GEOGRAPHY_TYPE,RURAL_URBAN_NAME,CELL_NAME,"
            "MEASURES_NAME,OBS_VALUE,OBS_STATUS,RECORD_OFFSET,RECORD_COUNT"]
    for c in codes:
        rows.append(f"{c},output area,Total,All usual residents,Value,"
                    f"{pop_per_oa},A,0,0")
        rows.append(f"{c},output area,Total,Lives in a household,Value,"
                    f"{pop_per_oa},A,0,0")
        rows.append(f"{c},output area,Total,Area (Hectares),Value,6,A,0,0")
    (dirpath / TABLE_SPECS[CensusTable.POPULATION_DENSITY].filename
     ).write_text("\n".join(rows))

    # commuting: self / hub / local-decay mixture (census_like.py:148-164
    # analog, the structure FIDELITY.md shows the v1.6 anatomy needs).
    # Flows are integers per WF01BEW; the builder samples work OA from the
    # row CDF, so flow WEIGHTS define the mixture.
    rows = ["CURRENTLY_RESIDING_IN_CODE,PLACE_OF_WORK_TYPE,"
            "PLACE_OF_WORK_NAME,OBS_VALUE,RECORD_OFFSET,RECORD_COUNT"]
    base = 1000  # weight resolution per row
    for i, c in enumerate(codes):
        # self flow
        rows.append(f"{c},OA,{c},{max(1, int(base * self_fraction))},0,0")
        # hub flows (Zipf across the hubs; skip self-duplicates)
        for k, hub in enumerate(hub_ids):
            if hub == i:
                continue
            f = int(round(base * hub_fraction * hub_w[k]))
            if f > 0:
                rows.append(f"{c},OA,{codes[hub]},{f},0,0")
        # local decay to ~24 nearest OAs at Laplace scale commute_decay
        n_dst = min(24, n_oas - 1)
        dx = cx - cx[i]
        dy = cy - cy[i]
        dist = (np.abs(dx) + np.abs(dy)).astype(np.float64)
        dist[i] = 10**9
        near = np.argsort(dist, kind="stable")[:n_dst]
        w = np.exp(-dist[near] / commute_decay)
        w = w / w.sum() * base * (1.0 - self_fraction - hub_fraction)
        for j, f in zip(near, np.maximum(1, np.round(w).astype(int))):
            rows.append(f"{c},OA,{codes[j]},{int(f)},0,0")
    (dirpath / TABLE_SPECS[CensusTable.RESIDES_VS_WORKPLACE].filename
     ).write_text("\n".join(rows))

    return str(pbf_path), str(shp_path), codes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--oas", type=int, default=637)
    ap.add_argument("--pop", type=int, default=310)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import time

    t0 = time.perf_counter()
    pbf, shp, codes = write_fixture(
        args.dir, n_oas=args.oas, pop_per_oa=args.pop, seed=args.seed
    )
    print(f"fixture: {len(codes)} OAs x {args.pop} pop in "
          f"{time.perf_counter() - t0:.1f}s")
    print(f"pbf={pbf} ({os.path.getsize(pbf):,} bytes)")
    print(f"shp={shp}")


if __name__ == "__main__":
    main()

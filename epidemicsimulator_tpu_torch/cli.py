"""Command-line driver of the PyTorch port: the `run` crate equivalent
(run/src/main.rs:68-167).

Modes:

  --download              fetch the four census tables from NOMIS
  --resume ROW --table T  resume a partial table download
  --simulate              build/load the world and run the epidemic
  --calibrate TARGET      fit a parameter to a reference-format
                          global_stats.json instead of simulating
  --synthetic N           use a synthetic world of N citizens (no data files)
  --render                the building-density choropleth and the citizen
                          graph's statistics
  --visualise             OA outlines with the buildings on top
  --visualise-buildings   the classified building scatter

  python -m epidemicsimulator_tpu_torch.cli 1946157112 --directory data \\
      --pbf york.osm.pbf --shapefile york_oas.shp --simulate
  python -m epidemicsimulator_tpu_torch.cli york --census-like \\
      --synthetic 197603 --simulate --params-file v16.json
  python -m epidemicsimulator_tpu_torch.cli york --census-like \\
      --synthetic 197603 --calibrate global_stats.json \\
      --calibrate-range 1e-3,1e-2 --calibrate-replicates 8

The port's copy of ``epidemicsimulator_tpu/cli.py``: it builds the world
from the census CSVs in ``--directory``, the ``.osm.pbf`` extract and the
OA shapefile (or a synthetic world; with ``--use-cache`` it loads the
cached one), runs the Simulator on the card (``--device cpu`` for the
plain versions on the CPU) and writes the four reference JSON artifacts
and ``cli_phases.json`` into ``--output-name``.  ``--calibrate`` fits
``--calibrate-param`` (a DiseaseParams or InterventionThresholds field)
to the SEIRV series of a ``global_stats.json`` by rounds of packed
ensembles on the same device (calibrate.py) and writes the result's JSON
to ``--output-name`` (default ``<area>_calibration.json``).  The world cache, its
geometry sidecar, the OSM parse cache ``<pbf>.parsed.npz`` and
``<world cache>.build_timings.json`` have the JAX package's names and
layout.  ``--devices N`` runs the population-sharded engine over N ranks
(0: one per visible card; with ``--device cpu``, N gloo processes on the
CPU).  ``--render``, ``--visualise`` and ``--visualise-buildings`` draw a
PNG into ``--output-name`` from the world and its geometry sidecar
(``viz/``, matplotlib and networkx on the host).  The downloads and the
drawings compute nothing on a device and run without a card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from .runtime import resolve_device


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="epidemicsimulator-tpu-torch",
        description="Epidemic simulation on an NVIDIA GPU (PyTorch port)",
    )
    p.add_argument("area", help="NOMIS area code (e.g. 1946157112 for York) or a label")
    p.add_argument("--directory", default="data", help="data directory")
    p.add_argument("--grid-size", type=int, default=700_000,
                   help="accepted for reference-CLI parity; unused (geometry is metric)")
    p.add_argument("--use-cache", action="store_true",
                   help="reuse the preprocessed world .npz if present")
    p.add_argument("--allow-download", action="store_true",
                   help="accepted for reference-CLI parity; unused")
    p.add_argument("--simulate", action="store_true")
    p.add_argument("--download", action="store_true")
    p.add_argument("--resume", type=int, default=None, metavar="ROW")
    p.add_argument("--table", default=None,
                   help="with --resume: a CensusTable name (default AGE_STRUCTURE)")
    p.add_argument("--render", action="store_true",
                   help="draw the building-density choropleth and print the "
                   "citizen graph's statistics")
    p.add_argument("--visualise", action="store_true",
                   help="draw the OA outlines with the buildings on top")
    p.add_argument("--visualise-buildings", action="store_true",
                   help="draw the classified building scatter")
    p.add_argument("--synthetic", type=int, default=None, metavar="N_CITIZENS")
    p.add_argument("--census-like", action="store_true",
                   help="with --synthetic: census-shaped structure (England "
                        "age pyramid, KS608 occupations, hub commuting, "
                        "lognormal workplaces) instead of the toy generator")
    p.add_argument("--output-name", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=5000)
    p.add_argument("--chunk-size", type=int, default=250)
    p.add_argument("--calibrate", default=None, metavar="TARGET_JSON",
                   help="fit a parameter so the epidemic matches a "
                   "reference-format global_stats.json (packed-ensemble "
                   "grid refinement; calibrate.py) instead of simulating")
    p.add_argument("--calibrate-param", default="exposure_chance")
    p.add_argument("--calibrate-range", default="1e-4,1e-2",
                   help="lo,hi bracket for the calibrated parameter")
    p.add_argument("--calibrate-replicates", type=int, default=16)
    p.add_argument("--calibrate-rounds", type=int, default=2)
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="run the population-sharded engine over N ranks "
                   "(0 = one per visible card; default: the one-device "
                   "fast path), the analog of the reference CLI's parallel "
                   "engine, run/src/main.rs:64-67")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between state snapshots (0 = off)")
    p.add_argument("--pbf", default=None, help="OSM .pbf extract path")
    p.add_argument("--shapefile", default=None, help="OA boundary shapefile path")
    p.add_argument("--params-file", default=None,
                   help="JSON disease/threshold parameters (default: COVID)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the run's device (cpu: the kernels' plain versions)")
    return p


def _cache_suffix(args) -> str:
    return "_censuslike" if args.census_like else ""


def _world_cache_path(args) -> str:
    return os.path.join(args.directory, f"world_{args.area}{_cache_suffix(args)}.npz")


def _geometry_cache_path(args) -> str:
    return os.path.join(
        args.directory, f"geometry_{args.area}{_cache_suffix(args)}.npz"
    )


def _draws(args) -> bool:
    return args.render or args.visualise or args.visualise_buildings


def load_or_build_world(args, phases=None):
    """-> (World, WorldGeometry or None).  A built world is cached with its
    geometry sidecar (OA rings and the building scatter), which the JAX
    package's CLI reads too; a cached world comes with its sidecar where
    there is one.  A synthetic world's geometry is made where it is saved
    or drawn.  Where the census/OSM pipeline builds it
    and ``phases`` is given, ``phases["world_pipeline"]`` receives the
    wall seconds of its steps: the census tables, the shapefile, the PBF
    (or its parse cache), the national grid, the dedupe (with the first
    import of scipy's KD-tree), ``build_world`` and the cache writes."""
    from .world.geometry import WorldGeometry, synthetic_geometry
    from .world.schema import World

    cache = _world_cache_path(args)
    geo_cache = _geometry_cache_path(args)
    if args.use_cache and os.path.exists(cache):
        logging.info("loading cached world from %s", cache)
        geometry = (WorldGeometry.load_npz(geo_cache)
                    if os.path.exists(geo_cache) else None)
        return World.load_npz(cache), geometry

    if args.synthetic:
        if args.census_like:
            from .world.census_like import generate_census_like_world as gen
        else:
            from .world.synthetic import generate_synthetic_world as gen

        world = gen(
            args.synthetic, n_output_areas=max(4, args.synthetic // 300),
            seed=args.seed,
        )
        geometry = None
        if os.path.isdir(args.directory) or _draws(args):
            geometry = synthetic_geometry(world, seed=args.seed)
        if os.path.isdir(args.directory):
            world.save_npz(cache)
            geometry.save_npz(geo_cache)
        return world, geometry

    # full pipeline: census CSVs + OSM pbf + OA shapefile
    import numpy as np

    from .data.census.container import load_census_data
    from .data.geo.convert import wgs84_to_national_grid
    from .data.osm.native import parse_pbf
    from .data.osm.shapefile import read_polygons
    from .world.preprocess.builder import (
        OSMBuildings,
        build_world,
        dedupe_close_buildings,
    )

    split: dict = {}
    t = time.perf_counter()

    def lap(step):
        nonlocal t
        now = time.perf_counter()
        split[step] = round(now - t, 3)
        t = now

    census = load_census_data(args.directory)
    lap("census_s")
    shp = args.shapefile or os.path.join(
        args.directory, "census_map_areas_converted", f"{args.area}.shp"
    )
    codes, rings, starts = read_polygons(shp)
    lap("shapefile_s")
    pbf = args.pbf or os.path.join(args.directory, f"{args.area}.osm.pbf")
    # OSM parse cache: the npz analog of the reference's bincode cache
    # (osm_data/src/lib.rs:395-474), honoured by --use-cache.
    osm_cache = pbf + ".parsed.npz"
    if args.use_cache and os.path.exists(osm_cache):
        with np.load(osm_cache) as z:
            classes, lats, lons, areas = (
                z["classes"], z["lats"], z["lons"], z["areas"]
            )
    else:
        classes, lats, lons, areas = parse_pbf(pbf)
        np.savez_compressed(
            osm_cache, classes=classes, lats=lats, lons=lons, areas=areas
        )
    lap("pbf_s")
    east, north = wgs84_to_national_grid(lats, lons)
    lap("national_grid_s")
    keep = dedupe_close_buildings(classes, east, north)
    lap("dedupe_s")
    osm = OSMBuildings(
        classes=classes[keep], east=east[keep], north=north[keep],
        areas=areas[keep],
    )
    # per-phase wall clock, the reference's per-init-stage Timer prints
    # (simulator_builder.rs:1168-1290); persisted next to the world cache
    timings: dict = {}
    world = build_world(
        census, osm, rings, starts, codes, seed=args.seed, timings=timings
    )
    lap("build_world_s")
    with open(cache + ".build_timings.json", "w") as f:
        json.dump(timings, f, indent=1)
    world.save_npz(cache)
    geometry = WorldGeometry(
        rings=rings, ring_starts=starts, codes=list(codes),
        b_east=osm.east, b_north=osm.north, b_classes=osm.classes,
    )
    geometry.save_npz(geo_cache)
    lap("caches_written_s")
    if phases is not None:
        phases["world_pipeline"] = split
    return world, geometry


def download(args) -> int:
    """``--download`` and ``--resume ROW --table T``."""
    from .data.census.nomis import (
        GEOGRAPHY_CODES,
        download_all_tables,
        download_table,
    )
    from .data.census.tables import CensusTable, TABLE_SPECS

    os.makedirs(args.directory, exist_ok=True)
    if args.resume is not None:
        table = CensusTable[args.table] if args.table else CensusTable.AGE_STRUCTURE
        dest = os.path.join(args.directory, TABLE_SPECS[table].filename)
        download_table(
            table, GEOGRAPHY_CODES.get(args.area, args.area), dest,
            resume_from_row=args.resume,
        )
    else:
        download_all_tables(args.directory, args.area)
    return 0


def visualise(args, world, geometry) -> int:
    """``--render``, ``--visualise`` and ``--visualise-buildings``."""
    if geometry is None:
        logging.error(
            "visualisation needs geometry: rebuild the world once "
            "without --use-cache (writes the geometry sidecar), or "
            "pass --shapefile"
        )
        return 1
    if args.visualise_buildings:
        # classified building scatter (run/src/main.rs:214-232
        # "raw_buildings.png")
        from .viz.maps import draw_buildings

        out = args.output_name or f"{args.area}_raw_buildings.png"
        draw_buildings(out, geometry.b_east, geometry.b_north,
                       geometry.b_classes)
    elif args.visualise:
        # polygons + building overlay (run/src/main.rs:263-288
        # "BuildingsAndOutputAreas.png")
        from .viz.maps import draw_buildings_and_output_areas

        out = args.output_name or f"{args.area}_buildings_and_oas.png"
        draw_buildings_and_output_areas(
            out, geometry.rings, geometry.ring_starts,
            geometry.b_east, geometry.b_north, geometry.b_classes,
        )
    else:
        # value-coloured OA choropleth: buildings per OA / 100, the
        # reference's BuildingDensity measure (run/src/main.rs:246-261),
        # plus the citizen graph's statistics (visualise.rs:44-59)
        from .viz.graphs import citizen_connections, connected_components_count
        from .viz.maps import draw_output_areas
        from .world.geometry import buildings_per_output_area

        out = args.output_name or f"{args.area}_building_density.png"
        density = buildings_per_output_area(world) / 100.0
        draw_output_areas(
            out, geometry.rings, geometry.ring_starts,
            values=density[: geometry.n_polygons], title="Building density",
        )
        g = citizen_connections(world)
        print(f"There are {g.number_of_nodes()} nodes and "
              f"{g.number_of_edges()} edges")
        print(f"There are {connected_components_count(g)} connected groups")
    logging.info("wrote %s", out)
    return 0


def calibrate(args, world) -> int:
    """``--calibrate``: packed-ensemble rounds on ``--device``."""
    from .calibrate import calibrate as fit, load_target_series
    from .config import Params, SimConfig

    cfg = SimConfig(max_steps=args.max_steps, chunk_size=args.chunk_size)
    base = Params.from_json(args.params_file) if args.params_file else Params.covid()
    target = load_target_series(args.calibrate)
    lo, hi = (float(x) for x in args.calibrate_range.split(","))
    result = fit(
        world, base, cfg, target,
        param=args.calibrate_param, bounds=(lo, hi),
        replicates=args.calibrate_replicates,
        rounds=args.calibrate_rounds, seed=args.seed, device=args.device,
    )
    out_path = args.output_name or f"{args.area}_calibration.json"
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(
        f"calibrated {result['param']} = {result['value']:.6g} "
        f"(score {result['score']['score']:.4f}); wrote {out_path}"
    )
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = make_parser().parse_args(argv)
    if args.download or args.resume is not None:
        return download(args)
    if not _draws(args):
        resolve_device(args.device)  # no card: raise before building anything

    phases: dict = {}  # coarse wall-clock phases -> <output>/cli_phases.json
    t_start = time.perf_counter()

    world, geometry = load_or_build_world(args, phases)
    phases["world_load_or_build_s"] = round(time.perf_counter() - t_start, 2)

    if _draws(args):
        return visualise(args, world, geometry)

    if args.calibrate:
        return calibrate(args, world)

    if args.simulate:
        from .config import Params, SimConfig
        from .engine.simulator import Simulator

        cfg = SimConfig(max_steps=args.max_steps, chunk_size=args.chunk_size)
        params = (
            Params.from_json(args.params_file) if args.params_file else Params.covid()
        )
        out_dir = args.output_name or os.path.join(
            "statistics_output", f"{args.area}_{int(time.time())}"
        )
        ckpt = (
            os.path.join(args.directory, f"ckpt_{args.area}.npz")
            if args.checkpoint_every
            else None
        )
        t0 = time.perf_counter()
        sim = Simulator(
            world, params, cfg, seed=args.seed,
            checkpoint_path=ckpt,
            checkpoint_every_chunks=max(1, args.checkpoint_every // cfg.chunk_size)
            if args.checkpoint_every else 0,
            devices=args.devices, device=args.device,
        )
        phases["sim_init_s"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
        if sim.simulate(out_dir + os.sep) is None:
            return 0  # a rank other than 0 under torchrun writes nothing
        phases["simulate_s"] = round(time.perf_counter() - t0, 2)
        phases["simulate_loop"] = {
            k: round(v, 2) for k, v in sim.last_timing.items()
        }
        phases["total_s"] = round(time.perf_counter() - t_start, 2)
        with open(os.path.join(out_dir, "cli_phases.json"), "w") as f:
            json.dump(phases, f, indent=1)
        logging.info("results dumped to %s", out_dir)
        return 0

    logging.warning("no mode selected; try --simulate or --calibrate")
    return 1


if __name__ == "__main__":
    sys.exit(main())

"""Command-line driver of the PyTorch port: the `run` crate equivalent
(run/src/main.rs:68-167), simulate mode.

  python -m epidemicsimulator_tpu_torch.cli york --synthetic 200000 --simulate
  python -m epidemicsimulator_tpu_torch.cli york --census-like \\
      --synthetic 197603 --simulate --params-file v16.json

The port's copy of ``epidemicsimulator_tpu/cli.py`` for the synthetic and
census-like worlds: it builds (or, with ``--use-cache``, loads) the world,
runs the Simulator on the card (``--device cpu`` for the plain versions
on the CPU) and writes the four reference JSON artifacts and
``cli_phases.json`` into ``--output-name``.  The world cache and its
geometry sidecar have the JAX package's names and layout.  Not offered
yet: the census/OSM pipeline with ``--download`` and ``--resume``
(ROADMAP.md Queue 1 item 3), ``--render`` and ``--visualise*``,
``--calibrate`` (Queue 1 item 5) and ``--devices`` (Queue 1 item 8).
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
    p.add_argument("--use-cache", action="store_true",
                   help="reuse the preprocessed world .npz if present")
    p.add_argument("--simulate", action="store_true")
    p.add_argument("--synthetic", type=int, default=None, metavar="N_CITIZENS")
    p.add_argument("--census-like", action="store_true",
                   help="with --synthetic: census-shaped structure (England "
                        "age pyramid, KS608 occupations, hub commuting, "
                        "lognormal workplaces) instead of the toy generator")
    p.add_argument("--output-name", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=5000)
    p.add_argument("--chunk-size", type=int, default=250)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between state snapshots (0 = off)")
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


def load_or_build_world(args):
    """-> World, or None when the world would need the census/OSM
    pipeline, which is not ported yet.  A built world is cached with its
    geometry sidecar, which the JAX package's CLI reads."""
    from .world.geometry import synthetic_geometry
    from .world.schema import World

    cache = _world_cache_path(args)
    if args.use_cache and os.path.exists(cache):
        logging.info("loading cached world from %s", cache)
        return World.load_npz(cache)

    if not args.synthetic:
        return None
    if args.census_like:
        from .world.census_like import generate_census_like_world as gen
    else:
        from .world.synthetic import generate_synthetic_world as gen

    world = gen(
        args.synthetic, n_output_areas=max(4, args.synthetic // 300),
        seed=args.seed,
    )
    if os.path.isdir(args.directory):
        world.save_npz(cache)
        synthetic_geometry(world, seed=args.seed).save_npz(
            _geometry_cache_path(args))
    return world


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = make_parser().parse_args(argv)
    resolve_device(args.device)  # no card: raise before building anything

    phases: dict = {}  # coarse wall-clock phases -> <output>/cli_phases.json
    t_start = time.perf_counter()

    world = load_or_build_world(args)
    if world is None:
        logging.error(
            "the census/OSM world pipeline is not ported yet (ROADMAP.md "
            "Queue 1 item 3): pass --synthetic N, or --use-cache with a "
            "cached world in --directory")
        return 2
    phases["world_load_or_build_s"] = round(time.perf_counter() - t_start, 2)

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
            device=args.device,
        )
        phases["sim_init_s"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
        sim.simulate(out_dir + os.sep)
        phases["simulate_s"] = round(time.perf_counter() - t0, 2)
        phases["simulate_loop"] = {
            k: round(v, 2) for k, v in sim.last_timing.items()
        }
        phases["total_s"] = round(time.perf_counter() - t_start, 2)
        with open(os.path.join(out_dir, "cli_phases.json"), "w") as f:
            json.dump(phases, f, indent=1)
        logging.info("results dumped to %s", out_dir)
        return 0

    logging.warning("no mode selected; try --simulate")
    return 1


if __name__ == "__main__":
    sys.exit(main())

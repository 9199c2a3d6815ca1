#!/usr/bin/env python3
"""Reference rows for the sharded Y&H run, from the JAX package on the CPU.

    python3 tools/ref_jax_yh4_sharded.py [--ranks 4] [--steps 500]
        [--chunk 250] [--branch fused|xla] [--out DIR]

Runs the JAX package's ``run_fast_sharded`` on a ``--ranks``-device
virtual CPU mesh over the synthetic Yorkshire & Humber world (3,457,142
citizens, 15,669 OAs, seed 0) with transport, ``Params.covid()``,
``starting_infected=20_000``.  ``--branch fused`` (the default) is the
formulation of the package's main path and of the port:
``use_fused_citizen=True, use_pallas_scans=True``, the Pallas kernels in
interpret mode (about 2.5 minutes on 8 CPU cores).  ``--branch xla`` is
the portable branch (``use_fused_citizen=False, use_pallas_scans=False``,
about 1 minute); its home-draw probability is ``-expm1(n * log1p(-p))``
where the fused kernel's is ``1 - exp(n * log(1 - p))``, so a uniform
that falls between the two float32 values draws differently: on this
world one does, at hour 76.  Prints the SEIRV row after each chunk as
JSON, and writes it with the run's settings to
``DIR/summary_<branch>.json`` when ``--out`` is given.  The fused rows
are those that ``chip_smoke.py`` phase 12 holds the port's four ranks on
the card to (``YH4_ROWS``); the port's four gloo ranks on the CPU
(``tools/run_torch_sharded.py --device cpu``) give them too.

This script is a reference: it runs the JAX package, on the CPU only,
and nothing of the port imports it.
"""

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--branch", choices=("fused", "xla"), default="fused")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.ranks}").strip()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
    from epidemicsimulator_tpu.parallel.fastmesh import run_fast_sharded
    from epidemicsimulator_tpu.parallel.mesh import make_mesh

    t = time.perf_counter()
    world = generate_synthetic_world(3_457_142, n_output_areas=15_669, seed=0)
    world_s = time.perf_counter() - t
    fused = args.branch == "fused"
    cfg = SimConfig(max_steps=args.steps, chunk_size=args.chunk,
                    use_fused_citizen=fused, use_pallas_scans=fused)
    t = time.perf_counter()
    _, sw, out = run_fast_sharded(world, Params.covid(), cfg,
                                  make_mesh(args.ranks), seed=0,
                                  starting_infected=20_000)
    run_s = time.perf_counter() - t
    seirv = out.seirv
    if not (seirv.sum(1) == world.n_citizens).all():
        raise AssertionError("a SEIRV row does not sum to N")
    rows = {str(s): seirv[s - 1].tolist()
            for s in range(args.chunk, len(seirv) + 1, args.chunk)}
    summary = dict(
        package="epidemicsimulator_tpu", branch=args.branch, platform="cpu",
        n_citizens=world.n_citizens, ranks=args.ranks, transport=True,
        steps=args.steps, chunk=args.chunk, rows=rows,
        shard_size=int(sw.shard_size), world_s=world_s, run_s=run_s,
        jax=jax.__version__)
    print(json.dumps(summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"summary_{args.branch}.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The population-sharded engine of the PyTorch port on the Y&H world.

    python3 tools/run_torch_sharded.py [--ranks 4] [--steps 500]
        [--chunk 250] [--device cuda|cpu] [--no-transport] [--profile]
        [--out DIR]

The synthetic Yorkshire & Humber world (3,457,142 citizens, 15,669 OAs,
seed 0) is partitioned over ``--ranks`` ranks (``parallel/partition.py``)
and stepped by ``parallel/fastmesh.py`` from ``init_sharded_state(seed=0,
starting_infected=20_000)`` under ``Params.covid()``, in chunks of
``--chunk``: ranks that share one card talk through gloo with their
operands staged in host memory; on the CPU (``--device cpu``) they are
gloo processes with one thread each.  ``--no-transport`` strips the
transport lanes (no riders, no bus), the world on which the sharded run
equals the one-device run.  Every SEIRV row must sum to N.  Prints, and
writes to ``DIR/summary.json`` when ``--out`` is given: the SEIRV row
after each chunk, ms/step by chunk (on one card, ranks that share it: not
a multi-card figure), the kernels' launches summed over the ranks, the
comm backend and the card's name and power limit.  ``--profile`` runs
rank 0 (this process) under cProfile and prints its 15 functions with
the most own time to stderr: where rank 0 waits on the collectives.

``chip_smoke.py`` phase 12 calls :func:`sharded`, :func:`single_card`
and :func:`ensemble` (cell (e)'s 64 York-scale replicas of
``tools/run_torch_ensemble.py`` split over the ranks).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_CITIZENS = 3_457_142
N_OAS = 15_669
STARTING_INFECTED = 20_000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def yh_world(et):
    """The Y&H world on the host."""
    return et.generate_synthetic_world(N_CITIZENS, n_output_areas=N_OAS, seed=0)


def strip_transport(world):
    """The world with no citizen using transport and no riders."""
    import numpy as np

    n = world.n_citizens
    return dataclasses.replace(
        world,
        uses_transport=np.zeros(n, bool),
        ws_uses_transport=np.zeros(n, bool),
        rider_perm=np.zeros(0, np.int32),
        rider_route=np.zeros(0, np.int32),
        rider_mask_compliant=np.zeros(0, bool),
    )


def sharded(et, world, ranks, steps, chunk, device="cuda"):
    """``steps`` steps of ``world`` on ``ranks`` ranks.  Returns a dict:
    ``seirv`` (T, 5), ``chunk_ms`` (ms/step of each chunk, from rank 0's
    clock between chunk ends; the first includes the ranks' start and
    set-up), ``total_s``, ``launches`` (summed over the ranks, the counts
    set to 0 just before), ``comm`` and the partition's ``shard_size``,
    ``n_slots`` and ``n_ghost``."""
    from epidemicsimulator_tpu_torch.parallel import comm, fastmesh

    cfg = et.SimConfig(max_steps=steps, chunk_size=chunk)
    ends = [time.perf_counter()]

    def tick(steps_done, out, state):
        ends.append(time.perf_counter())

    et.reset_launches()
    t = time.perf_counter()
    _, sw, out = fastmesh.run_fast_sharded(
        world, et.Params.covid(), cfg, ranks, seed=0,
        starting_infected=STARTING_INFECTED, device=device, callback=tick)
    launches = dict(et.launches)
    total_s = time.perf_counter() - t
    if not (out.seirv.sum(1) == world.n_citizens).all():
        raise AssertionError("a SEIRV row of the sharded run does not sum to N")
    return dict(seirv=out.seirv, launches=launches, total_s=total_s,
                chunk_ms=[(b - a) * 1e3 / chunk for a, b in zip(ends, ends[1:])],
                comm=comm.placement(ranks, device).comm,
                shard_size=sw.shard_size, n_slots=sw.n_slots,
                n_ghost=sw.n_ghost)


def single_card(et, world, steps, chunk):
    """``steps`` steps of ``world`` on one card (the one-device fast step)
    from the same initial state: the (T, 5) SEIRV rows."""
    import numpy as np

    cfg = et.SimConfig(max_steps=steps, chunk_size=chunk)
    world_dev = world.to("cuda")
    state = et.init_state(world_dev, seed=0, starting_infected=STARTING_INFECTED)
    chunk_fn = et.make_chunk_runner(world_dev, cfg)
    rows = []
    for _ in range(steps // chunk):
        state, out = chunk_fn(et.Params.covid(), state)
        rows.append(out.seirv.cpu().numpy())
    return np.concatenate(rows)


def ensemble(et, base, plist, ranks, steps, chunk, device="cuda"):
    """Cell (e)'s replicas over ``ranks`` ranks (``run_ensemble(devices=
    ranks)``, id-keyed bus streams).  Returns ((R, T, 5) SEIRV, launches
    summed over the ranks, seconds)."""
    from epidemicsimulator_tpu_torch.engine.ensemble import run_ensemble

    cfg = et.SimConfig(max_steps=steps, chunk_size=chunk)
    et.reset_launches()
    t = time.perf_counter()
    seirv = run_ensemble(base, plist, cfg, seed=0, devices=ranks,
                         device=device)
    return seirv, dict(et.launches), time.perf_counter() - t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--no-transport", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    import epidemicsimulator_tpu_torch as et
    from epidemicsimulator_tpu_torch import runtime

    card = runtime.card() if torch.cuda.is_available() else None
    t = time.perf_counter()
    world = yh_world(et)
    if args.no_transport:
        world = strip_transport(world)
    log(f"world built in {time.perf_counter() - t:.2f}s; card {card}")
    if args.profile:
        import cProfile
        import io
        import pstats

        prof = cProfile.Profile()
        prof.enable()
    res = sharded(et, world, args.ranks, args.steps, args.chunk, args.device)
    if args.profile:
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(15)
        log(text.getvalue())
    rows = {str(args.chunk * (c + 1)): res["seirv"][args.chunk * (c + 1) - 1].tolist()
            for c in range(len(res["seirv"]) // args.chunk)}
    summary = dict(
        n_citizens=world.n_citizens, ranks=args.ranks, device=args.device,
        transport=not args.no_transport, steps=args.steps, chunk=args.chunk,
        rows=rows, chunk_ms=res["chunk_ms"], total_s=res["total_s"],
        launches=res["launches"], comm=res["comm"],
        shard_size=res["shard_size"], n_slots=res["n_slots"],
        n_ghost=res["n_ghost"], card=card,
        torch=torch.__version__,
    )
    print(json.dumps(summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a step of the PyTorch port spends its time on the card.

    python3 tools/profile_torch_step.py [--world yh|york|ensemble64|uk]
        [--steps 500] [--profile-from 250] [--table FILE]

Runs a cell step by step on one CUDA card, timing each step on the host
clock around a synchronize, and traces steps ``--profile-from``.. with
torch.profiler.  ``yh``: the main path (the 3,457,142-citizen synthetic
world, seed 0, 20,000 infected, Params.covid()); ``york``: the York v1.6
run (the census-like world of 197,603 citizens, 637 OAs, seed 42, 10
infected, sim seed 0, Params.covid_v16()); ``ensemble64``: the packed
ensemble of ``tools/run_torch_ensemble.py`` (64 replicas of the
208,000-citizen synthetic world, 13,631,488 lanes, its sweep, 10
infected each), stepped by ``engine/packed.py::packed_step`` (a regime
holds a step when any replica is in it); ``uk``: the full UK of
``tools/run_torch_full_uk.py`` (63,000,000 citizens, 227,759 OAs, built
on the card, seed 0, 360,000 infected, Params.covid(), the
fixed-priority vaccination pool).  Prints per-regime step times, the
device's busy and idle share over the traced window and the device time
by kernel: the top 20, then every kernel of ``csrc/`` and the memsets,
then the running scans (``cummax``/``cummin``, the bus side's) per call.
``--table`` writes the profiler's full table to FILE.
"""

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
#: the kernels of csrc/ on the step, listed after the top 20: B1
#: (citizen_tile, in both modes), B2 (runs_reduce, runs_apply, after a
#: memset of its descriptors) and B3 (cumsum_lookback, after a memset of
#: its own)
PORT_KERNELS = ("citizen_tile", "runs_reduce", "runs_apply",
                "cumsum_lookback", "Memset")
#: torch's running max/min kernels (``cummax``/``cummin``, whose CUDA
#: kernels are the scans "with indices"): the bus side's one-row scans
SCAN_KERNELS = ("cummax", "cummin", "with_indices")


def make_cell(et, name):
    """``(step, initial state)`` of a cell: ``step(state) -> state``."""
    from epidemicsimulator_tpu_torch.engine import packed
    from epidemicsimulator_tpu_torch.engine.fastpath import make_step_tables

    cfg = et.SimConfig()
    if name == "ensemble64":
        import run_torch_ensemble as tool

        plist, pe, _ = tool.pack(et, 64)
        tables = packed.make_packed_tables(pe)
        th = plist[0].thresholds
        return (lambda st: packed.packed_step(pe, th, cfg, st, tables)[0],
                packed.init_packed_state(pe, seed=0, starting_infected=10))
    world, state, params = make_world_cell(et, name)
    tables = make_step_tables(world)
    return lambda st: et.step(world, params, cfg, st, tables=tables)[0], state


def make_world_cell(et, name):
    """``(world on the card, initial state, params)`` of a one-world
    cell."""
    if name == "yh":
        world = et.generate_synthetic_world(3_457_142, n_output_areas=15_669,
                                            seed=0).to("cuda")
        return world, et.init_state(world, seed=0, starting_infected=20_000), \
            et.Params.covid()
    if name == "uk":
        import run_torch_full_uk as tool

        world = tool.build(et)[0]
        return world, tool.start(et, world, et.SimConfig()), et.Params.covid()
    world = et.generate_census_like_world(197_603, 637, seed=42).to("cuda")
    return world, et.init_state(world, seed=0), et.Params.covid_v16()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", choices=("yh", "york", "ensemble64", "uk"),
                    default="yh")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--profile-from", type=int, default=250)
    ap.add_argument("--table")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    import epidemicsimulator_tpu_torch as et
    from epidemicsimulator_tpu_torch import runtime

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    step, state = make_cell(et, args.world)
    times = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced_wall = 0.0
    for i in range(args.steps):
        if i == args.profile_from:
            prof.start()
        torch.cuda.synchronize()
        t = time.perf_counter()
        lockdown, hour = np.any(state.lockdown), state.hour + 1
        vax = np.any(state.vaccination_started)
        state = step(state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if i >= args.profile_from:
            traced_wall += dt
        else:
            regime = ("lockdown" if lockdown else
                      "moving, work hour" if 9 <= hour % 24 <= 17
                      else "moving, other hour")
            if not vax:
                regime += ", before vaccination"
            times.setdefault(regime, []).append(dt * 1e3)
    prof.stop()

    card = runtime.card()
    print(f"card {card}; cell {args.world}; steps before the trace, host "
          f"ms/step (median, count):")
    for k, v in times.items():
        print(f"  {k}: {statistics.median(v):.3f} ms ({len(v)} steps)")
    # kernels only: an aten op's own row repeats its kernels' device time
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if evt.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    n_traced = args.steps - args.profile_from
    print(f"traced {n_traced} steps (the tracer slows the host): wall {traced_wall * 1e3 / n_traced:.3f} "
          f"ms/step, device busy {busy_us / 1e3 / n_traced:.3f} ms/step, "
          f"idle share {1 - busy_us / 1e6 / traced_wall:.3f}")
    print("device time by kernel (ms/step, launches/step, name):")
    for us, count, key in rows[:20]:
        print(f"  {us / 1e3 / n_traced:8.4f} {count / n_traced:8.2f}  {key[:90]}")
    print("the port's kernels and memsets (ms/step, launches/step, name):")
    for us, count, key in rows:
        if any(part in key for part in PORT_KERNELS):
            print(f"  {us / 1e3 / n_traced:8.4f} {count / n_traced:8.2f}  {key[:90]}")
    print("running scans (device ms per call, calls/step, name):")
    for us, count, key in rows:
        if any(part in key.lower() for part in SCAN_KERNELS):
            print(f"  {us / 1e3 / count:8.4f} {count / n_traced:8.2f}  {key[:90]}")
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

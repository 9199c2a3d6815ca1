#!/usr/bin/env python3
"""The full UK through one epidemic on one CUDA card.

    python3 tools/run_torch_full_uk_epidemic.py [--max-steps 5000]
        [--chunk 250] [--seeded 3188] [--out DIR]

The port's copy of ``tools/run_full_uk_epidemic.py``: the synthetic
world of 63,000,000 citizens and 227,759 OAs built on the card (seed 0),
``Params.covid()``, ``--seeded`` initial infections (the reference's 10
at 197,603 citizens, scaled by population), the fixed-priority
vaccination pool (auto at this size), no per-OA series, chunks of
``--chunk`` until the S, E and I pools are empty or ``--max-steps``
hours have run.  Every SEIRV row must sum to N.  Writes
``DIR/summary.json`` (default ``sample_results/full_uk_epidemic_torch``)
with the JAX tool's keys and ``card``, ``launches``, ``kernel_build_s``
and ``max_memory_allocated_gb``, and ``DIR/seirv.json``, the SEIRV row
of every hour.  Raises with no CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-steps", type=int, default=5000)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--seeded", type=int, default=3_188,
                    help="initial infections (the reference seeds 10 at "
                    "197,603 citizens, config.rs:27: the same rate at 63M)")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "sample_results", "full_uk_epidemic_torch"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("run_torch_full_uk_epidemic: needs a CUDA device",
              file=sys.stderr)
        return 1
    import epidemicsimulator_tpu_torch as et
    from epidemicsimulator_tpu_torch import runtime

    import run_torch_full_uk as uk
    card = runtime.card()
    t = time.perf_counter()
    runtime.library()
    build_s = time.perf_counter() - t
    world, stages, world_s, build_gb = uk.build(et)
    n = world.n_citizens
    print(f"card {card}; kernels built in {build_s:.2f}s; world built on "
          f"the card in {world_s:.2f}s: {n:,} citizens", flush=True)

    cfg = et.SimConfig(max_steps=args.max_steps, chunk_size=args.chunk,
                       record_exposures_per_oa=False)
    params = et.Params.covid()
    state = uk.start(et, world, cfg, starting_infected=args.seeded)
    pool_on = state.vax_pool.shape[0] == n
    torch.cuda.reset_peak_memory_stats()
    timing = {}

    def callback(steps_done, out, st):
        if not (out.seirv.sum(1) == n).all():
            raise AssertionError("a SEIRV row does not sum to N")
        row = out.seirv[-1]
        print(f"  step {steps_done:>5}: S={row[0]:,} E={row[1]:,} "
              f"I={row[2]:,} R={row[3]:,} V={row[4]:,}; pool size "
              f"{int(st.vax_pool_size):,}", flush=True)

    torch.cuda.synchronize()
    et.reset_launches()
    t0 = time.perf_counter()
    state, outputs = et.run(world, params, cfg, state, callback=callback,
                            timing=timing)
    sim_s = time.perf_counter() - t0
    launches = dict(et.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seirv = np.asarray(outputs.seirv)
    steps = len(seirv)
    summary = {
        "n_citizens": n,
        "n_output_areas": world.n_output_areas,
        "seeded": args.seeded,
        "device": torch.cuda.get_device_name(0),
        "steps_run": steps,
        "epidemic_over": bool(seirv[-1, :3].sum() == 0),
        "peak_infected": int(seirv[:, 2].max()),
        "peak_hour": int(seirv[:, 2].argmax()) + 1,
        "attack_final_R": int(seirv[-1, 3]),
        "final_V": int(seirv[-1, 4]),
        "final_seirv": seirv[-1].tolist(),
        "world_build_s": round(world_s, 3),
        "simulate_s": round(sim_s, 3),
        "ms_per_step": round(sim_s / steps * 1e3, 3),
        "citizen_steps_per_sec": round(n * steps / sim_s),
        "loop": {k: round(v, 3) for k, v in timing.items()},
        "card": card,
        "launches": launches,
        "kernel_build_s": round(build_s, 3),
        "max_memory_allocated_gb": round(max(peak_gb, build_gb), 3),
        "fixed_priority_vax": pool_on,
        "final_vax_pool_size": int(state.vax_pool_size),
        "first_lockdown_lift_hour": next(
            (i + 1 for i in range(1, steps)
             if outputs.lockdown[i - 1] and not outputs.lockdown[i]), None),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(args.out, "seirv.json"), "w") as f:
        json.dump(seirv.tolist(), f, separators=(",", ":"))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

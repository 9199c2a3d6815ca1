#!/usr/bin/env python3
"""The full UK on one CUDA card: 63,000,000 citizens and 227,759 OAs.

    python3 tools/run_torch_full_uk.py [--steps 96] [--chunk 24] [--out DIR]

The port's copy of ``tools/run_full_uk.py``.  The synthetic world is
built on the card (``world/device_build.py``, seed 0), then stepped from
``init_state(seed=0, starting_infected=360_000)`` under
``Params.covid()``: two warm-up chunks, then ``--steps`` timed steps, in
chunks of ``--chunk``.  It times both vaccination selectors: the
fixed-priority pool (``SimConfig.vaccination_fixed_priority`` auto, on
at this size) and the fresh per-step threshold draw (``False``).  Every
SEIRV row must sum to N.  Writes ``DIR/summary.json`` (default
``sample_results/full_uk_torch``) with the JAX tool's keys and ``card``
(name and power limit), ``launches`` (each kernel's count over the pool
run's chunks), ``kernel_build_s`` and ``max_memory_allocated_gb``, and
prints the JAX package's final SEIRV from
``sample_results/full_uk/summary.json`` beside the port's, where the
checkout has it.  Raises with no CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_CITIZENS = 63_000_000
N_OAS = 227_759
STARTING_INFECTED = 360_000
JAX_SUMMARY = os.path.join(ROOT, "sample_results", "full_uk", "summary.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build(et, n=N_CITIZENS, n_oa=N_OAS, seed=0):
    """``(world on the card, seconds by stage, seconds, peak GB)``: the
    device build with the peak memory counter reset just before it."""
    import torch

    from epidemicsimulator_tpu_torch.world.device_build import (
        generate_synthetic_world_device,
    )

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    t = time.perf_counter()
    world = generate_synthetic_world_device(n, n_output_areas=n_oa, seed=seed,
                                            timing=stages)
    torch.cuda.synchronize()
    return (world, stages, time.perf_counter() - t,
            torch.cuda.max_memory_allocated() / 1e9)


def start(et, world, cfg, starting_infected=STARTING_INFECTED):
    """The run's initial state, with the pool's lanes where
    :func:`wants_fixed_priority_vax` asks for them."""
    return et.init_state(
        world, seed=0, starting_infected=starting_infected,
        fixed_priority_vax=et.wants_fixed_priority_vax(world, cfg))


def chunks(et, world, cfg, state, params, n_chunks):
    """Steps ``n_chunks`` chunks; yields ``(state, seirv rows on the host,
    lockdown flags, seconds)`` after each, every row checked to sum to N."""
    import torch

    run = et.make_chunk_runner(world, cfg)
    n = world.n_citizens
    for _ in range(n_chunks):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, out = run(params, state)
        seirv = out.seirv.cpu().numpy()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if not (seirv.sum(1) == n).all():
            raise AssertionError("a SEIRV row does not sum to N")
        yield state, seirv, out.lockdown.cpu().numpy(), dt


def measure(et, world, params, vax_pool, chunk, steps):
    """The JAX tool's measurement: two warm-up chunks, then the timed
    chunks.  Launch counts are set to 0 before the first chunk and read
    after the last."""
    import torch

    cfg = et.SimConfig(max_steps=chunk * 2 + steps, chunk_size=chunk,
                       vaccination_fixed_priority=vax_pool)
    state = start(et, world, cfg)
    pool_on = state.vax_pool.shape[0] == world.n_citizens
    n_timed = steps // chunk
    et.reset_launches()
    res = dict(pool=pool_on, chunk_s=[], pool_size=[])
    for i, (state, seirv, _, dt) in enumerate(
            chunks(et, world, cfg, state, params, 2 + n_timed)):
        res["chunk_s"].append(dt)
        res["pool_size"].append(int(state.vax_pool_size))
        if i == 1:
            log(f"[vax_pool={vax_pool}] seirv after warm-up: "
                f"{seirv[-1].tolist()}")
    res.update(launches=dict(et.launches), final_seirv=seirv[-1].tolist(),
               timed=n_timed * chunk)
    elapsed = sum(res["chunk_s"][2:])
    res["ms"] = elapsed / res["timed"] * 1e3
    res["rate"] = world.n_citizens * res["timed"] / elapsed
    del state
    torch.cuda.synchronize()
    log(f"[vax_pool={vax_pool}] pool {'on' if pool_on else 'off'}; "
        f"{res['timed']} steps in {elapsed:.2f}s ({res['ms']:.2f} ms/step); "
        f"final seirv {res['final_seirv']}; pool size by chunk "
        f"{res['pool_size']}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=96, help="timed steps")
    ap.add_argument("--chunk", type=int, default=24)
    ap.add_argument("--out", default=os.path.join(ROOT, "sample_results",
                                                  "full_uk_torch"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("run_torch_full_uk: needs a CUDA device", file=sys.stderr)
        return 1
    import epidemicsimulator_tpu_torch as et
    from epidemicsimulator_tpu_torch import runtime

    card = runtime.card()
    t = time.perf_counter()
    runtime.library()
    build_s = time.perf_counter() - t
    world, stages, world_s, build_gb = build(et)
    log(f"card {card}; kernels built in {build_s:.2f}s; world built on the "
        f"card in {world_s:.2f}s ({build_gb:.2f} GB peak): "
        f"{world.n_citizens:,} citizens, {world.n_buildings:,} buildings, "
        f"{world.n_rooms:,} rooms, {world.n_riders:,} riders; by stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    params = et.Params.covid()
    torch.cuda.reset_peak_memory_stats()
    pool = measure(et, world, params, None, args.chunk, args.steps)
    fresh = measure(et, world, params, False, args.chunk, args.steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    jax_final = None
    if os.path.exists(JAX_SUMMARY):
        with open(JAX_SUMMARY) as f:
            jax_final = json.load(f)["final_seirv"]
    log(f"final SEIRV after {2 * args.chunk + args.steps} steps: the port "
        f"{pool['final_seirv']}; the JAX package's run "
        f"{jax_final if jax_final else 'not in this checkout'}")

    summary = {
        "n_citizens": world.n_citizens,
        "n_output_areas": world.n_output_areas,
        "n_buildings": world.n_buildings,
        "device": torch.cuda.get_device_name(0),
        "world_build_s": round(world_s, 3),
        "device_transfer_s": 0.0,
        "compile_first_chunk_s": round(pool["chunk_s"][0], 3),
        "timed_steps": pool["timed"],
        "ms_per_step": round(pool["ms"], 3),
        "citizen_steps_per_sec": round(pool["rate"]),
        "ms_per_step_fresh_draw_vax": round(fresh["ms"], 3),
        "citizen_steps_per_sec_fresh_draw_vax": round(fresh["rate"]),
        "final_seirv": pool["final_seirv"],
        "card": card,
        "launches": pool["launches"],
        "kernel_build_s": round(build_s, 3),
        "max_memory_allocated_gb": round(max(peak_gb, build_gb), 3),
        "world_build_stages_s": {k: round(v, 4) for k, v in stages.items()},
        "n_rooms": world.n_rooms,
        "n_riders": world.n_riders,
        "chunk_s": [round(x, 4) for x in pool["chunk_s"]],
        "chunk_s_fresh_draw_vax": [round(x, 4) for x in fresh["chunk_s"]],
        "vax_pool_size_by_chunk": pool["pool_size"],
        "final_seirv_fresh_draw_vax": fresh["final_seirv"],
        "jax_final_seirv": jax_final,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log(f"wrote {args.out}/summary.json")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

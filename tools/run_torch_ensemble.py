#!/usr/bin/env python3
"""64 York-scale replicas of the PyTorch port's packed ensemble on one
CUDA card.

    python3 tools/run_torch_ensemble.py [--steps 2000] [--replicates 64]
        [--chunk 250] [--early-exit sei|ei] [--out DIR]

The port's copy of ``tools/run_ensemble.py`` (packed engine only): the
208,000-citizen synthetic world (649 OAs, seed 0) packed 64 times
(stride 212,992, 13,631,488 lanes), a sweep from ``default_rng(0)`` of
exposure_chance x U(0.5, 1.5), exposed_time in [24, 120) and
infected_time in [96, 336) around ``Params.covid()``, shared thresholds,
10 infected per replica, packed seed 0.  Every replica's row must sum to
208,000 at every step.  Writes ``DIR/summary.json`` (default
``sample_results/ensemble64_torch``) with the keys of the JAX tool's
``ensemble64_summary.json`` and each replica's peak infected and final
R + V, and prints the law-level check against the JAX tool's
``sample_results/ensemble64_seirv.npy``, where the checkout has it: the
number of replicas whose infected count peaks above 100, and both sets
of peak quartiles.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_CITIZENS = 208_000
N_OAS = 649
#: the JAX run's 34 of 64 replicas peak above 100; the port's count must
#: lie in this range
PEAK_ABOVE, LAW_RANGE = 100, (22, 46)
JAX_SEIRV = os.path.join(ROOT, "sample_results", "ensemble64_seirv.npy")


def sweep(et, replicates):
    """The JAX tool's parameter list, from ``default_rng(0)``."""
    import numpy as np

    base = et.Params.covid()
    rng = np.random.default_rng(0)
    return [et.Params(dataclasses.replace(
        base.disease,
        exposure_chance=float(base.disease.exposure_chance * rng.uniform(0.5, 1.5)),
        exposed_time=int(rng.integers(24, 120)),
        infected_time=int(rng.integers(96, 336)),
    ), base.thresholds) for _ in range(replicates)]


def pack(et, replicates):
    """``(params, packed ensemble with its world on the card, pack s)``."""
    import torch

    from epidemicsimulator_tpu_torch.engine import packed

    plist = sweep(et, replicates)
    t = time.perf_counter()
    world = et.generate_synthetic_world(N_CITIZENS, n_output_areas=N_OAS, seed=0)
    pe = packed.pack_replicas(world, plist)
    pe = dataclasses.replace(pe, world=pe.world.to("cuda"))
    torch.cuda.synchronize()
    return plist, pe, time.perf_counter() - t


#: the small card-against-CPU runs: shared thresholds and the replicas'
#: (exposure_chance, exposed_time, infected_time) rows
SMALL_REGIMES = {
    "deterministic": (dict(lockdown=0.2, vaccination=0.05,
                           mask_public_transport=2.0, mask_everywhere=2.0),
                      [(1.0, 6, 12), (1.0, 10, 20), (0.0, 4, 30)]),
    "covid": (dict(lockdown=0.02, vaccination=0.01,
                   mask_public_transport=0.003, mask_everywhere=0.006),
              [(0.05, 6, 12), (0.02, 10, 20), (0.0, 4, 30)]),
}


def small_card_vs_cpu(et, regime, card="cuda"):
    """Three replicas of a 3,000-citizen world with transport (8 OAs,
    seed 6), ``block_rows=32``, 15 infected: 60 steps of the packed
    runner in one of :data:`SMALL_REGIMES` on the card, then on the CPU.
    Returns ``(card_lanes, cpu_lanes, card_launches)``: each lanes list
    holds the (T, R, 5) SEIRV and the final status, timer, sched,
    eligible, mask status and vaccination-started rows as CPU tensors;
    the launch counts are the card run's, set to 0 just before it."""
    import torch

    from epidemicsimulator_tpu_torch.engine import packed

    base = et.Params.covid()
    th_kw, rows = SMALL_REGIMES[regime]
    th = dataclasses.replace(base.thresholds, **th_kw)
    plist = [et.Params(dataclasses.replace(
        base.disease, exposure_chance=ch, exposed_time=e, infected_time=i,
        vaccination_rate=10), th) for ch, e, i in rows]
    world = et.generate_synthetic_world(3000, n_output_areas=8, seed=6)
    pe = packed.pack_replicas(world, plist, block_rows=32)
    cfg = et.SimConfig(max_steps=60, chunk_size=60, starting_infected=15)
    runs = []
    for device in (card, "cpu"):
        state = packed.init_packed_state(pe, seed=0, starting_infected=15,
                                         device=device)
        et.reset_launches()
        state, seirv = packed.make_packed_runner(pe, cfg, device=device)(
            th, state)
        if device is card:
            launches = dict(et.launches)
        runs.append([seirv.cpu(), state.status.cpu(), state.timer.cpu(),
                     state.sched.cpu(), state.eligible.cpu(),
                     torch.from_numpy(state.mask_status),
                     torch.from_numpy(state.vaccination_started)])
    return runs[0], runs[1], launches


def run(et, plist, pe, steps, chunk=250, early_exit="sei"):
    """Steps the packed ensemble from its initial state (seed 0, 10
    infected) until :func:`ensemble_done` or ``steps``, with the launch
    counts set to 0 just before and read just after.  Returns a dict:
    ``seirv`` (R, T, 5) numpy, ``chunk_ms`` (ms/step of each chunk),
    ``first_chunk_s``, ``wall_s``, ``launches``."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch.engine import packed

    cfg = et.SimConfig(max_steps=steps, chunk_size=chunk, starting_infected=10)
    runner = packed.make_packed_runner(pe, cfg)
    state = packed.init_packed_state(pe, seed=0, starting_infected=10)
    th = plist[0].thresholds
    chunks, chunk_ms, done = [], [], 0
    torch.cuda.synchronize()
    et.reset_launches()
    t0 = time.perf_counter()
    while done < steps:
        t = time.perf_counter()
        state, seirv = runner(th, state)
        seirv = seirv.cpu().numpy()
        chunk_ms.append((time.perf_counter() - t) * 1e3 / chunk)
        if not (seirv.sum(2) == pe.rep_size).all():
            raise AssertionError(f"a replica's row does not sum to "
                                 f"{pe.rep_size} in chunk {len(chunks) + 1}")
        chunks.append(seirv)
        done += chunk
        if packed.ensemble_done(seirv[-1], early_exit):
            break
    wall = time.perf_counter() - t0
    launches = dict(et.launches)
    out = np.concatenate(chunks, axis=0)[:steps]
    return dict(seirv=np.transpose(out, (1, 0, 2)), chunk_ms=chunk_ms,
                first_chunk_s=chunk_ms[0] * chunk / 1e3, wall_s=wall,
                launches=launches)


def law_check(seirv):
    """The replicas peaking above 100 and the peak quartiles, the port's
    and (where the checkout has its npy) the JAX run's."""
    import numpy as np

    peaks = seirv[:, :, 2].max(axis=1)
    res = dict(port_above=int((peaks > PEAK_ABOVE).sum()),
               port_quartiles=[float(q) for q in np.percentile(peaks, [25, 50, 75])],
               jax_above=None, jax_quartiles=None)
    if os.path.exists(JAX_SEIRV):
        jpk = np.load(JAX_SEIRV)[:, :, 2].max(axis=1)
        res.update(jax_above=int((jpk > PEAK_ABOVE).sum()),
                   jax_quartiles=[float(q) for q in np.percentile(jpk, [25, 50, 75])])
    res["inside"] = LAW_RANGE[0] <= res["port_above"] <= LAW_RANGE[1]
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--replicates", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--early-exit", choices=["sei", "ei"], default="sei")
    ap.add_argument("--out", default=os.path.join(ROOT, "sample_results",
                                                  "ensemble64_torch"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("run_torch_ensemble: needs a CUDA device", file=sys.stderr)
        return 1
    import epidemicsimulator_tpu_torch as et
    from epidemicsimulator_tpu_torch import runtime

    card = runtime.card()
    t = time.perf_counter()
    runtime.library()
    build_s = time.perf_counter() - t
    plist, pe, pack_s = pack(et, args.replicates)
    print(f"card {card}; kernels built in {build_s:.2f}s; packed "
          f"{pe.world.n_citizens:,} lanes (stride {pe.rep_stride:,}) in "
          f"{pack_s:.2f}s", flush=True)
    res = run(et, plist, pe, args.steps, args.chunk, args.early_exit)
    seirv = res["seirv"]
    steps_run = seirv.shape[1]
    agg = args.replicates * N_CITIZENS * steps_run / res["wall_s"]
    print(f"{args.replicates} replicates x {steps_run} steps in "
          f"{res['wall_s']:.2f}s ({res['wall_s'] * 1e3 / steps_run:.3f} "
          f"ms/step); ms/step by chunk: "
          + " ".join(f"{ms:.3f}" for ms in res["chunk_ms"]), flush=True)
    print(f"launches: {res['launches']}", flush=True)
    law = law_check(seirv)
    print(f"replicas peaking above {PEAK_ABOVE}: port {law['port_above']} "
          f"(must lie in {LAW_RANGE[0]}-{LAW_RANGE[1]}), JAX run "
          f"{law['jax_above']}; peak quartiles: port {law['port_quartiles']}, "
          f"JAX run {law['jax_quartiles']}", flush=True)
    peaks = seirv[:, :, 2].max(axis=1)
    summary = {
        "engine": "packed",
        "early_exit": args.early_exit,
        "n_citizens": N_CITIZENS,
        "replicates": args.replicates,
        "steps": steps_run,
        "wall_s": round(res["wall_s"], 2),
        "compile_first_chunk_s": round(build_s + res["first_chunk_s"], 2),
        "ms_per_ensemble_step": round(res["wall_s"] * 1e3 / steps_run, 3),
        "aggregate_citizen_steps_per_sec": round(agg),
        "peak_infected_min": int(peaks.min()),
        "peak_infected_median": int(np.median(peaks)),
        "peak_infected_max": int(peaks.max()),
        "card": card,
        "kernel_build_s": round(build_s, 2),
        "pack_s": round(pack_s, 2),
        "ms_per_step_by_chunk": [round(ms, 3) for ms in res["chunk_ms"]],
        "launches": res["launches"],
        "law_check": law,
        "peak_infected": [int(p) for p in peaks],
        "final_r_plus_v": [int(x) for x in seirv[:, -1, 3] + seirv[:, -1, 4]],
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("peak_infected", "final_r_plus_v")}), flush=True)
    return 0 if law["inside"] else 2


if __name__ == "__main__":
    sys.exit(main())

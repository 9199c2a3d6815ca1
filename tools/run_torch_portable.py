#!/usr/bin/env python3
"""The PyTorch port's portable step in the three runs of
``chip_smoke.py`` phase 13, on the card or on the CPU.

    python3 tools/run_torch_portable.py [--cell yh|graft|yh_bus|all]
        [--device cuda|cpu] [--out DIR]
    python3 tools/run_torch_portable.py --trace-from 440 [--steps 500]

* ``yh``: the synthetic Yorkshire & Humber world (3,457,142 citizens,
  15,669 OAs, seed 0) with its index tables on one device,
  ``SimConfig(use_fast_path=False)``, ``Params.covid()``,
  ``init_state(seed=0, starting_infected=20_000)``, 500 steps in chunks
  of 250: the prefix branch (kernel B3's range totals) and the rider
  branch of the bus side;
* ``graft``: the "portable ok" gate of ``__graft_entry__.py``'s
  ``dryrun_multichip(4)``: ``parallel/mesh.py::run_sharded`` on 4 ranks
  over 1,000,003 citizens (512 OAs, seed 1), 4 steps,
  ``max_vaccinations_per_step=64``, ``exposure_chance=0.05``,
  ``vaccination_rate=64``, 12,000 infected; the population is conserved
  once the pad is taken out of R, vaccination fired, and the lockdown
  and a mask mandate are on;
* ``yh_bus``: ``run_sharded`` on 4 ranks over the Y&H world, ``covid()``
  with the lockdown off, so riders board from hour 8 and the sharded
  route-key bus branch runs; 20,000 infected, 48 steps in chunks of 24.

On the card the 4 ranks share it and talk through gloo, their operands
staged in host memory (ms/step there is no multi-card figure); on the
CPU they are gloo processes.  Prints, and writes to ``DIR/summary.json``
when ``--out`` is given: each run's SEIRV rows after each chunk, its
whole SEIRV series and per-step bus exposures, the hour the lockdown
lifts, ms/step by chunk, the kernels' launches (summed over the ranks)
and, on the card, its name and power limit; each run's summary is added
to the file as the run ends, beside those already there.  The JAX
package's rows for the same runs come from ``tools/ref_jax_portable.py``.

``--trace-from K`` runs the ``yh`` cell on the card step by step
instead (``--steps``, default 500), times each step on the host clock
around a synchronize, traces steps K.. with torch.profiler, and prints
the host ms/step by regime (median), the device's busy time and idle
share over the traced steps, and the device time by kernel (the top 12).

``chip_smoke.py`` phase 13 calls :func:`yh`, :func:`graft` and
:func:`yh_bus`.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

YH_N, YH_OAS = 3_457_142, 15_669
GRAFT_N = 1_000_003


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _series(seirv, n_bus, lockdown, chunk):
    import numpy as np

    seirv = np.asarray(seirv)
    lock = np.asarray(lockdown, bool)
    return dict(
        rows={str(s): seirv[s - 1].tolist()
              for s in range(chunk, len(seirv) + 1, chunk)},
        seirv=seirv.tolist(),
        n_bus_exposures=np.asarray(n_bus).tolist(),
        lockdown_lifts_at_hour=[
            int(i) + 2 for i in np.flatnonzero(lock[:-1] & ~lock[1:])],
        lockdown_on_at_end=bool(lock[-1]))


def yh(et, world, device="cuda", steps=500, chunk=250):
    """``steps`` portable steps of ``world`` (the Y&H world with its index
    tables, on ``device``), the launch counts set to 0 just before."""
    import numpy as np

    cfg = et.SimConfig(max_steps=steps, chunk_size=chunk, use_fast_path=False)
    state = et.init_state(world, seed=0, starting_infected=20_000,
                          device=device)
    run_chunk = et.make_chunk_runner(world, cfg)
    parts, chunk_ms = [], []
    _sync(device)
    et.reset_launches()
    for _ in range(steps // chunk):
        t = time.perf_counter()
        state, out = run_chunk(et.Params.covid(), state)
        parts.append([x.cpu().numpy() if hasattr(x, "cpu") else x
                      for x in (out.seirv, out.n_bus_exposures, out.lockdown,
                                out.n_vaccinated_now)])
        _sync(device)
        chunk_ms.append((time.perf_counter() - t) * 1e3 / chunk)
    launches = dict(et.launches)
    seirv, n_bus, lock, n_vax = (np.concatenate(x) for x in zip(*parts))
    if not (seirv.sum(1) == world.n_citizens).all():
        raise AssertionError("a SEIRV row does not sum to N")
    return dict(_series(seirv, n_bus, lock, chunk), chunk_ms=chunk_ms,
                n_vaccinated=int(n_vax.sum()), launches=launches,
                final_state=state)


def _sharded(et, world, params, cfg, state, ranks, device):
    from epidemicsimulator_tpu_torch.parallel.mesh import run_sharded

    ends = [time.perf_counter()]

    def tick(steps_done, out, shard_state):
        _sync(device)
        ends.append(time.perf_counter())

    et.reset_launches()
    t = time.perf_counter()
    final, out = run_sharded(world, params, cfg, state, devices=ranks,
                             device=device, callback=tick)
    total_s = time.perf_counter() - t
    chunk_ms = [(b - a) * 1e3 / cfg.chunk_size for a, b in zip(ends, ends[1:])]
    return final, out, dict(chunk_ms=chunk_ms, total_s=total_s,
                            launches=dict(et.launches),
                            n_pad=(-world.n_citizens) % ranks)


def graft(et, ranks=4, device="cuda"):
    """The "portable ok" gate of ``__graft_entry__.py`` on ``ranks``
    ranks.  Returns the run's summary; raises where a gate fails."""
    import numpy as np

    world = et.generate_synthetic_world(GRAFT_N, n_output_areas=512, seed=1)
    cfg = et.SimConfig(max_steps=4, chunk_size=4, max_vaccinations_per_step=64)
    base = et.Params.covid()
    params = et.Params(dataclasses.replace(base.disease, exposure_chance=0.05,
                                           vaccination_rate=64),
                       base.thresholds)
    state = et.init_state(world, seed=0, starting_infected=12_000,
                          device="cpu")
    _, out, info = _sharded(et, world, params, cfg, state, ranks, device)
    seirv = np.asarray(out.seirv).copy()
    seirv[:, 3] -= info["n_pad"]
    if not (seirv.sum(axis=1) == GRAFT_N).all():
        raise AssertionError("population not conserved after pad subtraction")
    if not (seirv >= 0).all():
        raise AssertionError("a negative count")
    if not seirv[-1, 4] > 0:
        raise AssertionError("vaccination never fired")
    if not bool(out.lockdown[-1]):
        raise AssertionError("lockdown never engaged")
    if not int(out.mask_status[-1]) > 0:
        raise AssertionError("mask policy never engaged")
    return dict(_series(out.seirv, out.n_bus_exposures, out.lockdown, 4),
                mask_status_at_end=int(out.mask_status[-1]),
                n_vaccinated=int(np.asarray(out.n_vaccinated_now).sum()),
                **info)


def yh_bus(et, world, ranks=4, device="cuda", steps=48, chunk=24):
    """``run_sharded`` over ``world`` (the Y&H world, on the host) with
    the lockdown off."""
    import numpy as np

    base = et.Params.covid()
    params = et.Params(base.disease,
                       dataclasses.replace(base.thresholds, lockdown=-1.0))
    cfg = et.SimConfig(max_steps=steps, chunk_size=chunk)
    state = et.init_state(world, seed=0, starting_infected=20_000,
                          device="cpu")
    _, out, info = _sharded(et, world, params, cfg, state, ranks, device)
    if not (np.asarray(out.seirv).sum(1) == world.n_citizens
            + info["n_pad"]).all():
        raise AssertionError("a SEIRV row does not sum to N plus the pads")
    return dict(_series(out.seirv, out.n_bus_exposures, out.lockdown, chunk),
                n_vaccinated=int(np.asarray(out.n_vaccinated_now).sum()),
                **info)


def trace_yh(et, world, steps, trace_from):
    """The ``yh`` cell step by step on the card, steps ``trace_from``..
    under torch.profiler (see the module's docstring)."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = et.SimConfig(use_fast_path=False)
    params = et.Params.covid()
    state = et.init_state(world, seed=0, starting_infected=20_000)
    times, traced_s = {}, 0.0
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i in range(steps):
        if i == trace_from:
            prof.start()
        regime = ("lockdown" if state.lockdown else "work hour"
                  if 9 <= (state.hour + 1) % 24 <= 17 else "moving")
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = et.step(world, params, cfg, state)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if i >= trace_from:
            traced_s += dt
        elif i > 0:  # the first step builds nothing, but warms the allocator
            times.setdefault(regime, []).append(dt * 1e3)
    prof.stop()
    rows = sorted(
        ((getattr(e, "self_device_time_total", 0), e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA
         and getattr(e, "self_device_time_total", 0) > 0), reverse=True)
    n = steps - trace_from
    busy_s = sum(r[0] for r in rows) / 1e6
    return dict(
        host_ms_by_regime={k: [statistics.median(v), len(v)]
                           for k, v in times.items()},
        traced_steps=n, traced_ms_per_step=traced_s * 1e3 / n,
        device_busy_ms_per_step=busy_s * 1e3 / n,
        idle_share=1 - busy_s / traced_s,
        top_kernels=[[us / 1e3 / n, c / n, key[:90]]
                     for us, c, key in rows[:12]])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=("yh", "graft", "yh_bus", "all"),
                    default="all")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-from", type=int, default=None)
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args()

    import torch

    import epidemicsimulator_tpu_torch as et
    from epidemicsimulator_tpu_torch import runtime

    dev = args.device
    if args.trace_from is not None:
        world = et.generate_synthetic_world(YH_N, n_output_areas=YH_OAS,
                                            seed=0).to("cuda")
        print(json.dumps(dict(card=runtime.card(), portable_yh_trace=trace_yh(
            et, world, args.steps, args.trace_from)), indent=1))
        return 0
    path = os.path.join(args.out, "summary.json") if args.out else None
    summary = {}
    if path and os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)
    summary.update(package="epidemicsimulator_tpu_torch", device=dev,
                   torch=torch.__version__)
    if dev == "cuda":
        summary["card"] = runtime.card()
    cells = ("yh", "graft", "yh_bus") if args.cell == "all" else (args.cell,)
    world = (et.generate_synthetic_world(YH_N, n_output_areas=YH_OAS, seed=0)
             if {"yh", "yh_bus"} & set(cells) else None)
    for name in cells:
        if name == "yh":
            res = yh(et, world.to(dev), device=dev)
            res.pop("final_state")
        elif name == "graft":
            res = graft(et, device=dev)
        else:
            res = yh_bus(et, world, device=dev)
        summary[name] = res
        print(json.dumps({name: {k: v for k, v in res.items()
                                 if k not in ("seirv", "n_bus_exposures")}}),
              flush=True)
        if path:
            os.makedirs(args.out, exist_ok=True)
            with open(path, "w") as f:
                json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Reference rows for the portable step's three runs, from the JAX
package on the CPU.

    python3 tools/ref_jax_portable.py [--cell yh|graft|yh_bus|all] [--out DIR]

The three runs of ``chip_smoke.py`` phase 13, each in the JAX package's
portable formulation (``SimConfig(use_fast_path=False)``, which has no
Pallas call):

* ``yh``: one device, the synthetic Yorkshire & Humber world (3,457,142
  citizens, 15,669 OAs, seed 0) with its index tables, so the prefix
  branch and the rider branch run; ``Params.covid()``,
  ``init_state(seed=0, starting_infected=20_000)``, 500 steps in chunks
  of 250 (about 2 minutes on 8 CPU cores);
* ``graft``: the "portable ok" gate of ``__graft_entry__.py``'s
  ``dryrun_multichip(4)``: ``run_sharded`` on a 4-device CPU mesh over
  1,000,003 citizens, 512 OAs, seed 1, 4 steps,
  ``max_vaccinations_per_step=64``, ``exposure_chance=0.05``,
  ``vaccination_rate=64`` and 12,000 infected;
* ``yh_bus``: ``run_sharded`` on a 4-device CPU mesh over the Y&H world
  with ``covid()`` and the lockdown off (``thresholds.lockdown = -1``),
  so riders board from hour 8 and the sharded route-key bus branch runs;
  20,000 infected, 48 steps in chunks of 24.

Prints each run's summary as JSON (the SEIRV rows after each chunk, the
whole SEIRV series and the per-step bus exposures, the hour the lockdown
lifts, the pad count of the sharded runs, which stays in the R column)
and writes them to ``DIR/summary.json`` when ``--out`` is given
(``sample_results/portable_cpu_jax/``).  ``tools/run_torch_portable.py``
runs the same three with the port.

This script is a reference: it runs the JAX package, on the CPU only,
and nothing of the port imports it.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

YH_N, YH_OAS = 3_457_142, 15_669


def _summary(out, chunk, n_citizens, n_pad, run_s):
    seirv = np.asarray(out.seirv)
    if not (seirv.sum(1) == n_citizens + n_pad).all():
        raise AssertionError("a SEIRV row does not sum to N plus the pads")
    lock = np.asarray(out.lockdown)
    lifts = [int(h) + 1 for h in np.flatnonzero(lock[:-1] & ~lock[1:]) + 1]
    return dict(
        rows={str(s): seirv[s - 1].tolist()
              for s in range(chunk, len(seirv) + 1, chunk)},
        seirv=seirv.tolist(),
        n_bus_exposures=np.asarray(out.n_bus_exposures).tolist(),
        n_vaccinated=int(np.asarray(out.n_vaccinated_now).sum()),
        lockdown_lifts_at_hour=lifts,
        lockdown_on_at_end=bool(lock[-1]),
        mask_status_at_end=int(np.asarray(out.mask_status)[-1]),
        n_pad=n_pad, run_s=run_s)


def yh(jax_mods):
    Params, SimConfig, gen, init_state, run = (
        jax_mods["Params"], jax_mods["SimConfig"], jax_mods["gen"],
        jax_mods["init_state"], jax_mods["run"])
    world = gen(YH_N, n_output_areas=YH_OAS, seed=0).device_put()
    state = init_state(world, seed=0, starting_infected=20_000)
    cfg = SimConfig(max_steps=500, chunk_size=250, use_fast_path=False)
    t = time.perf_counter()
    _, out = run(world, Params.covid(), cfg, state)
    return dict(_summary(out, 250, YH_N, 0, time.perf_counter() - t),
                n_citizens=YH_N, steps=500, chunk=250, seed=0,
                starting_infected=20_000, params="covid()",
                index_tables=True)


def graft(jax_mods):
    Params, SimConfig, gen, init_state = (
        jax_mods["Params"], jax_mods["SimConfig"], jax_mods["gen"],
        jax_mods["init_state"])
    from epidemicsimulator_tpu.parallel.mesh import make_mesh, run_sharded

    n = 1_000_003
    world = gen(n, n_output_areas=512, seed=1)
    cfg = SimConfig(max_steps=4, chunk_size=4, max_vaccinations_per_step=64)
    base = Params.covid()
    params = Params(dataclasses.replace(base.disease, exposure_chance=0.05,
                                        vaccination_rate=64), base.thresholds)
    state = init_state(world, seed=0, starting_infected=12_000)
    t = time.perf_counter()
    _, out = run_sharded(world, params, cfg, state, make_mesh(4))
    return dict(_summary(out, 4, n, (-n) % 4, time.perf_counter() - t),
                n_citizens=n, n_output_areas=512, world_seed=1, ranks=4,
                steps=4, chunk=4, starting_infected=12_000,
                max_vaccinations_per_step=64, exposure_chance=0.05,
                vaccination_rate=64)


def yh_bus(jax_mods):
    Params, SimConfig, gen, init_state = (
        jax_mods["Params"], jax_mods["SimConfig"], jax_mods["gen"],
        jax_mods["init_state"])
    from epidemicsimulator_tpu.parallel.mesh import make_mesh, run_sharded

    world = gen(YH_N, n_output_areas=YH_OAS, seed=0)
    base = Params.covid()
    params = Params(base.disease,
                    dataclasses.replace(base.thresholds, lockdown=-1.0))
    cfg = SimConfig(max_steps=48, chunk_size=24)
    state = init_state(world, seed=0, starting_infected=20_000)
    t = time.perf_counter()
    _, out = run_sharded(world, params, cfg, state, make_mesh(4))
    return dict(_summary(out, 24, YH_N, (-YH_N) % 4,
                         time.perf_counter() - t),
                n_citizens=YH_N, ranks=4, steps=48, chunk=24, seed=0,
                starting_infected=20_000,
                params="covid(), thresholds.lockdown = -1")


CELLS = {"yh": yh, "graft": graft, "yh_bus": yh_bus}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=(*CELLS, "all"), default="all")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4").strip()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
    from epidemicsimulator_tpu.engine.scan import run
    from epidemicsimulator_tpu.engine.state import init_state

    mods = dict(Params=Params, SimConfig=SimConfig,
                gen=generate_synthetic_world, init_state=init_state, run=run)
    path = os.path.join(args.out, "summary.json") if args.out else None
    summary = {}
    if path and os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)
    for name in CELLS if args.cell == "all" else (args.cell,):
        summary[name] = CELLS[name](mods)
        print(json.dumps({name: {k: v for k, v in summary[name].items()
                                 if k not in ("seirv", "n_bus_exposures")}}),
              flush=True)
    summary.update(package="epidemicsimulator_tpu", platform="cpu",
                   formulation="SimConfig(use_fast_path=False)",
                   jax=jax.__version__)
    if path:
        os.makedirs(args.out, exist_ok=True)
        with open(path, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:

1. the card (``nvidia-smi``) and the build of the kernels (one ``nvcc``
   per ``epidemicsimulator_tpu_torch/csrc/*.cu``, all at once, beside the
   host compiler's build of the Beneš router, ``csrc/*.cpp``);
2. each kernel against its plain torch version on the card, at the main
   path's shapes (N = 3,457,142), on inputs made from a numpy seed, with
   its time, the plain version's time and its memory bound.  B1 runs
   under all four combinations of its two reference flags, with a q of
   NaN among them, with q and without; B2 on the world's masks, on random
   nested runs, on one run over the whole lane, on every element its own
   run, on runs of ~20,000 and on lanes one byte off 16-byte alignment.
   B1's and B2's records also carry their device time and device
   operations per call (torch.profiler) and their wrappers' host time per
   call;
3. the main path: the synthetic Yorkshire & Humber world (3,457,142
   citizens, 15,669 OAs, seed 0), ``init_state(seed=0,
   starting_infected=20_000)``, ``Params.covid()``, two chunks of 250
   steps, with each kernel's launches in that run;
4. the cumsum path, ``path`` and ``turns`` of
   ``tools/probe_torch_cumsum.py`` (off the fused step): kernel B4
   against its plain version bitwise on lanes of 3,457,142 (0/1 and
   signed) and 63,000,000; then, with the launch counts set to 0, B3 and
   B4 on the 63M lane, each equal to ``torch.cumsum`` and timed beside
   it; then B3, B4 and ``torch.cumsum`` timed in turns at both sizes.
   B4's record carries its device time and device operations per call at
   63M and its wrapper's host time per call at 3,457,142;
5. the Beneš path, ``replay`` of ``tools/probe_torch_benes.py`` (off the
   fused step): the world's ``work_perm`` routed on the host; with the
   launch counts set to 0, kernel B5 replays a payload forward and in
   reverse, equal to the gathers ``x[work_perm]`` and ``x[wpos]`` and
   timed beside them; then B5 against its plain replay on that table and
   on random control bytes;
6. the port on the card against the port's plain path on the CPU, on a
   small world in the deterministic regime, bitwise;
7. the Simulator and CLI: the port's CLI, in-process, runs the
   census-like York world (197,603 citizens, seed 0) under
   ``Params.covid_v16()`` (written by ``Params.to_json``) to the end of
   its epidemic, chunk 250, with each kernel's launches in that run; the
   four artifacts and ``cli_phases.json`` are checked, and the run's
   peak, peak hour, attack, max V, end hour and ms/step are printed
   beside the JAX package's 32-seed ranges
   (``sample_results/york_v16/summary.json``, where the checkout has it);
   then a Simulator on the CLI's cached world checkpoints after 250 steps
   and a second one resumes from the file, and their SEIRV must equal
   rows 1-250 and 251-500 of the CLI run, bitwise;
8. the census/OSM pipeline: ``tools/run_torch_york_pipeline.py`` writes
   the York fixture (637 OAs x 310 residents, fixture seed 0, with
   ``tools/gen_fixture_torch.py``: census CSVs, a PBF extract and an OA
   shapefile) and, with the launch counts set to 0 just before, runs the
   port's CLI on it (``--pbf --shapefile --simulate``, ``covid_v16``,
   sim seed 1, at most 5,000 steps, chunk 250) to the end of its
   epidemic; the four artifacts are checked as in phase 7, and N, the
   OAs left after filtering, the builder's eight phase times,
   ``cli_phases.json``, ms/step by chunk, the launches and the five
   envelope values beside the JAX package's 32-seed ranges (scaled by
   N / 197,603) are printed;
9. the packed ensemble, with ``tools/run_torch_ensemble.py``: the
   208,000-citizen synthetic world packed 64 times (13,631,488 lanes) for
   that tool's sweep; (a) B1's ensemble mode against its plain version
   on those lanes, a random state and rows that differ per replica,
   lanes and (64, 8) census bitwise, timed beside its bound; (b) three
   replicas of 3,000 citizens, deterministic and ``covid()``, 60 steps,
   the card equal to the CPU's plain path bitwise; (c) with the launch
   counts set to 0 just before, 1,000 steps of the 64 replicas (10
   infected each, chunk 250), every replica's row summing to 208,000 at
   every step, ms/step by chunk and the launches of B1 and B2;
10. calibration through the port's CLI on the card: ``--calibrate`` on
   phase 7's cached York world against phase 7's own
   ``global_stats.json`` (exposure chance 0.003), ``--params-file``
   holding ``covid_v16()``, range 1e-3..1e-2, 8 replicates, 1 round, at
   most 1,750 steps; the fitted value must lie in [0.0015, 0.006];
11. the full-UK path, with ``tools/run_torch_full_uk.py``: (a)
   ``build_tables_device`` on the card, fed the core lanes of phase 1's
   Y&H world, every lane equal to that world's host-built tables; (b)
   the synthetic world of 63,000,000 citizens and 227,759 OAs (seed 0)
   built on the card, its seconds by stage, sizes and peak memory
   printed, ``World.validate()`` passing; (c) with the launch counts set
   to 0 just before, ``init_state(seed=0, starting_infected=360_000)``
   with the fixed-priority vaccination pool, ``covid()``, two chunks of
   250 steps, every SEIRV row summing to N, ms/step by chunk, the pool's
   size at each chunk end, the launches and the peak memory printed;
   after chunk 1, B1, B2 and B3 held against their plain versions at
   63M (``hold_step_kernels``: B1 on the live state, with and without
   movement; B2 on the world's masks over the live infected lane and a
   random 0/1 lane; B3 on the live eligible lane), their launches taken
   off the counts;
   (d) the same run on the device-built world of 16,000,000 citizens and
   57,843 OAs (seed 0), chunk 24, whose rows after steps 24 and 48 must
   equal those of the port's and the JAX package's CPU runs
   (:data:`UK16_ROWS`);
12. the population-sharded engine, with ``tools/run_torch_sharded.py``,
   four ranks sharing the one card (``parallel/launch.py`` starts ranks
   1-3; gloo with the operands staged in host memory; ms/step from such
   a run is not a multi-card figure): (a) B1's ``gid0`` mode against its
   plain version on the Y&H lanes with gid0 = 0, 864,286 and 2**31 - 7,
   in the one-world mode (with q, as phase 2 holds it, and the lanes and
   census bitwise) and in the ensemble mode on phase 9's 64 packed
   replicas (lanes and census bitwise), timed beside its bound; (b) the
   Y&H world of phase 1, seed 0, 20,000 infected, ``covid()``, chunk
   250: without transport, 250 steps on 4 ranks equal to the one-card
   run, row for row; with transport, 500 steps on 4 ranks whose rows
   after steps 250 and 500 must equal :data:`YH4_ROWS`, every row summing
   to N, with ms/step by chunk, the launches summed over the ranks (the
   counts set to 0 just before) and the comm backend printed; (c) cell
   (e)'s 64 York-scale replicas over 4 ranks (``run_ensemble(devices=
   4)``), 250 steps, equal to phase 9's one-card packing run under
   id-keyed bus streams, bitwise;
13. the portable step (``SimConfig(use_fast_path=False)``,
   ``tools/run_torch_portable.py``): (a) phase 1's Y&H world with its
   index tables on the card, seed 0, 20,000 infected, ``covid()``, 500
   steps in chunks of 250 (the prefix branch's range totals with kernel
   B3, the rider branch of the bus side), whose rows after steps 250 and
   500 must equal :data:`PORTABLE_ROWS`, with bus hours after the
   lockdown lifts at the JAX run's hour, ms/step by chunk, and then B3
   against its plain version on the run's live lanes; (b) the "portable
   ok" gate of ``__graft_entry__.py``'s ``dryrun_multichip(4)`` on 4
   ranks sharing the card (``parallel/mesh.py::run_sharded``, 1,000,003
   citizens, 4 steps: conservation once the pad is out of R, vaccination,
   lockdown and masks), its last row equal to :data:`PORTABLE_ROWS`; (c)
   the Y&H world on 4 ranks with the lockdown off, 48 steps in chunks of
   24 (the per-rank route-key bus branch), its rows equal to
   :data:`PORTABLE_ROWS`.

Each kernel's record names the path it runs on; its ``launches`` are
the count from that path's run, ``main_path_launches`` the count from
the main path's (0 for B4 and B5), ``york_launches`` the count from
phase 7's CLI run, ``pipeline_launches`` the count from phase 8's,
``ensemble_launches`` the count from phase 9's 1,000 steps,
``calibration_launches`` the count from phase 10's, ``uk_launches`` the
count from phase 11's 500 steps at 63M, ``sharded_launches`` the count
from phase 12's 500 steps on 4 ranks with transport (summed over the
ranks), ``sharded_ensemble_launches`` the count from phase 12 (c),
``portable_launches`` the count from phase 13 (a) and
``portable_sharded_launches`` the count from phase 13 (b) and (c)
(summed over the ranks).
B1's ensemble mode has a record of its own, ``citizen_phase_ensemble``,
and so has its ``gid0`` mode, ``citizen_phase_gid0``: B1's launches on
phase 12's paths (both modes; each rank passes its shard's first global
id, 0 on rank 0) count in that record alone, and its one-card counts are
0, so that no launch is counted in two records.  The
last two lines are the card's name and power limit and ``{"ok": true,
"device": {...}}``.  Any failure exits non-zero, and so does a machine
with no CUDA device.  Imports nothing of JAX.
"""

import concurrent.futures
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N_CITIZENS = 3_457_142
N_OAS = 15_669
CHUNK = 250
YORK_N = 197_603
SEIRV_KEYS = ("susceptible", "exposed", "infected", "recovered", "vaccinated")
#: phase 11 (d): the SEIRV rows after steps 24 and 48 of the 16M run,
#: as the port and the JAX package computed them on the CPU
UK16_ROWS = {24: [15597094, 11759, 355998, 0, 35149],
             48: [15548977, 23282, 355998, 0, 71743]}
#: phase 12 (b): the SEIRV rows after steps 250 and 500 of the Y&H world
#: with transport on 4 ranks, as the JAX package's ``run_fast_sharded``
#: computed them on a 4-device CPU mesh in its fused formulation, the
#: port's (``tools/ref_jax_yh4_sharded.py``,
#: ``sample_results/yh4_sharded_cpu_jax/``); the port's 4 gloo ranks on
#: the CPU give them too (``tools/run_torch_sharded.py --device cpu``).
#: Step 250 is the one-card row (the lockdown keeps everyone off the
#: buses until then); step 500 differs from it, the bus keys being per
#: rank.
YH4_ROWS = {250: [3070400, 2381, 23599, 0, 360762],
            500: [2741356, 2281, 7279, 21405, 684821]}
#: phase 13: the SEIRV rows of the portable step's three runs, as the JAX
#: package computed them on the CPU in its portable formulation,
#: ``SimConfig(use_fast_path=False)`` (``tools/ref_jax_portable.py``,
#: ``sample_results/portable_cpu_jax/``); the port's CPU path gives them
#: too (``tools/run_torch_portable.py --device cpu``,
#: ``sample_results/portable_cpu_torch/``).  (a) the Y&H world on one
#: card, after steps 250 and 500 (the lockdown lifts at hour 337, so the
#: buses run from hour 344); (b) the "portable ok" gate of
#: ``__graft_entry__.py`` on 4 ranks, after step 4, the pad in R; (c) the
#: Y&H world on 4 ranks with the lockdown off, after steps 24 and 48, the
#: two pads in R.
PORTABLE_ROWS = {
    "yh": {250: [3070559, 2366, 23668, 0, 360549],
           500: [2741333, 2294, 7273, 21410, 684832]},
    "graft": {4: [981761, 6116, 11934, 1, 192]},
    "yh_bus": {24: [3400196, 1994, 19938, 2, 35014],
               48: [3362100, 3891, 19938, 2, 71213]},
}
#: the hour the lockdown lifts in the JAX run of PORTABLE_ROWS["yh"]
PORTABLE_YH_LIFT = 337
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_INT32_OPS_PER_S = 33.5e12  # non-tensor INT32, H100 SXM data sheet
T0 = time.perf_counter()


def say(msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def bound(bytes_moved, int_ops):
    """The least time for the work: bytes (each input read once, each
    output written once) over the memory rate, or integer operations
    (estimated per element from the kernel source) over the INT32 rate,
    whichever is longer."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = int_ops / H100_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_runs(rng, n, avg_run, within=None):
    """Start/end masks of a random partition of [0, n) into runs; with
    ``within``, every boundary of that partition is kept too."""
    import numpy as np

    start = rng.random(n) < 1.0 / avg_run
    start[0] = True
    if within is not None:
        start |= within
    end = np.empty(n, bool)
    end[:-1] = start[1:]
    end[-1] = True
    return start, end


def device_record(fn, host_fn=None):
    """A kernel's device time and device operations (kernels and
    memsets) per call of ``fn``, from torch.profiler, and its wrapper's
    host time per call of ``host_fn`` (by default ``fn``) with no sync."""
    from epidemicsimulator_tpu_torch import runtime

    rows = runtime.device_ms(fn)
    return dict(device_ms=sum(ms for ms, _ in rows.values()),
                device_ops=sum(c for _, c in rows.values()),
                host_us=runtime.host_us(host_fn or fn))


def hold_citizen_phase(statics, status, timer, sched, kw):
    """B1 against its plain version on one input, both with q: q within
    2 ulp (CUDA's expf bound), a home hit differing only where q differs
    by exactly 1 ulp, the lanes and census equal elsewhere, and the same
    lanes without q.  Returns (worst q ulp, max abs q error, flipped home
    hits, whether the plain q has a NaN)."""
    import torch

    from epidemicsimulator_tpu_torch.ops import citizen

    kw = dict(kw, want_q=True)
    got = citizen.citizen_phase(statics, status, timer, sched, **kw)
    want = citizen.citizen_phase_plain(statics, status, timer, sched, **kw)
    q_got, q_want = got[5], want[5]
    same_q = (q_got == q_want) | (torch.isnan(q_got) & torch.isnan(q_want))
    ulp = torch.where(same_q, 0, (q_got.view(torch.int32).long()
                                  - q_want.view(torch.int32).long()).abs())
    worst_ulp = int(ulp.max())
    max_err = float(torch.where(same_q, 0.0, (q_got - q_want).abs()).max())
    flip = ((got[3] & 4) != 0) != ((want[3] & 4) != 0)
    if worst_ulp > 2 or bool((flip & (ulp != 1)).any()):
        raise AssertionError(
            f"citizen_phase: q differs by {worst_ulp} ulp, or a home hit "
            f"differs where q does not differ by exactly 1 ulp")
    keep = ~flip
    for a, b, name in zip(got[:4], want[:4],
                          ("status", "timer", "sched", "gates")):
        if not torch.equal(a[keep], b[keep]):
            raise AssertionError(f"citizen_phase: {name} disagrees")
    n_flip = int(flip.sum())
    if not torch.equal(got[4][:7], want[4][:7]) or (
            int((got[4][7] - want[4][7]).abs()) > n_flip):
        raise AssertionError("citizen_phase: census disagrees")
    nan_q = bool(torch.isnan(q_want).any())
    del want, q_want, same_q, ulp, flip, keep
    kw.update(want_q=False)
    without_q = citizen.citizen_phase(statics, status, timer, sched, **kw)
    if len(without_q) != 5 or not all(
            torch.equal(a, b) for a, b in zip(without_q, got[:5])):
        raise AssertionError("citizen_phase differs without q")
    return worst_ulp, max_err, n_flip, nan_q


def check_kernels(world_dev, rng):
    """Phase 2: each kernel against its plain version at the main path's
    shapes.  Returns the per-kernel records (launches filled in later)."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import citizen, scans

    n = world_dev.n_citizens
    dev = world_dev.work_perm.device
    records = []

    # B3: the int8 cumsum, on a 0/1 lane
    v = torch.from_numpy((rng.random(n) < 0.3).astype(np.int8)).to(dev)
    got, want = scans.cumsum_i8(v), scans.cumsum_i8_plain(v)
    if not torch.equal(got, want):
        raise AssertionError("cumsum_i8 disagrees with its plain version")
    t_b, by = bound(n * (1 + 4), 2 * n)
    records.append(dict(
        name="cumsum_i8", route="cuda",
        source="epidemicsimulator_tpu_torch/csrc/scans.cu",
        replaces="epidemicsimulator_tpu/ops/pallas_scans.py:316",
        max_abs_err=0.0,
        ms=runtime.cuda_ms(lambda: scans.cumsum_i8(v)),
        plain_ms=runtime.cuda_ms(lambda: scans.cumsum_i8_plain(v)),
        bound_ms=t_b, bound_by=by,
        library_ms=runtime.cuda_ms(lambda: torch.cumsum(v, 0, dtype=torch.int32)),
    ))
    say("B3 cumsum_i8: bitwise equal to its plain version")

    # B2: building and room run totals over the contributor lane, on the
    # world's own work-order boundary masks and on random nested runs
    sets_world = [
        (world_dev.ws_wb_start_mask, world_dev.ws_wb_end_mask),
        (world_dev.ws_room_start_mask, world_dev.ws_room_end_mask),
    ]
    coarse = random_runs(rng, n, 60)
    fine = random_runs(rng, n, 9, within=coarse[0])
    longer = random_runs(rng, n, 20_000)
    whole = np.zeros(n, bool), np.zeros(n, bool)
    whole[0][0] = whole[1][-1] = True
    each = np.ones(n, bool), np.ones(n, bool)
    to_dev = lambda pairs: [tuple(torch.from_numpy(m).to(dev) for m in pair)
                            for pair in pairs]
    sets_rand = to_dev([coarse, fine])
    # the same lanes one byte off 16-byte alignment
    shift = lambda x: torch.cat([x[:1], x])[1:]
    cases = [sets_world, sets_rand, sets_rand[1:], to_dev([whole, each]),
             to_dev([longer]), to_dev([longer, fine])]
    for sets in cases:
        got = scans.run_totals_fused(v, sets)
        want = scans.run_totals_fused_plain(v, sets)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("run_totals_fused disagrees with its plain version")
    got = scans.run_totals_fused(
        shift(v), [tuple(shift(m) for m in pair) for pair in sets_world])
    if not all(torch.equal(a, b) for a, b in
               zip(got, scans.run_totals_fused_plain(v, sets_world))):
        raise AssertionError("run_totals_fused disagrees on unaligned lanes")
    t_b, by = bound(n * (1 + 2 * 2 + 4 * 2), 2 * 10 * n)
    records.append(dict(
        name="run_totals_fused", route="cuda",
        source="epidemicsimulator_tpu_torch/csrc/scans.cu",
        replaces="epidemicsimulator_tpu/ops/pallas_scans.py:339",
        max_abs_err=0.0,
        ms=runtime.cuda_ms(lambda: scans.run_totals_fused(v, sets_world)),
        plain_ms=runtime.cuda_ms(lambda: scans.run_totals_fused_plain(v, sets_world)),
        bound_ms=t_b, bound_by=by, library_ms=None,
        **device_record(lambda: scans.run_totals_fused(v, sets_world)),
    ))
    say("B2 run_totals_fused: bitwise equal to its plain version (world "
        "masks, random nested runs, one set, one run over the lane, every "
        "element its own run, runs of ~20,000, lanes one byte off "
        f"alignment); {records[-1]['device_ms']:.4f} ms of device time in "
        f"{records[-1]['device_ops']:g} device operations per call")

    # B1: the citizen phase on the world's statics and a random state
    statics = citizen.make_citizen_statics(world_dev)
    status = torch.from_numpy(rng.choice(
        5, n, p=[0.80, 0.05, 0.05, 0.05, 0.05]).astype(np.int8)).to(dev)
    timer = torch.from_numpy(rng.integers(0, 400, n).astype(np.int32)).to(dev)
    sched = torch.from_numpy(rng.integers(0, 32, n).astype(np.int8)).to(dev)
    f32 = np.float32
    worst_ulp, hit_flips, max_err = 0, 0, 0.0
    # the four combinations of the two reference flags; p0 = 1 gives a q
    # of NaN where no housemate is infected
    for h24, move, mask_status, p0, ref_mask_sem, u8_trunc in (
        (8, True, 2, 0.00055, True, True), (12, True, 0, 0.05, False, True),
        (17, False, 1, 0.3, True, False), (9, True, 2, 1.0, False, False),
    ):
        kw = dict(h24=h24, move=move, mask_status=mask_status,
                  seed=int(rng.integers(0, 2**32)), exposed_time=96,
                  infected_time=336, exposure_chance=f32(p0),
                  mask_scale=f32(1.0) - f32(0.7),
                  K=world_dev.max_household_size, ref_mask_sem=ref_mask_sem,
                  u8_trunc=u8_trunc)
        ulp, err, flips, nan_q = hold_citizen_phase(statics, status, timer,
                                                    sched, kw)
        worst_ulp, max_err = max(worst_ulp, ulp), max(max_err, err)
        hit_flips += flips
        if p0 == 1.0 and not nan_q:
            raise AssertionError("the p0 = 1 case has no NaN q to check")
    say(f"B1 citizen_phase: lanes and census equal to its plain version "
        f"under all four combinations of the reference flags, with and "
        f"without q; q differs by at most {worst_ulp} ulp (max abs "
        f"{max_err:.3e}; NaN where the plain q is NaN); home hits that "
        f"differ by a 1-ulp q: {hit_flips}")
    kw.update(h24=8, move=True, mask_status=2, exposure_chance=f32(0.00055),
              ref_mask_sem=True, u8_trunc=True)
    t_b, by = bound(n * (1 + 4 + 1 + 5 + 1 + 4 + 1 + 1), 150 * n)
    records.append(dict(
        name="citizen_phase", route="cuda",
        source="epidemicsimulator_tpu_torch/csrc/citizen.cu",
        replaces="epidemicsimulator_tpu/ops/pallas_citizen.py:367",
        max_abs_err=max_err,
        ms=runtime.cuda_ms(lambda: citizen.citizen_phase(statics, status, timer,
                                                 sched, **kw)),
        plain_ms=runtime.cuda_ms(lambda: citizen.citizen_phase_plain(
            statics, status, timer, sched, **kw)),
        bound_ms=t_b, bound_by=by, library_ms=None,
        **device_record(lambda: citizen.citizen_phase(statics, status, timer,
                                                      sched, **kw)),
    ))
    say(f"B1 citizen_phase: {records[-1]['device_ms']:.4f} ms of device time "
        f"in {records[-1]['device_ops']:g} device operations per call")
    return records


def load_tool(name):
    """A module of tools/ by file path (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_cumsum_path(rng, card):
    """Phase 4: B4 against its plain version, then the cumsum path."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import scans

    probe = load_tool("probe_torch_cumsum")
    dev = torch.device("cuda")
    lanes = {
        "0/1, p = 0.3": torch.from_numpy(
            (rng.random(N_CITIZENS) < 0.3).astype(np.int8)).to(dev),
        "signed int8": torch.from_numpy(
            rng.integers(-128, 128, N_CITIZENS).astype(np.int8)).to(dev),
        "the probe's 63M lane": probe.lane(),
    }
    for name, v in lanes.items():
        if not torch.equal(scans.cumsum_i8_2phase(v),
                           scans.cumsum_i8_2phase_plain(v)):
            raise AssertionError(
                f"cumsum_i8_2phase disagrees with its plain version ({name})")
    say("B4 cumsum_i8_2phase: bitwise equal to its plain version at "
        f"N = {N_CITIZENS:,} (0/1 and signed lanes) and N = {probe.N_UK:,}")
    v = lanes["the probe's 63M lane"]
    res = probe.path(v)
    say(f"cumsum path, N = {probe.N_UK:,}: B4 {res['cumsum_i8_2phase']:.4f} "
        f"ms, B3 {res['cumsum_i8']:.4f} ms, torch.cumsum "
        f"{res['torch.cumsum']:.4f} ms; B3 and B4 equal to torch.cumsum; "
        f"launches {res['launches']}")
    for name, lane in (("N = 3,457,142", lanes["0/1, p = 0.3"]),
                       (f"N = {probe.N_UK:,}", v)):
        t, dev_rows = probe.turns(lane)
        say(f"cumsum in turns on {card}, {name}, ms per round: " + "; ".join(
            f"{fn} {' '.join(f'{ms:.4f}' for ms in ms_list)}"
            for fn, ms_list in t.items()) + "; device ms per call: "
            + "; ".join(f"{fn} {probe.device_sum(rows)[0]:.4f}"
                        for fn, rows in dev_rows.items()))
    t_b, by = bound(probe.N_UK * (1 + 4), 2 * probe.N_UK)
    rec = dict(
        name="cumsum_i8_2phase", route="cuda",
        source="epidemicsimulator_tpu_torch/csrc/scans.cu",
        replaces="epidemicsimulator_tpu/ops/pallas_scans.py:245",
        path="cumsum", launches=res["launches"]["cumsum_i8_2phase"],
        max_abs_err=0.0, ms=res["cumsum_i8_2phase"],
        plain_ms=runtime.cuda_ms(lambda: scans.cumsum_i8_2phase_plain(v)),
        bound_ms=t_b, bound_by=by, library_ms=res["torch.cumsum"],
        **device_record(
            lambda: scans.cumsum_i8_2phase(v),
            lambda: scans.cumsum_i8_2phase(lanes["0/1, p = 0.3"])),
    )
    say(f"B4 cumsum_i8_2phase at N = {probe.N_UK:,}: {rec['device_ms']:.4f} "
        f"ms of device time in {rec['device_ops']:g} device operations per "
        f"call; its wrapper {rec['host_us']:.2f} us of host time per call "
        f"at N = {N_CITIZENS:,}")
    return rec


def check_benes_path(world, world_dev, rng, card):
    """Phase 5: the Beneš path on the world's work_perm, then B5 against
    its plain replay on random control bytes."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch.ops import benes

    probe = load_tool("probe_torch_benes")
    dev = world_dev.work_perm.device
    n = world_dev.n_citizens
    x = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(dev)
    res, ctrl, k = probe.replay("work_perm", np.asarray(world.work_perm),
                                np.asarray(world.wpos), x)
    say(f"Beneš path: routed work_perm on the host in {res['route_s']:.3f}s "
        f"(k = {k}, ctrl {res['ctrl_mb']:.3f} MB); forward == x[work_perm], "
        f"reverse == x[wpos], both == the plain replay, bitwise; "
        f"{res['forward']['ms']:.4f} / {res['reverse']['ms']:.4f} ms on {card}; "
        f"launches {res['launches']}")
    noise = torch.from_numpy(
        rng.integers(0, 256, tuple(ctrl.shape)).astype(np.uint8)).to(dev)
    for reverse in (False, True):
        if not torch.equal(benes.benes_permute(x, noise, k, reverse=reverse),
                           benes.benes_permute_plain(x, noise, k, reverse=reverse)):
            raise AssertionError(
                f"benes_permute(reverse={reverse}) != its plain replay on "
                "random control bytes")
    say("B5 benes_permute: bitwise equal to its plain replay on random "
        "control bytes, forward and reverse")
    # bytes: the payload, the control table, the output; operations: one
    # select per element and stage
    t_b, by = bound(n + ctrl.numel() + n, (2 * k - 1) * (1 << k))
    fwd = res["forward"]
    return dict(
        name="benes_permute", route="cuda",
        source="epidemicsimulator_tpu_torch/csrc/benes.cu",
        replaces="attic/benes.py:164",
        path="benes", launches=res["launches"], max_abs_err=0.0,
        ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=t_b, bound_by=by,
        library_ms=fwd["gather_ms"],
    )


def main_path(et, world_dev, card):
    """Phase 3: two chunks of the bench's run, counting launches."""
    import torch

    from epidemicsimulator_tpu_torch import runtime

    state = et.init_state(world_dev, seed=0, starting_infected=20_000)
    cfg = et.SimConfig(max_steps=2 * CHUNK, chunk_size=CHUNK)
    params = et.Params.covid()
    chunk = et.make_chunk_runner(world_dev, cfg)
    n = world_dev.n_citizens
    torch.cuda.synchronize()
    et.reset_launches()
    for c in range(2):
        t = time.perf_counter()
        state, out = chunk(params, state)
        seirv = out.seirv.cpu()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if not bool((seirv.sum(1) == n).all()):
            raise AssertionError("a SEIRV row does not sum to N")
        oa = out.exposures_per_oa
        if oa.shape != (CHUNK, world_dev.n_output_areas) or int(oa.min()) < 0:
            raise AssertionError("per-OA series has the wrong shape or sign")
        say(f"chunk {c + 1}: SEIRV after step {state.hour} = "
            f"{seirv[-1].tolist()}; {dt * 1e3 / CHUNK:.3f} ms/step; "
            f"lockdown={state.lockdown} mask={state.mask_status} "
            f"vaccinated this chunk={int(out.n_vaccinated_now.sum())}")
        if c == 0 and not all(int(x) > 0 for x in seirv[-1][[0, 1, 2, 4]]):
            raise AssertionError("S, E, I and V must all be live after chunk 1")
    counts = dict(et.launches)
    say(f"second chunk {dt * 1e3 / CHUNK:.3f} ms/step on {card}; "
        f"launches in the main path: {counts}")
    if not all(counts[name] for name in runtime.MAIN_PATH_KERNELS):
        raise AssertionError("a kernel of the main path was never launched")
    if any(v for name, v in counts.items()
           if name not in runtime.MAIN_PATH_KERNELS):
        raise AssertionError("a kernel off the main path ran in the main path")
    return counts


def small_reference(et):
    """Phase 6: the card against the plain path on the CPU, deterministic
    regime (every draw probability 0, 1 or NaN), 3000 citizens, 60 steps."""
    import numpy as np
    import torch

    base = et.Params.covid()
    params = et.Params(
        dataclasses.replace(base.disease, exposure_chance=1.0, exposed_time=6,
                            infected_time=12, vaccination_rate=25),
        dataclasses.replace(base.thresholds, lockdown=0.35, vaccination=0.05,
                            mask_public_transport=2.0, mask_everywhere=2.0),
    )
    cfg = et.SimConfig(max_steps=60, chunk_size=60)
    runs = {}
    for device in ("cuda", "cpu"):
        world = et.generate_synthetic_world(3000, n_output_areas=6, seed=4).to(device)
        state = et.init_state(world, seed=0, starting_infected=10, device=device)
        state, out = et.make_chunk_runner(world, cfg)(params, state)
        runs[device] = (state.status.cpu(), out.seirv.cpu(),
                        out.exposures_per_oa.cpu())
    for a, b in zip(*runs.values()):
        if not torch.equal(a, b):
            raise AssertionError("card and CPU disagree on the small world")
    final = runs["cpu"][1][-1].tolist()
    if final[3] == 0 or not np.isfinite(runs["cpu"][1].numpy()).all():
        raise AssertionError("the small epidemic did not run")
    say(f"small world, 60 steps: card == CPU plain path bitwise; "
        f"final SEIRV {final}")


def check_artifacts(out, n):
    """The four artifacts of a CLI run that ended its epidemic: one entry
    per step, the trailing zero row, every row summing to ``n``.  Returns
    (SEIRV rows, timings, cli_phases, the vaccination trigger hour)."""
    import numpy as np

    def read(name):
        with open(os.path.join(out, name)) as f:
            return json.load(f)

    stats, exposures, timings, memory, phases = (read(name) for name in (
        "global_stats.json", "exposures.json", "timings.json", "memory.json",
        "cli_phases.json"))
    steps = len(stats) - 1
    seirv = np.array([[row[k] for k in SEIRV_KEYS] for row in stats[:-1]])
    if any(stats[-1][k] for k in SEIRV_KEYS) or stats[-1]["time_step"] != steps + 1:
        raise AssertionError("global_stats.json lacks its trailing zero row")
    if not (seirv.sum(1) == n).all():
        raise AssertionError("a global_stats.json row does not sum to N")
    if not (2 * CHUNK < steps < 5000) or seirv[-1, :3].sum() != 0:
        raise AssertionError(f"the epidemic did not end inside the run "
                             f"({steps} steps, last row {seirv[-1]})")
    if not (len(exposures["All"]["All"]) == steps
            and all(len(v) == steps for v in exposures["OutputArea"].values())
            and len(timings) == steps and len(memory) == steps):
        raise AssertionError("an artifact does not have one entry per step")
    vax = np.flatnonzero(seirv[:, 4] > 0)
    trigger = int(vax[0]) + 1 if len(vax) else None
    return seirv, timings, phases, trigger


def say_chunks(timings, steps, trigger):
    per_chunk = [timings[i]["Step"] * 1e3 for i in range(0, steps, CHUNK)]
    regime = lambda i: ("before" if trigger is None or (i + 1) * CHUNK < trigger
                        else "after" if i * CHUNK + 1 >= trigger else "across")
    say(f"  ms/step by chunk of {CHUNK} (vaccination starts at hour "
        f"{trigger}): " + "; ".join(
            f"{i * CHUNK + 1}-{min((i + 1) * CHUNK, steps)} {ms:.3f} "
            f"({regime(i)}{', with set-up' if i == 0 else ''})"
            for i, ms in enumerate(per_chunk)))


def check_launches(counts, run):
    """Every main-path kernel launched in ``run``, and nothing else."""
    from epidemicsimulator_tpu_torch import runtime

    # B1 launches once per step run (the last chunk runs to its end)
    say(f"  launches in {run}: {counts}; B2 "
        f"{counts['run_totals_fused'] * 500 / counts['citizen_phase']:.1f} "
        f"per 500 steps run")
    if not all(counts[name] for name in runtime.MAIN_PATH_KERNELS):
        raise AssertionError(f"a kernel of the main path was never launched "
                             f"in {run}")
    if any(v for name, v in counts.items()
           if name not in runtime.MAIN_PATH_KERNELS):
        raise AssertionError(f"a kernel off the main path ran in {run}")


def simulator_path(et, card, tmp):
    """Phase 7: the York world through the port's CLI to the end of its
    epidemic, then checkpoint and resume against that run.  The world
    cache, the parameters' file and the artifacts stay in ``tmp`` for
    phase 10.  Returns the launch counts of the CLI run."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch import cli

    t_phase = time.perf_counter()
    params = et.Params.covid_v16()
    params_file = os.path.join(tmp, "covid_v16.json")
    params.to_json(params_file)
    out = os.path.join(tmp, "york")
    torch.cuda.synchronize()
    et.reset_launches()
    rc = cli.main([
        "york", "--census-like", "--synthetic", str(YORK_N), "--simulate",
        "--params-file", params_file, "--seed", "0", "--max-steps", "5000",
        "--chunk-size", str(CHUNK), "--directory", tmp, "--output-name", out])
    counts = dict(et.launches)
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    seirv, timings, phases, trigger = check_artifacts(out, YORK_N)
    steps = len(seirv)
    inf = seirv[:, 2]
    york = dict(peak=int(inf.max()), peak_h=int(inf.argmax()),
                attack=int(seirv[-1, 1:4].sum()), max_V=int(seirv[:, 4].max()),
                end_h=steps)
    say(f"York CLI run on {card}: {steps} steps, SEIRV at the end "
        f"{seirv[-1].tolist()}; cli_phases {phases}")
    jax_path = os.path.join(ROOT, "sample_results", "york_v16", "summary.json")
    jax = {}
    if os.path.exists(jax_path):
        with open(jax_path) as f:
            jax = json.load(f)
    for key, rng_key in (("peak", "peak_range"), ("peak_h", "peak_h_range"),
                         ("attack", "attack_range"), ("max_V", "max_V_range"),
                         ("end_h", "end_h_range")):
        say(f"  {key} {york[key]}; the JAX package's 32 seeds "
            f"{jax.get(rng_key, 'not in this checkout')}")
    say_chunks(timings, steps, trigger)
    check_launches(counts, "the York run")

    world = et.World.load_npz(os.path.join(tmp, "world_york_censuslike.npz"))
    ckpt = os.path.join(tmp, "ckpt.npz")
    cfg = et.SimConfig(max_steps=CHUNK, chunk_size=CHUNK)
    sim = lambda: et.Simulator(world, params, cfg, seed=0, verbose=False,
                               checkpoint_path=ckpt, checkpoint_every_chunks=1)
    first = sim().simulate()
    resumed = sim()
    if resumed.state.hour != CHUNK:
        raise AssertionError(f"resumed at hour {resumed.state.hour}")
    second = resumed.simulate()
    if not (np.array_equal(first, seirv[:CHUNK])
            and np.array_equal(second, seirv[CHUNK:2 * CHUNK])):
        raise AssertionError("checkpoint and resume differ from the CLI run")
    say(f"checkpoint after step {CHUNK} and resume: SEIRV rows 1-{CHUNK} and "
        f"{CHUNK + 1}-{2 * CHUNK} equal the CLI run's, bitwise")
    say(f"phase 7 took {time.perf_counter() - t_phase:.2f}s")
    return counts


def pipeline_path(et, card):
    """Phase 8: the York fixture's census CSVs, PBF and shapefile through
    the port's CLI on the card to the end of the epidemic.  Returns the
    launch counts of the CLI run."""
    tool = load_tool("run_torch_york_pipeline")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fixture, out = os.path.join(tmp, "fixture"), os.path.join(tmp, "out")
        # run() sets the launch counts to 0 just before the CLI's run and
        # reads them just after it
        summary = tool.run(fixture, out, oas=637, pop=310, steps=5000, seed=1,
                           chunk_size=CHUNK)
        counts = summary["launches"]
        n = summary["n_citizens"]
        seirv, timings, _, trigger = check_artifacts(
            os.path.join(fixture, "sim_out"), n)
        world = et.World.load_npz(os.path.join(fixture, "world_york_pipeline.npz"))
        if world.n_citizens != n:
            raise AssertionError("the cached world and the run disagree on N")
        say(f"York pipeline CLI run on {card}: N = {n:,}, "
            f"{world.n_output_areas} OAs after filtering (of "
            f"{summary['n_output_areas']}); {len(seirv)} steps, SEIRV at the "
            f"end {seirv[-1].tolist()}")
        say(f"  builder phases (s): {summary['builder_phase_s']}")
        say(f"  cli_phases {summary['cli_phases']}; fixture "
            f"{summary['fixture_gen_s']} s, kernel build "
            f"{summary['kernel_build_s']} s, first launch "
            f"{summary['first_launch_s']} s")
        say_chunks(timings, len(seirv), trigger)
        check_launches(counts, "the York pipeline run")
        scale = n / YORK_N
        for key, gate in (summary["envelope_gate"] or {}).items():
            lo, hi = gate["envelope"]
            s = 1 if key in ("peak_h", "end_h") else scale
            say(f"  {key} {gate['value']}; the JAX package's 32 seeds "
                f"{lo}-{hi}, x {s:.5f} = {lo * s:.0f}-{hi * s:.0f}: "
                f"{'inside' if gate['inside'] else 'outside'}")
        if summary["envelope_gate"] is None:
            say("  the JAX package's 32-seed ranges are not in this checkout")
    say(f"phase 8 took {time.perf_counter() - t_phase:.2f}s")
    return counts


def ensemble_path(et, card):
    """Phase 9: B1's ensemble mode at full width, a small packed run
    against the CPU, then 1,000 steps of 64 York-scale replicas.  Returns
    the ensemble mode's record, the launch counts of the 1,000 steps and
    the sweep with its packing (for phase 12)."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import citizen

    tool = load_tool("run_torch_ensemble")
    t_phase = time.perf_counter()
    plist, pe, pack_s = tool.pack(et, 64)
    world = pe.world
    n, R = world.n_citizens, pe.n_replicas
    say(f"packed 64 x {pe.rep_size:,} citizens: {n:,} lanes, stride "
        f"{pe.rep_stride:,}, in {pack_s:.2f}s (on the card)")

    # (a) the ensemble mode on the packed lanes, a random state, the
    # sweep's rows with a lockdown and mask state that differ per replica
    rng = np.random.default_rng(9)
    dev = lambda x: torch.from_numpy(x).to("cuda")
    status = rng.choice(5, n, p=[0.80, 0.05, 0.05, 0.05, 0.05]).astype(np.int8)
    status[np.tile(np.arange(pe.rep_stride) >= pe.rep_size, R)] = 5
    status = dev(status)
    timer = dev(rng.integers(0, 400, n).astype(np.int32))
    sched = dev(rng.integers(0, 32, n).astype(np.int8))
    f32 = np.float32
    rep_ints = dev(np.stack([rng.random(R) < 0.8, np.arange(R) % 3,
                             pe.exposed_time, pe.infected_time], 1).astype(np.int32))
    rep_f32s = dev(np.stack([pe.chance, f32(1.0) - pe.mask_effectiveness], 1))
    statics = citizen.make_citizen_statics(world)
    kw = dict(h24=8, seed=int(rng.integers(0, 2**32)), K=world.max_household_size,
              ref_mask_sem=True, u8_trunc=True, rep_ints=rep_ints,
              rep_f32s=rep_f32s, tiles_per_rep=pe.rep_stride // citizen.CITIZEN_TILE)
    got = citizen.citizen_phase(statics, status, timer, sched, want_q=True, **kw)
    want = citizen.citizen_phase_plain(statics, status, timer, sched,
                                       want_q=True, **kw)
    if got[4].shape != (R, 8) or not all(
            torch.equal(a, b) for a, b in zip(got[:5], want[:5])):
        raise AssertionError("citizen_phase's ensemble mode disagrees with its "
                             "plain version")
    same_q = (got[5] == want[5]) | (got[5].isnan() & want[5].isnan())
    ulp = int(torch.where(same_q, 0, (got[5].view(torch.int32).long()
                                      - want[5].view(torch.int32).long()).abs()).max())
    max_err = float(torch.where(same_q, 0.0, (got[5] - want[5]).abs()).max())
    if ulp > 2:
        raise AssertionError(f"ensemble mode: q differs by {ulp} ulp")
    without_q = citizen.citizen_phase(statics, status, timer, sched, **kw)
    if not all(torch.equal(a, b) for a, b in zip(without_q, got[:5])):
        raise AssertionError("ensemble mode differs without q")
    say(f"B1 ensemble mode on {n:,} lanes: status, timer, sched, gates and "
        f"the (64, 8) census bitwise equal to its plain version; q within "
        f"{ulp} ulp (max abs {max_err:.3e}); home hits {int(got[4][:, 7].sum())}")
    t_b, by = bound(n * (1 + 4 + 1 + 5 + 1 + 4 + 1 + 1), 150 * n)
    rec = dict(
        name="citizen_phase_ensemble", route="cuda",
        source="epidemicsimulator_tpu_torch/csrc/citizen.cu",
        replaces="epidemicsimulator_tpu/ops/pallas_citizen.py:367",
        path="ensemble", max_abs_err=max_err,
        ms=runtime.cuda_ms(lambda: citizen.citizen_phase(
            statics, status, timer, sched, **kw)),
        plain_ms=runtime.cuda_ms(lambda: citizen.citizen_phase_plain(
            statics, status, timer, sched, **kw), reps=5),
        bound_ms=t_b, bound_by=by, library_ms=None,
        **device_record(lambda: citizen.citizen_phase(
            statics, status, timer, sched, **kw)),
    )
    say(f"B1 ensemble mode on {card}: {rec['ms']:.4f} ms per call, "
        f"{rec['device_ms']:.4f} ms of device time in {rec['device_ops']:g} "
        f"device operations, bound {t_b:.4f} ms ({by}); plain version "
        f"{rec['plain_ms']:.3f} ms")
    del got, want, without_q, status, timer, sched, statics

    # (b) a small packed run against the CPU
    for regime in tool.SMALL_REGIMES:
        on_card, on_cpu, _ = tool.small_card_vs_cpu(et, regime)
        if not all(torch.equal(a, b) for a, b in zip(on_card, on_cpu)):
            raise AssertionError(f"packed run, {regime}: card and CPU disagree")
        say(f"packed run of 3 replicas x 3,000, {regime}, 60 steps: card == "
            f"CPU plain path bitwise; final SEIRV {on_cpu[0][-1].tolist()}")

    # (c) 1,000 steps of the 64 replicas
    res = tool.run(et, plist, pe, steps=1000, chunk=CHUNK)
    seirv, counts = res["seirv"], res["launches"]
    peaks = seirv[:, :, 2].max(axis=1)
    say(f"64 replicas x {seirv.shape[1]} steps on {card}: every row sums to "
        f"{pe.rep_size:,} at every step; ms/step by chunk of {CHUNK}: "
        + " ".join(f"{ms:.3f}" for ms in res["chunk_ms"])
        + f"; peaks above 100 after {seirv.shape[1]} steps: "
        f"{int((peaks > 100).sum())}, peak quartiles "
        f"{np.percentile(peaks, [25, 50, 75]).tolist()}")
    say(f"  launches in the ensemble run: {counts}; B1 (ensemble mode) "
        f"{counts['citizen_phase_ensemble']}, B2 {counts['run_totals_fused']}")
    if not all(counts[name] for name in runtime.ENSEMBLE_PATH_KERNELS):
        raise AssertionError("a kernel of the ensemble path was never launched")
    if any(v for name, v in counts.items()
           if name not in runtime.ENSEMBLE_PATH_KERNELS):
        raise AssertionError("a kernel off the ensemble path ran in it")
    rec["launches"] = counts["citizen_phase_ensemble"]
    say(f"phase 9 took {time.perf_counter() - t_phase:.2f}s")
    return rec, counts, (plist, pe)


def calibrate_path(et, card, tmp):
    """Phase 10: the CLI's --calibrate on the card against phase 7's run.
    Returns the launch counts of the calibration."""
    import torch

    from epidemicsimulator_tpu_torch import cli, runtime

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "calibration.json")
    torch.cuda.synchronize()
    et.reset_launches()
    rc = cli.main([
        "york", "--census-like", "--synthetic", str(YORK_N), "--use-cache",
        "--directory", tmp, "--calibrate",
        os.path.join(tmp, "york", "global_stats.json"),
        "--params-file", os.path.join(tmp, "covid_v16.json"),
        "--calibrate-range", "1e-3,1e-2", "--calibrate-replicates", "8",
        "--calibrate-rounds", "1", "--max-steps", "1750",
        "--chunk-size", str(CHUNK), "--seed", "0", "--output-name", out])
    counts = dict(et.launches)
    if rc != 0:
        raise AssertionError(f"the CLI's --calibrate returned {rc}")
    with open(out) as f:
        result = json.load(f)
    rnd = result["rounds"][0]
    say(f"calibration on {card} against phase 7's global_stats.json "
        f"(exposure chance 0.003): fitted {result['param']} = "
        f"{result['value']:.6g}, score {result['score']}")
    say("  candidates and scores: " + "; ".join(
        f"{c:.4g} {sc:.4f}" for c, sc in zip(rnd["candidates"], rnd["scores"])))
    say(f"  launches in the calibration: {counts}")
    if not all(counts[name] for name in runtime.ENSEMBLE_PATH_KERNELS):
        raise AssertionError("the calibration did not run the ensemble kernels")
    if not 0.0015 <= result["value"] <= 0.006:
        raise AssertionError(f"the fitted exposure chance {result['value']} "
                             "is not within a factor of two of 0.003")
    say(f"phase 10 took {time.perf_counter() - t_phase:.2f}s")
    return counts


def hold_step_kernels(et, world, state, params, cfg, rng):
    """B1, B2 and B3 against their plain versions at a stepped world's
    full width, on the card: B1 on the world's statics and the live state
    with the next hour's arguments, once with movement and once without;
    B2 on the world's work-order masks over the live infected lane in
    work order and over a random 0/1 lane; B3 on the live eligible
    lane, the one the fixed-priority pool's draw scans.  The launches
    made here are taken back off the counts."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch.config import STATUS_INFECTED
    from epidemicsimulator_tpu_torch.ops import citizen, scans

    before = dict(et.launches)
    d, f32 = params.disease, np.float32
    statics = citizen.make_citizen_statics(world)
    kw = dict(h24=(state.hour + 1) % 24, mask_status=state.mask_status,
              seed=int(rng.integers(0, 2**32)),
              exposed_time=int(d.exposed_time),
              infected_time=int(d.infected_time),
              exposure_chance=f32(d.exposure_chance),
              mask_scale=f32(1.0) - f32(d.mask_effectiveness),
              K=world.max_household_size,
              ref_mask_sem=cfg.reference_mask_semantics,
              u8_trunc=cfg.reference_u8_truncation)
    worst_ulp, flips = 0, 0
    for move in (True, False):
        ulp, _, n_flip = hold_citizen_phase(
            statics, state.status, state.timer, state.sched,
            dict(kw, move=move))[:3]
        worst_ulp, flips = max(worst_ulp, ulp), flips + n_flip
    del statics
    live = (state.status[world.work_perm.long()] == STATUS_INFECTED).to(
        torch.int8)
    gen = torch.Generator(device=live.device).manual_seed(
        int(rng.integers(0, 2**31)))
    rand = (torch.rand(live.shape[0], generator=gen, device=live.device)
            < 0.3).to(torch.int8)
    sets = [(world.ws_wb_start_mask, world.ws_wb_end_mask),
            (world.ws_room_start_mask, world.ws_room_end_mask)]
    for name, v in (("the infected lane", live), ("a random 0/1 lane", rand)):
        got = scans.run_totals_fused(v, sets)
        want = scans.run_totals_fused_plain(v, sets)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"run_totals_fused disagrees with its plain "
                                 f"version at N = {world.n_citizens:,} ({name})")
    n_live = int(live.sum())
    del live, rand, got, want
    if not torch.equal(scans.cumsum_i8(state.eligible),
                       scans.cumsum_i8_plain(state.eligible)):
        raise AssertionError(f"cumsum_i8 disagrees with its plain version at "
                             f"N = {world.n_citizens:,} (the eligible lane)")
    et.launches.update(before)
    say(f"  after step {state.hour}, at N = {world.n_citizens:,}: B1 equal "
        f"to its plain version with and without movement (q within "
        f"{worst_ulp} ulp, home hits that differ by a 1-ulp q: {flips}); B2 "
        f"equal on the work-order masks over the infected lane "
        f"({n_live:,} ones) and a random 0/1 lane; B3 equal on the eligible "
        f"lane ({int(state.eligible.sum()):,} eligible)")


def full_uk_path(et, world_dev, card):
    """Phase 11: the device table build against phase 1's world, the
    63M world built and stepped on the card, and the 16M run against the
    CPU's rows.  Returns the launch counts of the 63M run."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.world.device_build import (
        build_tables_device,
    )

    tool = load_tool("run_torch_full_uk")
    t_phase = time.perf_counter()
    # (a) the tables of phase 1's world, rebuilt on the card
    core = et.World(n_buildings=world_dev.n_buildings,
                    n_rooms=world_dev.n_rooms,
                    n_output_areas=world_dev.n_output_areas,
                    **{name: getattr(world_dev, name)
                       for name in et.World.CORE_LANES})
    t = time.perf_counter()
    tabled = build_tables_device(core)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    names = tabled.lane_names()
    if tabled.max_household_size != world_dev.max_household_size or not all(
            torch.equal(getattr(tabled, name), getattr(world_dev, name))
            for name in names):
        raise AssertionError("build_tables_device disagrees with the host "
                             "build of phase 1's world")
    say(f"build_tables_device on {card}, N = {world_dev.n_citizens:,}: "
        f"{len(names)} lanes equal to the host build's, in {dt:.3f}s")
    del core, tabled

    # (b) the 63M world
    world, stages, world_s, build_gb = tool.build(et)
    world.validate()
    n = world.n_citizens
    say(f"full-UK world built on {card} in {world_s:.2f}s: N = {n:,}, "
        f"{world.n_output_areas:,} OAs, {world.n_buildings:,} buildings, "
        f"{world.n_rooms:,} rooms, {world.n_riders:,} riders, largest "
        f"household {world.max_household_size}; peak memory "
        f"{build_gb:.2f} GB; validate() passed")
    say("  seconds by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    if os.path.exists(tool.JAX_SUMMARY):
        with open(tool.JAX_SUMMARY) as f:
            say(f"  the JAX package's device build of this world had "
                f"{json.load(f)['n_buildings']:,} buildings")

    # (c) two chunks of 250 steps with the pool
    cfg = et.SimConfig(max_steps=2 * CHUNK, chunk_size=CHUNK)
    params = et.Params.covid()
    state = tool.start(et, world, cfg)
    if state.vax_pool.shape[0] != n:
        raise AssertionError("the fixed-priority pool is off at 63M")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    et.reset_launches()
    flags = []
    for c, (state, seirv, lockdown, dt) in enumerate(
            tool.chunks(et, world, cfg, state, params, 2)):
        flags += lockdown.tolist()
        say(f"  chunk {c + 1}: SEIRV after step {state.hour} = "
            f"{seirv[-1].tolist()}; {dt * 1e3 / CHUNK:.3f} ms/step; pool "
            f"size {int(state.vax_pool_size):,}; lockdown={state.lockdown} "
            f"mask={state.mask_status}")
        if c == 0:
            if not all(int(x) > 0 for x in seirv[-1][[0, 1, 2, 4]]):
                raise AssertionError("S, E, I and V must all be live after "
                                     "chunk 1")
            run_gb = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            hold_step_kernels(et, world, state, params, cfg,
                              np.random.default_rng(11))
            hold_gb = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
    counts = dict(et.launches)
    lifted = next((i + 1 for i in range(1, len(flags))
                   if flags[i - 1] and not flags[i]), None)
    say(f"  every row sums to {n:,}; the lockdown first lifts at hour "
        f"{lifted}; peak memory over the run "
        f"{max(run_gb, torch.cuda.max_memory_allocated() / 1e9):.2f} GB (over "
        f"the hold after chunk 1: {hold_gb:.2f} GB); launches {counts}")
    if not all(counts[name] for name in runtime.MAIN_PATH_KERNELS):
        raise AssertionError("a kernel of the main path was never launched "
                             "at 63M")
    if any(v for name, v in counts.items()
           if name not in runtime.MAIN_PATH_KERNELS):
        raise AssertionError("a kernel off the main path ran at 63M")
    del world, state
    torch.cuda.empty_cache()

    # (d) 16M, against the CPU's rows
    world, _, world_s, _ = tool.build(et, 16_000_000, 57_843)
    cfg = et.SimConfig(max_steps=48, chunk_size=24)
    state = tool.start(et, world, cfg)
    if state.vax_pool.shape[0] != world.n_citizens:
        raise AssertionError("the fixed-priority pool is off at 16M")
    rows = {}
    for c, (state, seirv, _, dt) in enumerate(
            tool.chunks(et, world, cfg, state, params, 2)):
        rows[24 * (c + 1)] = seirv[-1].tolist()
    say(f"16M world built in {world_s:.2f}s; SEIRV after steps 24 and 48: "
        f"{rows[24]}, {rows[48]}; the CPU's {UK16_ROWS[24]}, {UK16_ROWS[48]}")
    if rows != UK16_ROWS:
        raise AssertionError("the 16M run on the card differs from the CPU's")
    del world, state
    torch.cuda.empty_cache()
    say(f"phase 11 took {time.perf_counter() - t_phase:.2f}s")
    return counts


def hold_gid0(world_dev, pe, rng):
    """Phase 12 (a): B1's gid0 mode against its plain version, in the
    one-world mode on the Y&H lanes and in the ensemble mode on the 64
    packed replicas.  Returns its record (launches filled in later)."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import citizen

    n = world_dev.n_citizens
    dev = world_dev.work_perm.device
    statics = citizen.make_citizen_statics(world_dev)
    status = torch.from_numpy(rng.choice(
        5, n, p=[0.80, 0.05, 0.05, 0.05, 0.05]).astype(np.int8)).to(dev)
    timer = torch.from_numpy(rng.integers(0, 400, n).astype(np.int32)).to(dev)
    sched = torch.from_numpy(rng.integers(0, 32, n).astype(np.int8)).to(dev)
    f32 = np.float32
    gid0s = (0, 864_286, 2**31 - 7)
    kw = dict(h24=20, move=True, mask_status=1, exposed_time=96,
              infected_time=336, exposure_chance=f32(0.05),
              mask_scale=f32(1.0) - f32(0.7), K=world_dev.max_household_size,
              ref_mask_sem=False, u8_trunc=True)
    worst_ulp, max_err, hits = 0, 0.0, []
    for gid0 in gid0s:
        kw.update(seed=int(rng.integers(0, 2**32)), gid0=gid0)
        ulp, err, flips, _ = hold_citizen_phase(statics, status, timer,
                                                sched, kw)
        if flips:
            raise AssertionError(f"citizen_phase, gid0 = {gid0}: {flips} "
                                 "home hits differ from its plain version")
        worst_ulp, max_err = max(worst_ulp, ulp), max(max_err, err)
        hits.append(int(citizen.citizen_phase(statics, status, timer, sched,
                                              **kw)[4][7]))
    say(f"B1 gid0 mode, one world, N = {n:,}, gid0 = {gid0s}: lanes and "
        f"census bitwise equal to its plain version (q within {worst_ulp} "
        f"ulp); home hits {hits}")
    t_b, by = bound(n * (1 + 4 + 1 + 5 + 1 + 4 + 1 + 1), 150 * n)
    rec = dict(
        name="citizen_phase_gid0", route="cuda",
        source="epidemicsimulator_tpu_torch/csrc/citizen.cu",
        replaces="epidemicsimulator_tpu/ops/pallas_citizen.py:367",
        path="sharded", max_abs_err=max_err,
        ms=runtime.cuda_ms(lambda: citizen.citizen_phase(
            statics, status, timer, sched, **kw)),
        plain_ms=runtime.cuda_ms(lambda: citizen.citizen_phase_plain(
            statics, status, timer, sched, **kw)),
        bound_ms=t_b, bound_by=by, library_ms=None,
        **device_record(lambda: citizen.citizen_phase(statics, status, timer,
                                                      sched, **kw)),
    )
    del status, timer, sched, statics

    # the ensemble mode on the 64 packed replicas
    world = pe.world
    n, R = world.n_citizens, pe.n_replicas
    status = rng.choice(5, n, p=[0.80, 0.05, 0.05, 0.05, 0.05]).astype(np.int8)
    status[np.tile(np.arange(pe.rep_stride) >= pe.rep_size, R)] = 5
    status = torch.from_numpy(status).to(dev)
    timer = torch.from_numpy(rng.integers(0, 400, n).astype(np.int32)).to(dev)
    sched = torch.from_numpy(rng.integers(0, 32, n).astype(np.int8)).to(dev)
    rep_ints = torch.from_numpy(np.stack(
        [rng.random(R) < 0.8, np.arange(R) % 3, pe.exposed_time,
         pe.infected_time], 1).astype(np.int32)).to(dev)
    rep_f32s = torch.from_numpy(np.stack(
        [pe.chance, f32(1.0) - pe.mask_effectiveness], 1)).to(dev)
    statics = citizen.make_citizen_statics(world)
    for gid0 in gid0s:
        kw = dict(h24=20, seed=int(rng.integers(0, 2**32)), gid0=gid0,
                  K=world.max_household_size, ref_mask_sem=True,
                  u8_trunc=True, rep_ints=rep_ints, rep_f32s=rep_f32s,
                  tiles_per_rep=pe.rep_stride // citizen.CITIZEN_TILE)
        got = citizen.citizen_phase(statics, status, timer, sched, **kw)
        want = citizen.citizen_phase_plain(statics, status, timer, sched, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"citizen_phase's ensemble mode, gid0 = "
                                 f"{gid0}, disagrees with its plain version")
    say(f"B1 gid0 mode, ensemble of {R} on {n:,} lanes, gid0 = {gid0s}: "
        f"lanes and the ({R}, 8) census bitwise equal to its plain version")
    del got, want, status, timer, sched, statics
    return rec


def sharded_path(et, world, world_dev, ensemble, card):
    """Phase 12: the population-sharded engine on 4 ranks sharing the
    card.  Returns the gid0 record, the launch counts of the 500 steps
    with transport and those of the sharded ensemble."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.engine import packed
    from epidemicsimulator_tpu_torch.engine.ensemble import stack_params

    tool = load_tool("run_torch_sharded")
    t_phase = time.perf_counter()
    plist, pe = ensemble
    rec = hold_gid0(world_dev, pe, np.random.default_rng(12))
    torch.cuda.synchronize()

    # (b) the Y&H world on 4 ranks: transport-free against one card, then
    # with transport against YH4_ROWS
    n = world.n_citizens
    world_tf = tool.strip_transport(world)
    one = tool.single_card(et, world_tf, CHUNK, CHUNK)
    tf = tool.sharded(et, world_tf, 4, CHUNK, CHUNK)
    if not np.array_equal(tf["seirv"], one):
        raise AssertionError("4 ranks without transport differ from one card")
    say(f"Y&H without transport, {CHUNK} steps: 4 ranks ({tf['comm']}) equal "
        f"the one-card run row for row; SEIRV after step {CHUNK} "
        f"{one[-1].tolist()}; {tf['chunk_ms'][0]:.3f} ms/step (with the "
        f"ranks' start) on {card}, ranks sharing it")
    tr = tool.sharded(et, world, 4, 2 * CHUNK, CHUNK)
    counts = tr["launches"]
    rows = {CHUNK: tr["seirv"][CHUNK - 1].tolist(),
            2 * CHUNK: tr["seirv"][2 * CHUNK - 1].tolist()}
    say(f"Y&H with transport, 4 ranks ({tr['comm']}), S = "
        f"{tr['shard_size']:,}, {tr['n_slots']:,} work slots, {tr['n_ghost']} "
        f"ghosts per rank pair at most: SEIRV after steps {CHUNK} and "
        f"{2 * CHUNK} {rows[CHUNK]}, {rows[2 * CHUNK]}; the JAX package's CPU "
        f"{YH4_ROWS}; every row sums to {n:,}")
    say(f"  ms/step by chunk of {CHUNK} on {card}, 4 ranks sharing it (not "
        "a multi-card figure; the first with the ranks' start): "
        + " ".join(f"{ms:.3f}" for ms in tr["chunk_ms"])
        + f"; {tr['total_s']:.2f} s in all; launches summed over the ranks: "
        f"{counts}")
    if rows != YH4_ROWS:
        raise AssertionError("the 4-rank Y&H run differs from YH4_ROWS, "
                             "the JAX package's CPU rows")
    if not all(counts[name] for name in runtime.MAIN_PATH_KERNELS):
        raise AssertionError("a kernel of the main path was never launched "
                             "by the 4 ranks")
    if any(v for name, v in counts.items()
           if name not in runtime.MAIN_PATH_KERNELS):
        raise AssertionError("a kernel off the main path ran on the 4 ranks")
    if counts["citizen_phase"] != 4 * 2 * CHUNK:
        raise AssertionError("B1 did not run once per step on every rank")

    # (c) cell (e)'s 64 replicas over 4 ranks against one card
    cfg = et.SimConfig(max_steps=CHUNK, chunk_size=CHUNK, starting_infected=10,
                       id_keyed_ensemble_rng=True)
    state = packed.init_packed_state(pe, seed=0, starting_infected=10)
    _, seirv = packed.make_packed_runner(pe, cfg)(
        stack_params(plist).thresholds, state)
    one = np.transpose(seirv.cpu().numpy(), (1, 0, 2))
    ens_tool = load_tool("run_torch_ensemble")
    base = et.generate_synthetic_world(ens_tool.N_CITIZENS,
                                       n_output_areas=ens_tool.N_OAS, seed=0)
    got, ens_counts, ens_s = tool.ensemble(et, base, plist, 4, CHUNK, CHUNK)
    if not np.array_equal(got, one):
        raise AssertionError("64 replicas over 4 ranks differ from the "
                             "one-card packing")
    say(f"64 replicas over 4 ranks, {CHUNK} steps: bitwise the one-card "
        f"packing under id-keyed bus streams, in {ens_s:.2f}s (packing on "
        f"each rank included); launches summed over the ranks {ens_counts}")
    if not all(ens_counts[name] for name in runtime.ENSEMBLE_PATH_KERNELS):
        raise AssertionError("a kernel of the ensemble path was never "
                             "launched by the 4 ranks")
    rec["launches"] = counts["citizen_phase"]
    rec["counted"] = ("B1 over the 4 ranks of the Y&H run with transport, "
                      "gid0 = each rank's shard start (0 on rank 0)")
    say(f"phase 12 took {time.perf_counter() - t_phase:.2f}s")
    return rec, counts, ens_counts


def hold_b3_portable(world, state):
    """B3 against its plain version on the portable step's live lanes at
    full width, after a run: the household contributors (citizen order),
    the work contributors (work order) and, as a work hour's stand-in,
    every infected citizen off the bus in work order; the cumsums and the
    prefix branch's range totals, bitwise.  Returns the lanes' ones."""
    import torch

    from epidemicsimulator_tpu_torch.config import STATUS_INFECTED
    from epidemicsimulator_tpu_torch.ops import runsums, scans

    at_work = (state.sched & 1) != 0
    inf_active = (state.status == STATUS_INFECTED) & ((state.sched & 2) == 0)
    neq = world.work_building != world.home_building
    perm = world.work_perm.long()
    lanes = {
        "household contributors": (inf_active & (~at_work | ~neq),
                                   world.home_lo, world.home_hi),
        "work contributors": ((inf_active & at_work & neq)[perm],
                              world.wb_lo, world.wb_hi),
        "infected in work order": (inf_active[perm], world.room_lo,
                                   world.room_hi),
    }
    ones = {}
    for name, (v, lo, hi) in lanes.items():
        if not torch.equal(scans.cumsum_i8(v), scans.cumsum_i8_plain(v)):
            raise AssertionError(f"cumsum_i8 disagrees with its plain version "
                                 f"on the portable path ({name})")
        if not torch.equal(scans.range_totals(v, lo, hi),
                           runsums.range_totals(v, lo, hi)):
            raise AssertionError(f"B3's range totals disagree with the plain "
                                 f"ones on the portable path ({name})")
        ones[name] = int(v.sum())
    return ones


def check_rows(rows, want, what):
    if rows != want:
        raise AssertionError(f"{what}: SEIRV rows {rows} differ from the JAX "
                             f"package's CPU rows {want}")


def portable_path(et, world, world_dev, card):
    """Phase 13: the portable step, ``SimConfig(use_fast_path=False)``.
    (a) the Y&H world with its index tables on the card, 500 steps: the
    prefix branch (B3) and the rider branch; (b) ``__graft_entry__.py``'s
    "portable ok" gate and (c) the Y&H world with the lockdown off, each
    on 4 ranks sharing the card (``parallel/mesh.py::run_sharded``).
    Returns B3's launches in (a) and those of (b) and (c) summed over
    their ranks, with the counts set to 0 before each run."""
    import torch

    tool = load_tool("run_torch_portable")
    t_phase = time.perf_counter()

    # (a)
    res = tool.yh(et, world_dev, device="cuda")
    counts = res["launches"]
    rows = {int(k): v for k, v in res["rows"].items()}
    after_lift = sum(res["n_bus_exposures"][PORTABLE_YH_LIFT:])
    say(f"(a) Y&H, one card, portable step: SEIRV after steps 250 and 500 "
        f"{rows[250]}, {rows[500]}; the lockdown lifts at hour(s) "
        f"{res['lockdown_lifts_at_hour']} (the JAX run's: "
        f"{PORTABLE_YH_LIFT}), {after_lift:,} bus exposures after it; "
        f"ms/step by chunk of 250 on {card}: "
        + " ".join(f"{ms:.3f}" for ms in res["chunk_ms"])
        + f"; launches {counts}")
    check_rows(rows, PORTABLE_ROWS["yh"], "(a) the portable Y&H run")
    if res["lockdown_lifts_at_hour"] != [PORTABLE_YH_LIFT] or after_lift == 0:
        raise AssertionError("(a) the run has no bus hours after the lockdown "
                             "lifts at the JAX run's hour")
    if counts["cumsum_i8"] == 0 or any(
            v for name, v in counts.items() if name != "cumsum_i8"):
        raise AssertionError("(a) the portable path must launch B3 and no "
                             "other kernel")
    torch.cuda.synchronize()
    ones = hold_b3_portable(world_dev, res["final_state"])
    del res
    say(f"  B3 equal to its plain version on the live lanes after step 500 "
        f"(cumsums and range totals): {ones}")

    # (b)
    gr = tool.graft(et, device="cuda")
    say(f"(b) the graft gate on 4 ranks: SEIRV after step 4 "
        f"{gr['rows']['4']} (the pad in R), lockdown "
        f"{gr['lockdown_on_at_end']}, mask {gr['mask_status_at_end']}, "
        f"{gr['n_vaccinated']} vaccinated; {gr['total_s']:.2f} s with the "
        f"ranks' start; launches {gr['launches']}")
    check_rows({int(k): v for k, v in gr["rows"].items()},
               PORTABLE_ROWS["graft"], "(b) the graft gate")
    say(f"dryrun_multichip(4) portable ok (conservation, vaccination, "
        f"lockdown and masks)")

    # (c)
    bus = tool.yh_bus(et, world, device="cuda")
    rows = {int(k): v for k, v in bus["rows"].items()}
    say(f"(c) Y&H on 4 ranks, lockdown off: SEIRV after steps 24 and 48 "
        f"{rows[24]}, {rows[48]} (the two pads in R), "
        f"{sum(bus['n_bus_exposures']):,} bus exposures, "
        f"{bus['n_vaccinated']:,} vaccinated; ms/step by chunk of 24 on "
        f"{card}, 4 ranks sharing it (the first with the ranks' start): "
        + " ".join(f"{ms:.3f}" for ms in bus["chunk_ms"])
        + f"; launches {bus['launches']}")
    check_rows(rows, PORTABLE_ROWS["yh_bus"], "(c) the sharded bus run")
    if sum(bus["n_bus_exposures"]) == 0:
        raise AssertionError("(c) no bus exposures on 4 ranks")
    sharded = {k: gr["launches"][k] + bus["launches"][k]
               for k in bus["launches"]}
    if any(v for name, v in sharded.items() if name != "cumsum_i8"):
        raise AssertionError("(b, c) a kernel other than B3 ran")
    say(f"phase 13 took {time.perf_counter() - t_phase:.2f}s")
    return counts, sharded


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import epidemicsimulator_tpu_torch as et
    from epidemicsimulator_tpu_torch import runtime

    smi = runtime.card()
    say(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        host = pool.submit(runtime.build_host)
        path, log = runtime.build()
        host_path = host.result()[0]
    say(f"built {os.path.relpath(path, ROOT)} and "
        f"{os.path.relpath(host_path, ROOT)} in {time.perf_counter() - t:.2f}s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    t = time.perf_counter()
    world = et.generate_synthetic_world(N_CITIZENS, n_output_areas=N_OAS, seed=0)
    world_dev = world.to("cuda")
    say(f"world built in {time.perf_counter() - t:.2f}s: {world.n_citizens:,} "
        f"citizens, {world.n_riders:,} riders, {world.n_output_areas:,} OAs")
    records = check_kernels(world_dev, np.random.default_rng(1234))
    torch.cuda.synchronize()
    say("phase 2 done")

    counts = main_path(et, world_dev, smi)
    for rec in records:
        rec.update(path="main", launches=counts[rec["name"]])
    records.append(check_cumsum_path(np.random.default_rng(5), smi))
    records.append(check_benes_path(world, world_dev, np.random.default_rng(6),
                                    smi))
    for rec in records:
        rec["main_path_launches"] = counts[rec["name"]]
    torch.cuda.synchronize()
    small_reference(et)
    with tempfile.TemporaryDirectory() as tmp:
        york_counts = simulator_path(et, smi, tmp)
        pipeline_counts = pipeline_path(et, smi)
        ens_rec, ens_counts, ensemble = ensemble_path(et, smi)
        ens_rec["main_path_launches"] = counts[ens_rec["name"]]
        records.append(ens_rec)
        calibration_counts = calibrate_path(et, smi, tmp)
    uk_counts = full_uk_path(et, world_dev, smi)
    gid0_rec, sharded_counts, sharded_ens_counts = sharded_path(
        et, world, world_dev, ensemble, smi)
    gid0_rec["main_path_launches"] = 0
    records.append(gid0_rec)
    portable_counts, portable_sharded_counts = portable_path(
        et, world, world_dev, smi)
    one_card = dict(york_launches=york_counts,
                    pipeline_launches=pipeline_counts,
                    ensemble_launches=ens_counts,
                    calibration_launches=calibration_counts,
                    uk_launches=uk_counts)
    for rec in records:
        name = rec["name"]
        for key, c in one_card.items():
            rec[key] = 0 if name == "citizen_phase_gid0" else c[name]
        if name == "citizen_phase_gid0":
            rec["sharded_launches"] = sharded_counts["citizen_phase"]
            rec["sharded_ensemble_launches"] = sharded_ens_counts[
                "citizen_phase_ensemble"]
        else:  # phase 12's B1 launches count in the gid0 record alone
            b1 = name in ("citizen_phase", "citizen_phase_ensemble")
            rec["sharded_launches"] = 0 if b1 else sharded_counts[name]
            rec["sharded_ensemble_launches"] = (
                0 if b1 else sharded_ens_counts[name])
        rec["portable_launches"] = portable_counts.get(name, 0)
        rec["portable_sharded_launches"] = portable_sharded_counts.get(name, 0)

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

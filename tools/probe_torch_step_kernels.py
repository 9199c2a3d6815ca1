#!/usr/bin/env python3
"""Kernels B1 (``citizen_phase``) and B2 (``run_totals_fused``) at the
main path's shapes on one CUDA card, three ways.

    python3 tools/probe_torch_step_kernels.py [--root DIR] [--label NAME]

The inputs are those of ``chip_smoke.py``'s phase 2: the synthetic Y&H
world (3,457,142 citizens, 15,669 OAs, seed 0) and, from numpy seed
1234, a random state for B1 and a 0/1 contributor lane (p = 0.3) for B2
over the world's two work-order boundary sets.  Each kernel is first
held against its plain version (bitwise lanes and census; q is not
asked for), then timed:

* ``ms``: CUDA events around 20 back-to-back calls after 3 warm-ups,
  mean per call (the host's time per call shows here when it is longer
  than the device's);
* ``device``: device time and launches per call of each CUDA kernel and
  memset the call runs, from torch.profiler over 20 calls;
* ``host_us``: the host's microseconds per call of the wrapper with no
  synchronize between calls, the median of 5 runs of 300 calls (the
  host's time varies from run to run).

``--root`` imports ``epidemicsimulator_tpu_torch`` from another tree (an
unpacked ``git archive`` of an earlier commit, say), which builds its
own kernels there; run it once per tree in one call of the card to
compare them.  Prints one JSON line with the card's name and power
limit.
"""

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import epidemicsimulator_tpu_torch as et
    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import citizen, scans

    world = et.generate_synthetic_world(3_457_142, n_output_areas=15_669,
                                        seed=0).to("cuda")
    n = world.n_citizens
    rng = np.random.default_rng(1234)
    dev = lambda x: torch.from_numpy(x).cuda()
    v = dev((rng.random(n) < 0.3).astype(np.int8))
    sets = [(world.ws_wb_start_mask, world.ws_wb_end_mask),
            (world.ws_room_start_mask, world.ws_room_end_mask)]
    statics = citizen.make_citizen_statics(world)
    status = dev(rng.choice(5, n, p=[0.80, 0.05, 0.05, 0.05, 0.05]).astype(np.int8))
    timer = dev(rng.integers(0, 400, n).astype(np.int32))
    sched = dev(rng.integers(0, 32, n).astype(np.int8))
    f32 = np.float32
    kw = dict(h24=8, move=True, mask_status=2, seed=int(rng.integers(0, 2**32)),
              exposed_time=96, infected_time=336, exposure_chance=f32(0.00055),
              mask_scale=f32(1.0) - f32(0.7), K=world.max_household_size,
              ref_mask_sem=True, u8_trunc=True)

    b1 = lambda: citizen.citizen_phase(statics, status, timer, sched, **kw)
    b2 = lambda: scans.run_totals_fused(v, sets)
    got, want = b1(), citizen.citizen_phase_plain(statics, status, timer,
                                                  sched, **kw)
    flip = (got[3] ^ want[3]) == 4  # a home hit from a q 1 ulp apart
    if not (all(torch.equal(a[~flip], b[~flip]) for a, b in zip(got[:4], want[:4]))
            and torch.equal(got[4][:7], want[4][:7])):
        raise AssertionError("citizen_phase disagrees with its plain version")
    if not all(torch.equal(a, b) for a, b in
               zip(b2(), scans.run_totals_fused_plain(v, sets))):
        raise AssertionError("run_totals_fused disagrees with its plain version")

    res = {"label": args.label, "root": os.path.abspath(args.root),
           "card": runtime.card(), "n": n}
    for name, fn in (("citizen_phase", b1), ("run_totals_fused", b2)):
        res[name] = {
            "ms": runtime.cuda_ms(fn),
            "device": {k: {"ms": ms, "per_call": c}
                       for k, (ms, c) in runtime.device_ms(fn).items()},
            "host_us": statistics.median(runtime.host_us(fn) for _ in range(5)),
        }
        res[name]["device_ms"] = sum(d["ms"] for d in res[name]["device"].values())
        res[name]["device_ops"] = sum(d["per_call"] for d in res[name]["device"].values())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Kernel B5, the Beneš replay, against the gather on one CUDA card.

    python3 tools/probe_torch_benes.py [--profile]

Builds the synthetic Yorkshire and Humber world (3,457,142 citizens,
15,669 OAs, seed 0), routes its work-order permutation ``work_perm`` and
a random permutation of the same size (numpy seed 0, the gather by
``argsort`` of a random rank) on the host, and prints each routing time,
k and the control table's size.  Then, for each table, replays an int8
payload forward and in reverse on the card, checks the results against
the gathers ``x[src]`` and ``x[inverse(src)]`` (for the world,
``x[work_perm]`` and ``x[wpos]``) and against the plain replay, and
prints ms per pass (CUDA events, the mean of 20 after 3 warm-ups) of the
kernel, the plain replay and the gather, the card's name and power
limit and one JSON line.  ``--profile`` traces 20 forward replays of the
world's table with torch.profiler and prints the device time of each
CUDA kernel per replay and their sum by part: the middle pass
(``benes_middle``), the outer passes (``benes_outer``) and anything
else (the kernel reads the unpadded payload, so there is no padding
copy).  ``chip_smoke.py`` runs :func:`replay`
on ``work_perm`` as its Beneš path.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_CITIZENS = 3_457_142
N_OAS = 15_669
REPS = 20


def replay(name, src, inv, x):
    """Route ``src`` (numpy) on the host, then replay ``x`` forward and
    in reverse, checked bitwise against the gathers by ``src`` and by its
    inverse ``inv`` and timed beside them, counting the kernel's
    launches; then against the plain replay, timed too.  Returns
    (results, ctrl on x's device, k)."""
    import numpy as np
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import benes

    t = time.perf_counter()
    ctrl, k = benes.route_permutation(src)
    res = {"route_s": time.perf_counter() - t, "k": k,
           "ctrl_mb": ctrl.numel() / 1e6}
    print(f"[{name}] route: {res['route_s']:.3f} s, k={k}, "
          f"ctrl {res['ctrl_mb']:.3f} MB", flush=True)
    ctrl = ctrl.to(x.device)
    ways = {"forward": (False, src), "reverse": (True, inv)}
    torch.cuda.synchronize()
    runtime.reset_launches()
    for label, (reverse, idx) in ways.items():
        gidx = torch.from_numpy(np.asarray(idx, np.int64)).to(x.device)
        if not torch.equal(benes.benes_permute(x, ctrl, k, reverse=reverse),
                           x[gidx]):
            raise AssertionError(f"[{name}] {label} replay != gather")
        res[label] = {
            "ms": runtime.cuda_ms(lambda: benes.benes_permute(
                x, ctrl, k, reverse=reverse), REPS),
            "gather_ms": runtime.cuda_ms(lambda: x[gidx], REPS),
        }
    torch.cuda.synchronize()
    res["launches"] = runtime.launches["benes_permute"]
    if not res["launches"]:
        raise AssertionError("benes_permute was never launched")
    for label, (reverse, _) in ways.items():
        if not torch.equal(benes.benes_permute(x, ctrl, k, reverse=reverse),
                           benes.benes_permute_plain(x, ctrl, k,
                                                     reverse=reverse)):
            raise AssertionError(f"[{name}] {label} kernel != plain replay")
        res[label]["plain_ms"] = runtime.cuda_ms(
            lambda: benes.benes_permute_plain(x, ctrl, k, reverse=reverse),
            REPS)
        r = res[label]
        print(f"[{name}] {label}: kernel {r['ms']:.4f} ms, plain replay "
              f"{r['plain_ms']:.4f} ms, gather {r['gather_ms']:.4f} ms; "
              f"equal to the gather and the plain replay", flush=True)
    return res, ctrl, k


def profile_replay(x, ctrl, k):
    """Device ms per forward replay, by CUDA kernel, from torch.profiler."""
    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import benes

    rows = runtime.device_ms(lambda: benes.benes_permute(x, ctrl, k), REPS)
    print("device time per forward replay (ms, launches, kernel):")
    for key, (ms, count) in sorted(rows.items(), key=lambda r: -r[1][0]):
        print(f"  {ms:8.4f} {count:6.2f}  {key[:80]}")
    split = {part: sum(ms for key, (ms, _) in rows.items() if part in key)
             for part in ("benes_middle", "benes_outer")}
    split["other"] = sum(ms for ms, _ in rows.values()) - sum(split.values())
    print("per forward replay: " + ", ".join(
        f"{part} {ms:.4f} ms" for part, ms in split.items()))
    return {"kernels": {key: ms for key, (ms, _) in rows.items()}, **split}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    import epidemicsimulator_tpu_torch as et
    from epidemicsimulator_tpu_torch import runtime

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = runtime.card()
    t = time.perf_counter()
    world = et.generate_synthetic_world(N_CITIZENS, n_output_areas=N_OAS, seed=0)
    n = world.n_citizens
    print(f"world: {n:,} citizens in {time.perf_counter() - t:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    random_src = np.argsort(rng.permutation(n))
    random_inv = np.empty_like(random_src)
    random_inv[random_src] = np.arange(n)
    x = torch.from_numpy(rng.integers(0, 32, n).astype(np.int8)).cuda()
    res = {"card": card, "n": n}
    res["work_perm"], ctrl, k = replay(
        "work_perm", np.asarray(world.work_perm), np.asarray(world.wpos), x)
    if args.profile:
        res["profile_ms"] = profile_replay(x, ctrl, k)
    res["random"] = replay("random", random_src, random_inv, x)[0]
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

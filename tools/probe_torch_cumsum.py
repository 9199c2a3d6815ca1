#!/usr/bin/env python3
"""The int8 cumsum three ways on one CUDA card: kernel B3
(``cumsum_i8``), kernel B4 (``cumsum_i8_2phase``) and ``torch.cumsum``.

    python3 tools/probe_torch_cumsum.py [--root DIR]

The lanes are 0/1 with p = 0.001 from numpy seed 1: one of 3,457,142
(the Y&H citizen count, B3's size on the fused step) and one of
63,000,000 (the full-UK citizen count).  Every kernel's result must equal
``torch.cumsum`` bitwise.  On each lane the three are timed in turns
(:func:`turns`): ms per pass by CUDA events (the mean of 20 passes after
3 warm-ups), then each one's device time per call by CUDA kernel and
memset (torch.profiler).  At 3,457,142 it also prints the host's
microseconds per call, with no sync between calls, of B3's and B4's
wrappers, ``torch.cumsum`` and two ways to get the current stream.
Prints the card's name and power limit and one JSON line of the numbers,
with the launches of each kernel.

``--root`` imports ``epidemicsimulator_tpu_torch`` from another tree (an
unpacked ``git archive`` of an earlier commit, say), which builds its
own kernels there; run it once per tree in one call of the card to
compare them.  A tree whose B4 still takes ``tile_elems`` runs it at
``B4_TILE``, the tile of the earlier records.  ``chip_smoke.py`` runs
:func:`path` and :func:`turns` as its cumsum path.
"""

import argparse
import functools
import inspect
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_YH = 3_457_142
N_UK = 63_000_000
B4_TILE = 16_384
ROUNDS = 4


def lane(n=N_UK):
    """The probe's lane on the card."""
    import numpy as np
    import torch

    return torch.from_numpy(
        (np.random.default_rng(1).random(n) < 0.001).astype(np.int8)).cuda()


def functions(v):
    """{name: the call on ``v``} for ``torch.cumsum``, B3 and B4."""
    import torch

    from epidemicsimulator_tpu_torch.ops import scans

    b4 = scans.cumsum_i8_2phase
    if "tile_elems" in inspect.signature(b4).parameters:
        b4 = functools.partial(b4, tile_elems=B4_TILE)
    return {
        "torch.cumsum": lambda: torch.cumsum(v, 0, dtype=torch.int32),
        "cumsum_i8": lambda: scans.cumsum_i8(v),
        "cumsum_i8_2phase": lambda: b4(v),
    }


def path(v):
    """The cumsum path on ``v``: with the launch counts set to 0, B3 and
    B4 each checked bitwise against ``torch.cumsum`` and timed; then
    ``torch.cumsum``'s own time.  Returns {name: ms} and the launches.
    Raises if a result differs or a kernel never launched."""
    import torch

    from epidemicsimulator_tpu_torch import runtime

    fns = functions(v)
    want = fns.pop("torch.cumsum")()
    torch.cuda.synchronize()
    runtime.reset_launches()
    res = {}
    for name, fn in fns.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} disagrees with torch.cumsum")
        res[name] = runtime.cuda_ms(fn)
    res["launches"] = {name: runtime.launches[name] for name in fns}
    if not all(res["launches"].values()):
        raise AssertionError("a cumsum kernel was never launched")
    res["torch.cumsum"] = runtime.cuda_ms(
        lambda: torch.cumsum(v, 0, dtype=torch.int32))
    return res


def turns(v, rounds=ROUNDS):
    """``torch.cumsum``, B3 and B4 on ``v``, each checked bitwise against
    ``torch.cumsum``, then timed in turns: round r times the three in an
    order rotated by r, so that drift within the call falls on all three;
    then each one's device time per call, from torch.profiler (the host's
    time between launches left out).  Returns ({name: [ms of each
    round]}, {name: {kernel or memset: [device ms, launches] per call}})."""
    import torch

    from epidemicsimulator_tpu_torch import runtime

    fns = functions(v)
    want = fns["torch.cumsum"]()
    for name, fn in fns.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} disagrees with torch.cumsum")
    names = list(fns)
    res = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % 3:] + names[:r % 3]:
            res[name].append(runtime.cuda_ms(fns[name]))
    dev = {name: {k: list(row) for k, row in runtime.device_ms(fn).items()}
           for name, fn in fns.items()}
    return res, dev


def device_sum(rows):
    """(device ms, device operations) per call from one entry of
    :func:`turns`' device times."""
    return (sum(ms for ms, _ in rows.values()),
            sum(c for _, c in rows.values()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from epidemicsimulator_tpu_torch import runtime

    card = runtime.card()
    res = {"root": os.path.abspath(args.root), "card": card, "turns": {}}
    for n in (N_YH, N_UK):
        v = lane(n)
        t, dev = turns(v)
        res["turns"][n] = {"ms": t, "device": dev}
        print(f"N = {n:,}, in turns, ms per round on {card}: " + "; ".join(
            f"{name} {' '.join(f'{ms:.4f}' for ms in ms_list)}"
            for name, ms_list in t.items()))
        for name, rows in dev.items():
            ms, ops = device_sum(rows)
            print(f"N = {n:,}, {name}: {ms:.4f} device ms in {ops} device "
                  "operations per call: " + "; ".join(
                      f"{k} {r[0]:.4f} x{r[1]}" for k, r in rows.items()))
        # the host's side of a call, at the step's size
        if n == N_YH:
            fns = functions(v)
            host = {
                "cumsum_i8": fns["cumsum_i8"],
                "cumsum_i8_2phase": fns["cumsum_i8_2phase"],
                "torch.cumsum": fns["torch.cumsum"],
                "runtime.stream_handle": runtime.stream_handle,
                "torch.cuda.current_stream().cuda_stream":
                    lambda: torch.cuda.current_stream().cuda_stream,
            }
            res["host_us"] = {name: runtime.host_us(fn) for name, fn in host.items()}
            print(f"N = {n:,}, host us per call (no sync): " + "; ".join(
                f"{name} {us:.2f}" for name, us in res["host_us"].items()))
    res["path"] = path(v)
    print(f"N = {N_UK:,}, the cumsum path, ms: {res['path']}; all bitwise "
          "equal to torch.cumsum")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

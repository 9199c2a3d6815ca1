#!/usr/bin/env python3
"""The int8 cumsum four ways on one CUDA card: kernel B3 (``cumsum_i8``),
kernel B4 (``cumsum_i8_2phase``) at a sweep of tile sizes, B4's plain
torch version and ``torch.cumsum``.

    python3 tools/probe_torch_cumsum.py

The lanes are 0/1 with p = 0.001 from numpy seed 1: one of 3,457,142
(the Y&H citizen count, B3's size on the fused step) and one of
63,000,000 (the full-UK citizen count).  Every kernel's result must equal
``torch.cumsum`` bitwise.  On each lane, B3, B4 (tile B4_TILE) and
``torch.cumsum`` are timed in turns (:func:`turns`); on the 63M lane, B4
is also swept over TILES.  Times are ms per pass (CUDA events, the mean
of 20 passes after 3 warm-ups); the turns also give each function's
device time per call from torch.profiler.  At 3,457,142 it also prints
the host's microseconds per call, with no sync between calls, of B3's
wrapper, ``torch.cumsum`` and two ways to get the current stream.
Prints the launches of each kernel, the card's name and power limit, and
one JSON line of the numbers.
``chip_smoke.py`` runs :func:`sweep` and :func:`turns` as its cumsum
path.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_YH = 3_457_142
N_UK = 63_000_000
TILES = (1024, 4096, 16_384, 65_536, 131_072, 524_288, 1_048_576)
B4_TILE = 16_384
ROUNDS = 4


def lane(n=N_UK):
    """The probe's lane on the card."""
    import numpy as np
    import torch

    return torch.from_numpy(
        (np.random.default_rng(1).random(n) < 0.001).astype(np.int8)).cuda()


def sweep(v):
    """B3 and B4 at each of TILES on ``v``, each checked bitwise against
    ``torch.cumsum`` and timed, with the launch counts of the run; then
    ``torch.cumsum``'s own time.  Raises if a result differs or a kernel
    never launched."""
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import scans

    want = torch.cumsum(v, 0, dtype=torch.int32)
    torch.cuda.synchronize()
    runtime.reset_launches()
    if not torch.equal(scans.cumsum_i8(v), want):
        raise AssertionError("cumsum_i8 disagrees with torch.cumsum")
    res = {"n": v.shape[0],
           "cumsum_i8_ms": runtime.cuda_ms(lambda: scans.cumsum_i8(v)),
           "cumsum_i8_2phase_ms": {}}
    for t in TILES:
        if not torch.equal(scans.cumsum_i8_2phase(v, tile_elems=t), want):
            raise AssertionError(f"cumsum_i8_2phase(tile_elems={t}) disagrees")
        res["cumsum_i8_2phase_ms"][t] = runtime.cuda_ms(
            lambda: scans.cumsum_i8_2phase(v, tile_elems=t))
    res["launches"] = dict(runtime.launches)
    if not (res["launches"]["cumsum_i8"] and res["launches"]["cumsum_i8_2phase"]):
        raise AssertionError("a cumsum kernel was never launched")
    res["torch_cumsum_ms"] = runtime.cuda_ms(
        lambda: torch.cumsum(v, 0, dtype=torch.int32))
    return res


def turns(v, rounds=ROUNDS):
    """B3, B4 (tile B4_TILE) and ``torch.cumsum`` on ``v``, each checked
    bitwise against ``torch.cumsum``, then timed in turns: round r times
    the three in an order rotated by r, so that drift within the call
    falls on all three; then each one's device time per call, from
    torch.profiler (the host's time between launches left out).  Returns
    ({name: [ms of each round]}, {name: device ms})."""
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import scans

    fns = {
        "torch.cumsum": lambda: torch.cumsum(v, 0, dtype=torch.int32),
        "cumsum_i8": lambda: scans.cumsum_i8(v),
        "cumsum_i8_2phase": lambda: scans.cumsum_i8_2phase(v, tile_elems=B4_TILE),
    }
    want = fns["torch.cumsum"]()
    for name, fn in fns.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} disagrees with torch.cumsum")
    names = list(fns)
    res = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % 3:] + names[:r % 3]:
            res[name].append(runtime.cuda_ms(fns[name]))
    dev = {name: sum(ms for ms, _ in runtime.device_ms(fn).values())
           for name, fn in fns.items()}
    return res, dev


def main():
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import scans

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = runtime.card()
    res = {"turns": {}}
    for n in (N_YH, N_UK):
        v = lane(n)
        t, dev = turns(v)
        res["turns"][n] = {"ms": t, "device_ms": dev}
        print(f"N = {n:,}, in turns, ms per round on {card}: " + "; ".join(
            f"{name} {' '.join(f'{ms:.4f}' for ms in ms_list)}"
            for name, ms_list in t.items()))
        print(f"N = {n:,}, device ms per call: " + "; ".join(
            f"{name} {ms:.4f}" for name, ms in dev.items()))
        # the host's side of a call, at the step's size
        if n == N_YH:
            host = {
                "cumsum_i8": lambda: scans.cumsum_i8(v),
                "torch.cumsum": lambda: torch.cumsum(v, 0, dtype=torch.int32),
                "runtime.stream_handle": runtime.stream_handle,
                "torch.cuda.current_stream().cuda_stream":
                    lambda: torch.cuda.current_stream().cuda_stream,
            }
            res["host_us"] = {name: runtime.host_us(fn) for name, fn in host.items()}
            print(f"N = {n:,}, host us per call (no sync): " + "; ".join(
                f"{name} {us:.2f}" for name, us in res["host_us"].items()))
    res.update(sweep(v))
    print(f"B3 cumsum_i8: {res['cumsum_i8_ms']:.4f} ms")
    for t, ms in res["cumsum_i8_2phase_ms"].items():
        print(f"B4 cumsum_i8_2phase tile_elems={t}: {ms:.4f} ms")
    t = TILES[0]
    if not torch.equal(scans.cumsum_i8_2phase_plain(v, tile_elems=t),
                       torch.cumsum(v, 0, dtype=torch.int32)):
        raise AssertionError("cumsum_i8_2phase_plain disagrees")
    res["plain_ms"] = runtime.cuda_ms(
        lambda: scans.cumsum_i8_2phase_plain(v, tile_elems=t))
    print(f"B4 plain (tile_elems={t}): {res['plain_ms']:.4f} ms; "
          f"torch.cumsum: {res['torch_cumsum_ms']:.4f} ms; "
          f"launches {res['launches']}; all bitwise equal")
    res["card"] = card
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

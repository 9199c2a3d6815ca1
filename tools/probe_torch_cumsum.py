#!/usr/bin/env python3
"""The int8 cumsum four ways on one CUDA card: kernel B3 (``cumsum_i8``),
kernel B4 (``cumsum_i8_2phase``) at a sweep of tile sizes, B4's plain
torch version and ``torch.cumsum``, on one lane.

    python3 tools/probe_torch_cumsum.py

The lane is 0/1 with p = 0.001 from numpy seed 1, of 63,000,000: the
full-UK citizen count.  Every kernel's result must equal ``torch.cumsum``
bitwise.  Prints ms per pass (CUDA events, the mean of 20 passes after
3 warm-ups), the launches of each kernel, the card's name and power
limit, and one JSON line of the numbers.  ``chip_smoke.py`` runs
:func:`sweep` as its cumsum path.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_UK = 63_000_000
TILES = (1024, 4096, 16_384, 65_536, 131_072, 524_288, 1_048_576)


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


def main():
    import torch

    from epidemicsimulator_tpu_torch import runtime
    from epidemicsimulator_tpu_torch.ops import scans

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = runtime.card()
    v = lane()
    res = sweep(v)
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

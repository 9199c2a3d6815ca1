"""The York v1.6 multi-seed envelope, run by the PyTorch port on the card.

    python3 tools/probe_torch_v16.py [--seeds 32] [--out DIR]

The port's copy of ``tools/probe_v16.py``'s ``v16`` mode: for each seed
s, the census-like York world ``generate_census_like_world(197_603, 637,
seed=42 + s % 4)`` (the four worlds are built once), sim seed s,
``Params.covid_v16()``, ``SimConfig(max_steps=5000, chunk_size=500)``,
run to the end of the epidemic.  Writes ``seeds.jsonl`` (one row per
seed: the JAX probe's fields, plus the run's wall time and that time
over its reported hours, which leaves out the steps the last chunk ran
past the end) and
``summary.json`` (the JAX summary's fields and its ``inside_envelope``
flags for the canonical v1.6 targets) into ``--out``, default
``sample_results/york_v16_torch``.  Each range stands beside the JAX
package's 32-seed range from ``sample_results/york_v16/summary.json``,
which is read, never written; without that file the JAX ranges are
null.  No curves are written.  Imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import epidemicsimulator_tpu_torch as et  # noqa: E402
from epidemicsimulator_tpu_torch import runtime  # noqa: E402

YORK_N, YORK_OA = 197_603, 637
JAX_SUMMARY = os.path.join(ROOT, "sample_results", "york_v16", "summary.json")
#: the canonical v1.6 artifact (statistics_results/york_stats_results/v1.6)
TARGET = {"peak": 89170, "peak_h": 946, "attack_final_R": 101677,
          "final_V": 95944, "end_h": 1426}
#: summary range -> (seeds.jsonl field, target key, inside_envelope flag)
RANGES = {
    "peak_range": ("peak", "peak", "peak"),
    "peak_h_range": ("peak_h", "peak_h", "peak_h"),
    "attack_range": ("attack", "attack_final_R", "attack"),
    "max_V_range": ("max_V", "final_V", "max_V"),
    "end_h_range": ("steps", "end_h", "end_h"),
}


def fit_growth(seirv, lo=30, hi=4000):
    inf = seirv[:, 2].astype(float)
    t = np.arange(len(inf))
    peak_t = int(inf.argmax())
    m = (inf >= lo) & (inf <= hi) & (t <= peak_t)
    if m.sum() < 10:
        return float("nan")
    return float(np.polyfit(t[m], np.log(inf[m]), 1)[0])


def seed_row(seed, seirv, seconds):
    inf = seirv[:, 2]
    return {
        "seed": seed, "peak": int(inf.max()), "peak_h": int(inf.argmax()),
        "r": round(fit_growth(seirv, hi=20000), 5),
        "attack": int(seirv[-1, 3] + seirv[-1, 2] + seirv[-1, 1]),
        "max_V": int(seirv[:, 4].max()), "steps": len(seirv),
        "seconds": seconds, "ms_per_step": seconds * 1e3 / len(seirv),
    }


def summarize(rows, jax_summary, card):
    rng = lambda k: [min(r[k] for r in rows), max(r[k] for r in rows)]
    return {
        "params": "Params.covid_v16() (exposure_chance=0.003, vax "
                  "5100/step, thresholds .20/.30/.40/.60)",
        "world": "census-like York (197,603 citizens, 637 OAs, mega "
                 "sites on), world seed 42+s%4, sim seed s",
        "engine": "epidemicsimulator_tpu_torch Simulator, "
                  "SimConfig(max_steps=5000, chunk_size=500)",
        "device": card,
        "n_seeds": len(rows),
        **{name: rng(field) for name, (field, _, _) in RANGES.items()},
        "target_v16_canonical": TARGET,
        "inside_envelope": {
            flag: rng(field)[0] <= TARGET[target] <= rng(field)[1]
            for field, target, flag in RANGES.values()
        },
        "jax_32_seed": {
            name: (jax_summary or {}).get(name) for name in RANGES
        },
        "ms_per_step_range": rng("ms_per_step"),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=32)
    p.add_argument("--out", default=os.path.join(ROOT, "sample_results",
                                                 "york_v16_torch"))
    args = p.parse_args(argv)
    et.resolve_device("cuda")
    card = runtime.card()
    print(card, flush=True)

    t = time.perf_counter()
    worlds = {}
    for s in range(min(args.seeds, 4)):
        worlds[42 + s] = et.generate_census_like_world(
            YORK_N, YORK_OA, seed=42 + s).to("cuda")
    print(f"built {len(worlds)} worlds in {time.perf_counter() - t:.2f}s",
          flush=True)

    os.makedirs(args.out, exist_ok=True)
    cfg = et.SimConfig(max_steps=5000, chunk_size=500)
    rows = []
    with open(os.path.join(args.out, "seeds.jsonl"), "w") as f:
        for seed in range(args.seeds):
            sim = et.Simulator(worlds[42 + seed % 4], et.Params.covid_v16(), cfg,
                               seed=seed, verbose=False)
            t = time.perf_counter()
            seirv = sim.simulate()
            rows.append(seed_row(seed, seirv, time.perf_counter() - t))
            f.write(json.dumps(rows[-1]) + "\n")
            print(json.dumps(rows[-1]), flush=True)

    jax_summary = None
    if os.path.exists(JAX_SUMMARY):
        with open(JAX_SUMMARY) as f:
            jax_summary = json.load(f)
    summary = summarize(rows, jax_summary, card)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for name in RANGES:
        print(f"{name}: port {summary[name]}, JAX package "
              f"{summary['jax_32_seed'][name]}")
    print(json.dumps(summary["inside_envelope"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

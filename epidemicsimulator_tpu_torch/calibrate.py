"""Parameter calibration against a target epidemic curve.

The port's copy of ``epidemicsimulator_tpu/calibrate.py``.  R candidate
values of one parameter run as one packed ensemble (engine/packed.py), and
the search is a few rounds of grid refinement over that R-wide evaluator.
The score mixes the normalised RMSE of the infected curve with the
relative errors of the peak size, the peak hour and the attack rate: the
shape of the epidemic, not a pointwise overlay.

Usage (library)::

    from epidemicsimulator_tpu_torch.calibrate import calibrate
    result = calibrate(world, base_params, cfg, target_series,
                       param="exposure_chance", bounds=(1e-4, 1e-2))

CLI: ``python -m epidemicsimulator_tpu_torch.cli <area> --synthetic N
--calibrate target_global_stats.json`` (``--device cpu`` for the plain
versions on the CPU).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .config import Params, SimConfig


def load_target_series(path: str) -> np.ndarray:
    """(T, 5) SEIRV series from a reference-format global_stats.json."""
    with open(path) as f:
        rows = json.load(f)
    keys = ("susceptible", "exposed", "infected", "recovered", "vaccinated")
    out = np.asarray([[r[k] for k in keys] for r in rows], np.int64)
    # drop the trailing zero entry the reference always appends
    # (statistics.rs:113-116) so scores aren't polluted by it
    if len(out) > 1 and out[-1].sum() == 0:
        out = out[:-1]
    return out


def _with_param(base: Params, param: str, value: float) -> Params:
    if hasattr(base.disease, param):
        return Params(
            dataclasses.replace(base.disease, **{param: value}),
            base.thresholds,
        )
    if hasattr(base.thresholds, param):
        return Params(
            base.disease,
            dataclasses.replace(base.thresholds, **{param: value}),
        )
    raise ValueError(f"unknown calibration parameter {param!r}")


def score_against_target(series: np.ndarray, target: np.ndarray) -> dict:
    """Shape score of one (T, 5) run vs the (T', 5) target (lower=better).

    Components: infected-curve nRMSE over the overlapping window
    (normalised by the target's peak), relative peak-size error, peak-hour
    error as a fraction of the target's peak hour, and relative
    attack-rate (final R) error.
    """
    t = min(len(series), len(target))
    inf_s = series[:t, 2].astype(np.float64)
    inf_t = target[:t, 2].astype(np.float64)
    peak_t = max(float(target[:, 2].max()), 1.0)
    nrmse = float(np.sqrt(np.mean((inf_s - inf_t) ** 2)) / peak_t)
    peak_s = float(series[:, 2].max())
    peak_err = abs(peak_s - peak_t) / peak_t
    ph_s = float(series[:, 2].argmax())
    ph_t = max(float(target[:, 2].argmax()), 1.0)
    ph_err = abs(ph_s - ph_t) / ph_t
    att_t = max(float(target[-1, 3]), 1.0)
    att_err = abs(float(series[-1, 3]) - att_t) / att_t
    return {
        "nrmse_infected": nrmse,
        "peak_rel_err": peak_err,
        "peak_hour_rel_err": ph_err,
        "attack_rel_err": att_err,
        "score": nrmse + peak_err + 0.5 * ph_err + att_err,
    }


def calibrate(
    world,
    base_params: Params,
    cfg: SimConfig,
    target: np.ndarray,
    *,
    param: str = "exposure_chance",
    bounds: tuple[float, float] = (1e-4, 1e-2),
    replicates: int = 16,
    rounds: int = 2,
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Fit one scalar parameter so the simulated epidemic matches
    ``target`` ((T, 5) SEIRV array, :func:`load_target_series`).

    Each round evaluates ``replicates`` candidate values in ONE ensemble
    run and zooms the bracket to the neighbours of the best candidate;
    ``rounds`` rounds give resolution ``(hi/lo)^(1/replicates^rounds)``
    (candidates evenly spaced in log space).  Returns the best value, its per-component score and the
    full per-round evaluation table.  The ensembles run on ``device``.
    """
    from .engine.ensemble import run_ensemble

    lo, hi = float(bounds[0]), float(bounds[1])
    assert lo > 0 and hi > lo
    history = []
    best_value, best_score = None, None
    for rnd in range(rounds):
        cand = np.exp(np.linspace(np.log(lo), np.log(hi), replicates))
        plist = [_with_param(base_params, param, float(c)) for c in cand]
        seirv = run_ensemble(world, plist, cfg, seed=seed, device=device)
        scores = [score_against_target(np.asarray(s), target) for s in seirv]
        order = int(np.argmin([s["score"] for s in scores]))
        history.append({
            "round": rnd,
            "bounds": [lo, hi],
            "candidates": [float(c) for c in cand],
            "scores": [s["score"] for s in scores],
            "best": float(cand[order]),
        })
        if verbose:
            print(
                f"[calibrate] round {rnd}: best {param}="
                f"{cand[order]:.6g} score {scores[order]['score']:.4f} "
                f"(bracket [{lo:.3g}, {hi:.3g}])",
                flush=True,
            )
        best_value, best_score = float(cand[order]), scores[order]
        lo = float(cand[max(order - 1, 0)])
        hi = float(cand[min(order + 1, replicates - 1)])
        if hi <= lo:  # best at a bracket edge; widen one notch
            lo, hi = lo * 0.8, hi * 1.25
    return {
        "param": param,
        "value": best_value,
        "score": best_score,
        "rounds": history,
        "replicates": replicates,
    }

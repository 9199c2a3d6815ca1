"""Real-world gov.uk case and vaccination data: the validation comparators.

The port's copy of ``epidemicsimulator_tpu/data/realworld.py`` (numpy and
``csv`` only).  The reference ships York's pandemic series
(``reference_data/York/cases.csv``, newCasesBySpecimenDate by day, and
``vaccinations.csv``, cumulative first, second and third doses).  This
module parses the gov.uk CSVs (space-padded column names,
reverse-chronological rows), puts the real series and simulated SEIRV
curves on one per-capita incidence axis, and measures waves.

Incidence from a SEIRV series: R is absorbing and I's only outflow is
I->R, so per-hour new clinical onsets (the analogue of "cases by specimen
date") are exactly ``dI + dR``, and new exposures ``dE + dI + dR``
(disease.rs:47-71).
"""

from __future__ import annotations

import csv
import datetime as dt

import numpy as np

#: 2011-census usually-resident population of York (E06000014), the
#: population the reference's York world draws from (KS101EW): it puts
#: the real case counts on the per-capita axis of the simulated worlds
#: (~197.6k citizens after OA filtering).
YORK_POPULATION_2011 = 198_051


def load_gov_uk_csv(path: str) -> dict[str, np.ndarray]:
    """Parse a gov.uk coronavirus-dashboard CSV export.

    The dashboard's files pad column names and values with spaces
    (``areaCode ,date      ,...``); rows are reverse-chronological.
    Returns a dict of stripped column name -> array (dates as
    ``datetime.date``, numerics as float64 with NaN for blanks), sorted
    ascending by date.
    """
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = [h.strip() for h in rows[0]]
    cols: dict[str, list] = {h: [] for h in header}
    for row in rows[1:]:
        if not row or not any(cell.strip() for cell in row):
            continue
        for h, cell in zip(header, row):
            cols[h].append(cell.strip())
    out: dict[str, np.ndarray] = {}
    order = np.argsort([d for d in cols["date"]])
    for h, vals in cols.items():
        if h == "date":
            out[h] = np.asarray(
                [dt.date.fromisoformat(vals[i]) for i in order]
            )
        elif h in ("areaType", "areaName", "areaCode"):
            out[h] = np.asarray([vals[i] for i in order])
        else:
            out[h] = np.asarray(
                [float(vals[i]) if vals[i] else np.nan for i in order]
            )
    return out


def daily_cases(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(dates, newCasesBySpecimenDate) ascending."""
    d = load_gov_uk_csv(path)
    return d["date"], d["newCasesBySpecimenDate"]


def daily_first_doses(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(dates, cumulative first doses) ascending."""
    d = load_gov_uk_csv(path)
    return d["date"], d["cumPeopleVaccinatedFirstDoseByVaccinationDate"]


def sim_daily_incidence(seirv: np.ndarray) -> np.ndarray:
    """Per-DAY new clinical onsets from an hourly (T, 5) SEIRV series.

    Hourly onsets = dI + dR (I's inflow; R absorbing); summed over
    24-hour blocks (partial trailing day kept).  Hour 0 uses the seeded
    infected as the first delta (they onset at t=0).
    """
    seirv = np.asarray(seirv)
    i_r = seirv[:, 2] + seirv[:, 3]
    hourly = np.diff(i_r, prepend=0)
    n_days = -(-len(hourly) // 24)
    padded = np.zeros(n_days * 24)
    padded[: len(hourly)] = hourly
    return padded.reshape(n_days, 24).sum(axis=1)


def largest_wave(dates: np.ndarray, cases: np.ndarray, *,
                 window_days: int = 120) -> slice:
    """Index slice of the ``window_days`` window with the most cases:
    the real wave a single-wave SEIR run is compared against."""
    c = np.nan_to_num(np.asarray(cases, float))
    if len(c) <= window_days:
        return slice(0, len(c))
    sums = np.convolve(c, np.ones(window_days), mode="valid")
    start = int(np.argmax(sums))
    return slice(start, start + window_days)


def wave_metrics(daily: np.ndarray, population: int) -> dict:
    """Shape metrics for one wave of per-day incidence."""
    daily = np.nan_to_num(np.asarray(daily, float))
    total = float(daily.sum())
    peak = int(np.argmax(daily))
    half = daily.max() / 2.0
    above = np.flatnonzero(daily >= half)
    return {
        "peak_daily_per_100k": round(1e5 * daily.max() / population, 1),
        "peak_day": peak,
        "attack_pct": round(100.0 * total / population, 2),
        "fwhm_days": int(above[-1] - above[0] + 1) if len(above) else 0,
    }


def target_from_daily_cases(daily: np.ndarray, population: int, *,
                            infected_time: int = 14 * 24,
                            ascertainment: float = 1.0) -> np.ndarray:
    """Pseudo-SEIRV hourly target from real daily case counts: the
    adapter that lets ``calibrate()`` fit against gov.uk data directly.

    Observed daily onsets (scaled by 1/``ascertainment`` for
    under-reporting; default 1.0 = fit the observed curve as-is) spread
    uniformly over each day's 24 hours; prevalence I(t) is the rolling
    ``infected_time``-hour sum of onsets (exactly the SEIR's I given
    disease.rs:61 I->R at infected_time), R(t) the onsets that have left
    it.  E and V are zeroed: ``score_against_target`` reads only the I
    curve and the final R, so the fit is well-posed without unobservable
    exposure counts.  S balances the census.
    """
    daily = np.nan_to_num(np.asarray(daily, float)) / float(ascertainment)
    hourly = np.repeat(daily / 24.0, 24)
    T = len(hourly)
    cum = np.cumsum(hourly)
    i_curve = cum - np.concatenate(
        [np.zeros(min(infected_time, T)), cum[:-infected_time]]
    )[:T]
    r_curve = cum - i_curve
    out = np.zeros((T, 5), np.float64)
    out[:, 2] = i_curve
    out[:, 3] = r_curve
    out[:, 0] = population - i_curve - r_curve
    return out


def vaccination_rollout_metrics(dates: np.ndarray, cum_first: np.ndarray,
                                population: int) -> dict:
    """Real first-dose rollout: peak daily rate and days to 50% uptake."""
    cum = np.nan_to_num(np.asarray(cum_first, float))
    daily = np.diff(cum, prepend=0)
    half_idx = np.flatnonzero(cum >= 0.5 * population)
    return {
        "peak_daily_per_100k": round(1e5 * daily.max() / population, 1),
        "days_to_50pct": int(half_idx[0]) if len(half_idx) else None,
        "final_uptake_pct": round(100.0 * cum[-1] / population, 1),
    }


def sim_vaccination_metrics(seirv: np.ndarray, population: int) -> dict:
    """Sim V-curve counterpart of :func:`vaccination_rollout_metrics`."""
    v = np.asarray(seirv)[:, 4].astype(float)
    daily = np.diff(v, prepend=0)
    n_days = -(-len(daily) // 24)
    padded = np.zeros(n_days * 24)
    padded[: len(daily)] = daily
    per_day = padded.reshape(n_days, 24).sum(axis=1)
    half_idx = np.flatnonzero(v >= 0.5 * population)
    return {
        "peak_daily_per_100k": round(1e5 * per_day.max() / population, 1),
        "days_to_50pct": (
            int(half_idx[0] // 24) if len(half_idx) else None
        ),
        "final_uptake_pct": round(100.0 * v[-1] / population, 1),
    }

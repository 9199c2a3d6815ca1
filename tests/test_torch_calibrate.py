"""The port's calibration, its real-data comparators and the CLI's
``--calibrate`` against the JAX package's, on the CPU.

The JAX reference runs its packed engine under ``SimConfig(
use_fused_citizen=True, use_pallas_scans=True)`` (Pallas kernels in
interpret mode), as in ``tests/test_torch_packed.py``.  The target is a
``global_stats.json`` that the port itself writes, from a run of the same
world at a known exposure chance.  Comparisons are exact: equal arrays,
equal dicts, byte-identical files.
"""

import csv
import dataclasses
import json

import numpy as np
import pytest

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import calibrate as j_cal
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.data import realworld as j_rw

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import calibrate as t_cal
from epidemicsimulator_tpu_torch import cli
from epidemicsimulator_tpu_torch.data import realworld as t_rw
from epidemicsimulator_tpu_torch.engine.packed import run_packed_ensemble

# the CLI's synthetic world: --synthetic 2000 --seed 3 (n_oa = 2000 // 300)
N, N_OA, SEED = 2000, 6, 3
MAX_STEPS, CHUNK = 120, 60
BOUNDS, REPLICATES, ROUNDS = (1e-3, 3e-2), 6, 2
KEYS = ("susceptible", "exposed", "infected", "recovered", "vaccinated")


def _write_stats(path, seirv, trailing_zero=True):
    rows = [dict(zip(KEYS, map(int, r)), time_step=i + 1)
            for i, r in enumerate(seirv)]
    if trailing_zero:
        rows.append(dict({k: 0 for k in KEYS}, time_step=len(rows) + 1))
    with open(path, "w") as f:
        json.dump(rows, f)


def _base(cls):
    """covid_v16() (thresholds that a 2,000-citizen epidemic does not
    trip at once) with short disease times, so that 120 hours hold an
    epidemic."""
    v16 = cls.covid_v16()
    return cls(dataclasses.replace(v16.disease, exposed_time=12,
                                   infected_time=48), v16.thresholds)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The base parameters' file and the target: global_stats.json of the
    port's run of the world at chance 0.006."""
    tmp = tmp_path_factory.mktemp("calibrate")
    base = _base(et.Params)
    base.to_json(str(tmp / "params.json"))
    world = et.generate_synthetic_world(N, n_output_areas=N_OA, seed=SEED)
    p = et.Params(dataclasses.replace(base.disease, exposure_chance=0.006),
                  base.thresholds)
    seirv = run_packed_ensemble(
        world, [p], et.SimConfig(max_steps=MAX_STEPS, chunk_size=CHUNK),
        seed=SEED + 1, device="cpu")[0]
    assert seirv[:, 2].max() > 50  # an epidemic to fit
    _write_stats(tmp / "global_stats.json", seirv)
    return str(tmp / "params.json"), str(tmp / "global_stats.json")


@pytest.fixture(scope="module")
def jax_result(files):
    """The JAX package's calibrate() on the CLI's world, reference config."""
    cfg = JSimConfig(max_steps=MAX_STEPS, chunk_size=CHUNK,
                     use_fused_citizen=True, use_pallas_scans=True)
    return j_cal.calibrate(
        j_world(N, n_output_areas=N_OA, seed=SEED), _base(JParams), cfg,
        j_cal.load_target_series(files[1]), param="exposure_chance",
        bounds=BOUNDS, replicates=REPLICATES, rounds=ROUNDS, seed=SEED,
        verbose=False)


def test_calibrate_matches_jax(files, jax_result):
    """Two rounds of six candidates: the value, the candidates, the scores
    and every score component, exactly."""
    world = et.generate_synthetic_world(N, n_output_areas=N_OA, seed=SEED)
    target = files[1]
    got = t_cal.calibrate(
        world, _base(et.Params), et.SimConfig(max_steps=MAX_STEPS,
                                              chunk_size=CHUNK),
        t_cal.load_target_series(target), param="exposure_chance",
        bounds=BOUNDS, replicates=REPLICATES, rounds=ROUNDS, seed=SEED,
        verbose=False, device="cpu")
    assert got == jax_result
    assert len(got["rounds"]) == ROUNDS
    # the fit lands next to the target's own chance
    assert 0.003 <= got["value"] <= 0.012


def test_cli_calibrate_writes_the_jax_result(files, jax_result, tmp_path,
                                             capsys):
    out = tmp_path / "cal.json"
    rc = cli.main([
        "cal", "--synthetic", str(N), "--seed", str(SEED),
        "--calibrate", files[1], "--params-file", files[0],
        "--calibrate-range", f"{BOUNDS[0]},{BOUNDS[1]}",
        "--calibrate-replicates", str(REPLICATES),
        "--calibrate-rounds", str(ROUNDS),
        "--max-steps", str(MAX_STEPS), "--chunk-size", str(CHUNK),
        "--device", "cpu", "--directory", str(tmp_path / "none"),
        "--output-name", str(out)])
    assert rc == 0
    assert out.read_text() == json.dumps(jax_result, indent=1)
    assert "calibrated exposure_chance" in capsys.readouterr().out


def test_cli_calibrate_param_file_and_threshold_param(tmp_path):
    """``--params-file`` is the base, and a threshold can be the
    parameter; an unknown one is refused."""
    seirv = np.zeros((30, 5), np.int64)
    seirv[:, 0], seirv[:, 2] = 190, 10
    target = tmp_path / "t.json"
    _write_stats(target, seirv)
    params = tmp_path / "p.json"
    et.Params.covid_v16().to_json(str(params))
    out = tmp_path / "cal.json"
    argv = ["cal", "--synthetic", "200", "--calibrate", str(target),
            "--params-file", str(params), "--calibrate-param", "lockdown",
            "--calibrate-range", "0.1,0.5", "--calibrate-replicates", "2",
            "--calibrate-rounds", "1", "--max-steps", "24",
            "--chunk-size", "24", "--device", "cpu",
            "--directory", str(tmp_path / "none"), "--output-name", str(out)]
    assert cli.main(argv) == 0
    result = json.loads(out.read_text())
    assert result["param"] == "lockdown"
    assert result["rounds"][0]["candidates"][0] == pytest.approx(0.1)
    argv[argv.index("lockdown")] = "bogus"
    with pytest.raises(ValueError, match="bogus"):
        cli.main(argv)


def test_load_target_series_and_score_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    series = rng.integers(0, 500, (80, 5))
    target = rng.integers(0, 500, (70, 5))
    target[-1] = 0  # the last row of zeros is dropped, and only one
    for trailing in (True, False):
        path = tmp_path / f"t{trailing}.json"
        _write_stats(path, target, trailing_zero=trailing)
        got = t_cal.load_target_series(str(path))
        want = j_cal.load_target_series(str(path))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert len(got) == (70 if trailing else 69)
    for s, t in ((series, target), (series[:10], target), (target, series)):
        assert t_cal.score_against_target(s, t) == j_cal.score_against_target(s, t)
    base = et.Params.covid()
    assert t_cal._with_param(base, "exposure_chance", 0.01).disease.exposure_chance == 0.01
    assert t_cal._with_param(base, "lockdown", 0.2).thresholds.lockdown == 0.2
    with pytest.raises(ValueError):
        t_cal._with_param(base, "bogus", 1.0)


# --- realworld ------------------------------------------------------------


def _gov_uk_csvs(tmp_path):
    """A cases file and a vaccinations file as the dashboard writes them:
    space-padded names and values, rows out of date order, a blank cell,
    a blank row."""
    rng = np.random.default_rng(4)
    days = [f"2021-{1 + i // 28:02d}-{1 + i % 28:02d}" for i in range(150)]
    order = rng.permutation(len(days))
    cases = tmp_path / "cases.csv"
    with open(cases, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["areaCode ", "areaName  ", "areaType ", "date      ",
                    "newCasesBySpecimenDate "])
        for k, i in enumerate(order):
            value = "" if k == 7 else f" {int(50 + 40 * np.sin(i / 20) + rng.integers(0, 20))} "
            w.writerow([" E06000014", "York ", " ltla", f"{days[i]}  ", value])
            if k == 30:
                w.writerow(["", "  ", "", "", ""])
    vax = tmp_path / "vaccinations.csv"
    cum = np.cumsum(rng.integers(500, 2500, len(days)))
    with open(vax, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["areaCode", " date ",
                    " cumPeopleVaccinatedFirstDoseByVaccinationDate "])
        for i in order:
            w.writerow(["E06000014 ", days[i], f"{cum[i]} "])
    return str(cases), str(vax)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_realworld_matches_jax(tmp_path):
    cases, vax = _gov_uk_csvs(tmp_path)
    for fn, path in (("load_gov_uk_csv", cases), ("load_gov_uk_csv", vax),
                     ("daily_cases", cases), ("daily_first_doses", vax)):
        _assert_same(getattr(t_rw, fn)(path), getattr(j_rw, fn)(path))
    table = t_rw.load_gov_uk_csv(cases)
    assert list(table["date"]) == sorted(table["date"])
    assert np.isnan(table["newCasesBySpecimenDate"]).sum() == 1
    assert set(table["areaName"]) == {"York"}

    dates, daily = t_rw.daily_cases(cases)
    pop = t_rw.YORK_POPULATION_2011
    assert pop == j_rw.YORK_POPULATION_2011
    rng = np.random.default_rng(5)
    seirv = np.cumsum(rng.integers(0, 30, (500, 5)), axis=0)
    for window in (30, 120, 400):
        _assert_same(t_rw.largest_wave(dates, daily, window_days=window),
                     j_rw.largest_wave(dates, daily, window_days=window))
    _assert_same(t_rw.sim_daily_incidence(seirv), j_rw.sim_daily_incidence(seirv))
    _assert_same(t_rw.wave_metrics(daily, pop), j_rw.wave_metrics(daily, pop))
    _assert_same(t_rw.wave_metrics(np.zeros(5), pop),
                 j_rw.wave_metrics(np.zeros(5), pop))
    for kw in ({}, dict(infected_time=48, ascertainment=0.4),
               dict(infected_time=10_000)):
        _assert_same(t_rw.target_from_daily_cases(daily, pop, **kw),
                     j_rw.target_from_daily_cases(daily, pop, **kw))
    v_dates, cum = t_rw.daily_first_doses(vax)
    for p in (pop, 1000):
        _assert_same(t_rw.vaccination_rollout_metrics(v_dates, cum, p),
                     j_rw.vaccination_rollout_metrics(v_dates, cum, p))
        _assert_same(t_rw.sim_vaccination_metrics(seirv, p),
                     j_rw.sim_vaccination_metrics(seirv, p))

"""The port's run layer against the JAX package's, on the CPU: the
census-like world, the world and parameter files, the recorder, the
Simulator, checkpoints and the CLI.

The JAX reference is its Simulator on the main-path formulation,
``SimConfig(use_fused_citizen=True, use_pallas_scans=True)``, its Pallas
kernels in interpret mode (as in ``tests/test_torch_slice.py``).  Every
comparison is bitwise: equal arrays, or byte-identical files.  Under
``covid_v16()`` that holds as long as no uniform draw falls between
torch's and XLA's float32 probabilities (``tests/test_torch_slice.py``
says why); in these runs none does.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu.engine import checkpoint as j_checkpoint
from epidemicsimulator_tpu.engine.scan import run as j_run
from epidemicsimulator_tpu.engine.simulator import Simulator as JSimulator
from epidemicsimulator_tpu.engine.state import init_state as j_init
from epidemicsimulator_tpu.stats.recorder import StatisticsRecorder as JRecorder
from epidemicsimulator_tpu.world.census_like import (
    generate_census_like_world as j_census_like,
)
from epidemicsimulator_tpu.world.geometry import WorldGeometry as JWorldGeometry
from epidemicsimulator_tpu.world.schema import World as JWorld

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import cli
from epidemicsimulator_tpu_torch.engine import checkpoint as t_checkpoint
from epidemicsimulator_tpu_torch.engine.state import unpack_sched
from epidemicsimulator_tpu_torch.engine.step import StepOutput
from epidemicsimulator_tpu_torch.stats.recorder import StatisticsRecorder
from epidemicsimulator_tpu_torch.world.geometry import WorldGeometry as TWorldGeometry

N, N_OA, WORLD_SEED, SIM_SEED = 5000, 16, 42, 1
MAX_STEPS, CHUNK = 96, 24
J_CFG = JSimConfig(use_fused_citizen=True, use_pallas_scans=True,
                   max_steps=MAX_STEPS, chunk_size=CHUNK)
T_CFG = et.SimConfig(max_steps=MAX_STEPS, chunk_size=CHUNK)
ARTIFACTS = ("global_stats.json", "exposures.json")
SCHED = ("at_work", "on_bus", "bus_to_work", "at_work_ws", "on_bus_ws")


def _deterministic(params_cls):
    """Every draw probability 0, 1 or NaN (masks off); the epidemic ends,
    by vaccination and recovery, at step 92 of 96, and the lockdown goes
    on and off twice on the way."""
    base = params_cls.covid()
    return params_cls(
        dataclasses.replace(base.disease, exposure_chance=1.0, exposed_time=4,
                            infected_time=8, vaccination_rate=400),
        dataclasses.replace(base.thresholds, lockdown=0.1, vaccination=0.02,
                            mask_public_transport=2.0, mask_everywhere=2.0),
    )


PARAMS = {
    "covid_v16": (JParams.covid_v16(), et.Params.covid_v16()),
    "deterministic": (_deterministic(JParams), _deterministic(et.Params)),
}


@pytest.fixture(scope="module")
def worlds():
    return (j_census_like(N, N_OA, seed=WORLD_SEED),
            et.generate_census_like_world(N, N_OA, seed=WORLD_SEED))


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("ESUCD_NO_COMPILE_CACHE", "1")


def _transitions(text):
    return [line for line in text.splitlines()
            if line.startswith(("Lockdown is", "Mask wearing"))]


def _read(directory, name):
    with open(os.path.join(directory, name), "rb") as f:
        return f.read()


def _assert_lanes_equal(a, b, names):
    for name in names:
        np.testing.assert_array_equal(np.asarray(a[name]), np.asarray(b[name]), name)


# (a) ---------------------------------------------------------------------
@pytest.mark.parametrize("n,n_oa,seed", [(3000, 12, 42), (20_000, 64, 43)])
def test_census_like_world_matches_jax(n, n_oa, seed):
    """Mega sites on (the default): every lane and static equal, dtypes too."""
    jw = j_census_like(n, n_oa, seed=seed)
    tw = et.generate_census_like_world(n, n_oa, seed=seed)
    assert tw.lane_names() == [f.name for f in dataclasses.fields(jw)
                               if not f.metadata.get("static")
                               and getattr(jw, f.name) is not None]
    for name in tw.lane_names():
        a, b = np.asarray(getattr(jw, name)), getattr(tw, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, name)
    for name in ("n_buildings", "n_rooms", "n_output_areas", "max_household_size"):
        assert getattr(tw, name) == getattr(jw, name), name


# (b) ---------------------------------------------------------------------
def test_world_npz_both_ways(worlds, tmp_path):
    """A world cached by either package loads in the other: equal lanes,
    dtypes and statics; the port saves a world whose lanes are tensors."""
    jw, tw = worlds
    j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jw.save_npz(j_path)
    tw.to("cpu").save_npz(t_path)
    for loaded, ref in ((et.World.load_npz(j_path), tw),
                        (JWorld.load_npz(t_path), tw)):
        for name in tw.lane_names():
            a = np.asarray(getattr(loaded, name))
            assert a.dtype == getattr(ref, name).dtype, name
            np.testing.assert_array_equal(a, getattr(ref, name), name)
        for name in ("n_buildings", "n_rooms", "n_output_areas",
                     "max_household_size"):
            assert getattr(loaded, name) == getattr(ref, name), name
    with np.load(j_path) as a, np.load(t_path) as b:
        assert sorted(a.files) == sorted(b.files)


def test_params_json_both_ways(tmp_path):
    j_path, t_path = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    for jp, tp in PARAMS.values():
        jp.to_json(j_path)
        tp.to_json(t_path)
        assert _read(tmp_path, "j.json") == _read(tmp_path, "t.json")
        assert et.Params.from_json(j_path) == tp
        assert JParams.from_json(t_path) == jp
    with open(t_path, "w") as f:
        json.dump({"disease": {"exposure_chance": 0.01}}, f)
    assert et.Params.from_json(t_path) == et.Params(
        dataclasses.replace(et.Params().disease, exposure_chance=0.01))


# (c) ---------------------------------------------------------------------
@pytest.mark.parametrize("truncate", [None, 70])
def test_recorder_files_byte_identical(tmp_path, truncate):
    """The same three chunks into both recorders; some OA series all zero
    (left out of exposures.json), and oa_codes given or not."""
    rng = np.random.default_rng(9)
    chunks = []
    for _ in range(3):
        oa = rng.integers(0, 4, (30, 7)).astype(np.int16)
        oa[:, 2] = 0
        chunks.append(StepOutput(
            seirv=rng.integers(0, 10_000, (30, 5)).astype(np.int32),
            exposures_per_oa=oa,
            n_bus_exposures=rng.integers(0, 5, 30).astype(np.int32),
            n_exposures=rng.integers(0, 50, 30).astype(np.int32),
            lockdown=np.zeros(30, bool), mask_status=np.zeros(30, np.int8),
            n_vaccinated_now=np.zeros(30, np.int32),
        ))
    for codes in (None, [f"E{i:08d}" for i in range(7)]):
        recorders = {"j": JRecorder(oa_codes=codes),
                     "t": StatisticsRecorder(oa_codes=codes, device="cpu")}
        for key, rec in recorders.items():
            rec.start_chunk()
            for out in chunks:
                rec.record_chunk(out)
            if truncate:
                rec.truncate(truncate)
            rec.dump_to_file(str(tmp_path / key))
        steps = truncate or 90
        for name in ARTIFACTS:
            assert _read(tmp_path / "t", name) == _read(tmp_path / "j", name), name
        for name in ("timings.json", "memory.json"):
            assert len(json.loads(_read(tmp_path / "t", name))) == steps
        assert len(json.loads(_read(tmp_path / "t", "global_stats.json"))) == steps + 1


# (d) ---------------------------------------------------------------------
@pytest.mark.parametrize("regime", list(PARAMS))
def test_simulator_matches_jax(worlds, tmp_path, capsys, regime):
    """Four chunks of 24: covid_v16() for all 96 steps; the deterministic
    regime ends at step 92.  Same artifacts, SEIRV and transition lines."""
    jw, tw = worlds
    jp, tp = PARAMS[regime]
    j_seirv = JSimulator(jw, jp, J_CFG, seed=SIM_SEED).simulate(str(tmp_path / "j"))
    j_lines = _transitions(capsys.readouterr().out)
    t_seirv = et.Simulator(tw, tp, T_CFG, seed=SIM_SEED,
                           device="cpu").simulate(str(tmp_path / "t"))
    t_lines = _transitions(capsys.readouterr().out)
    np.testing.assert_array_equal(t_seirv, np.asarray(j_seirv))
    for name in ARTIFACTS:
        assert _read(tmp_path / "t", name) == _read(tmp_path / "j", name), name
    assert t_lines == j_lines
    if regime == "deterministic":
        assert len(t_seirv) == 92 and len(t_lines) == 4
    else:
        assert len(t_seirv) == MAX_STEPS and t_seirv[-1, 1:3].sum() > 0


# (e) ---------------------------------------------------------------------
def _j_straight_run(jw, jp, save_at=None, path=None):
    """The JAX run the Simulator makes, with a JAX save_state after
    ``save_at`` steps."""

    def callback(steps_done, out, state):
        if steps_done == save_at:
            j_checkpoint.save_state(path, state)

    state = j_init(jw, seed=SIM_SEED, starting_infected=J_CFG.starting_infected)
    _, out = j_run(jw.device_put(), jp.as_arrays(), J_CFG, state,
                   callback=callback, overlap=False)
    return np.asarray(out.seirv)


def test_jax_checkpoint_resumes_in_port(worlds, tmp_path):
    """A JAX checkpoint after 2 chunks, resumed by the port's Simulator,
    continues as the JAX straight run does (the JAX-only lanes in it,
    the replicated-order twins, are dropped)."""
    jw, tw = worlds
    jp, tp = PARAMS["covid_v16"]
    path = str(tmp_path / "ckpt.npz")
    j_seirv = _j_straight_run(jw, jp, save_at=2 * CHUNK, path=path)
    with np.load(path) as z:
        assert z["status_ws"].shape == (N,)  # not (0,): dropped all the same
    sim = et.Simulator(tw, tp, et.SimConfig(max_steps=2 * CHUNK, chunk_size=CHUNK),
                       seed=SIM_SEED, checkpoint_path=path, device="cpu")
    assert sim.state.hour == 2 * CHUNK
    np.testing.assert_array_equal(sim.simulate(), j_seirv[2 * CHUNK:])


def test_port_checkpoint_loads_in_jax(worlds, tmp_path):
    """A port checkpoint after 2 chunks: JAX load_state gives the port's
    lanes, scalars and key data; the recorder's rows come along."""
    _, tw = worlds
    path = str(tmp_path / "ckpt.npz")
    sim = et.Simulator(tw, PARAMS["covid_v16"][1],
                       et.SimConfig(max_steps=2 * CHUNK, chunk_size=CHUNK),
                       seed=SIM_SEED, checkpoint_path=path,
                       checkpoint_every_chunks=2, device="cpu", verbose=False)
    seirv = sim.simulate()
    st, rows = j_checkpoint.load_state(path)
    port = {"status": sim.state.status, "timer": sim.state.timer,
            "eligible": sim.state.eligible, **unpack_sched(sim.state.sched)}
    jax_lanes = {name: getattr(st, name) for name in port}
    _assert_lanes_equal(jax_lanes, {k: v.numpy() for k, v in port.items()},
                        list(port))
    assert np.asarray(st.timer).dtype == np.int32
    assert int(st.hour) == sim.state.hour == 2 * CHUNK
    assert bool(st.lockdown) == sim.state.lockdown
    assert bool(st.vaccination_started) == sim.state.vaccination_started
    assert int(st.mask_status) == sim.state.mask_status
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(st.rng_key)),
                                  np.asarray(sim.state.rng_key, np.uint32))
    np.testing.assert_array_equal(rows, seirv)
    with np.load(path) as z:
        assert z["vax_pool"].shape == (0,) and z["sched"].shape == (0,)


def test_port_checkpoint_resume_equals_straight_run(worlds, tmp_path):
    """Checkpoint every 2 chunks, then a new Simulator resumes from the
    file: its 48 steps are steps 49-96 of the straight run, and its
    outputs carry none of the checkpoint's rows."""
    _, tw = worlds
    tp = PARAMS["covid_v16"][1]
    half = et.SimConfig(max_steps=2 * CHUNK, chunk_size=CHUNK)
    straight = et.Simulator(tw, tp, T_CFG, seed=SIM_SEED, device="cpu",
                            verbose=False).simulate()
    path = str(tmp_path / "ckpt.npz")
    first = et.Simulator(tw, tp, half, seed=SIM_SEED, checkpoint_path=path,
                         checkpoint_every_chunks=2, device="cpu",
                         verbose=False).simulate()
    resumed = et.Simulator(tw, tp, half, seed=SIM_SEED, checkpoint_path=path,
                           device="cpu", verbose=False)
    second = resumed.simulate(str(tmp_path / "out"))
    np.testing.assert_array_equal(np.concatenate([first, second]), straight)
    stats = json.loads(_read(tmp_path / "out", "global_stats.json"))
    assert len(stats) == 2 * CHUNK + 1


def test_checkpoint_with_vax_pool_is_refused(tmp_path):
    """A state that carries the fixed-priority pool makes the round trip:
    a JAX-layout file with a pool loads into the port with that pool, the
    port writes it back unchanged, and the JAX package reads the port's
    file with the same pool; a file whose pool is off loads with a (0,)
    pool."""
    path = str(tmp_path / "ckpt.npz")
    arrays = {name: np.zeros(4, bool) for name in SCHED}
    arrays.update(status=np.zeros(4, np.int8), timer=np.zeros(4, np.int32),
                  eligible=np.array([True, False, True, True]),
                  hour=np.int32(3), lockdown=np.bool_(False),
                  vaccination_started=np.bool_(True), mask_status=np.int8(0),
                  rng_key_data=np.zeros(2, np.uint32),
                  vax_pool=np.array([0, 2, 3, 1], np.int32),
                  vax_pool_size=np.int32(3))
    np.savez(path, **arrays)
    state, rows = t_checkpoint.load_state(path, device="cpu")
    assert state.hour == 3 and state.vaccination_started and rows is None
    assert state.vax_pool.dtype == torch.int32 and state.vax_pool_size.shape == ()
    np.testing.assert_array_equal(state.vax_pool.numpy(), arrays["vax_pool"])
    assert int(state.vax_pool_size) == 3
    back = str(tmp_path / "back.npz")
    t_checkpoint.save_state(back, state)
    with np.load(back) as z:
        np.testing.assert_array_equal(z["vax_pool"], arrays["vax_pool"])
        assert z["vax_pool"].dtype == np.int32
        assert z["vax_pool_size"].dtype == np.int32 and int(z["vax_pool_size"]) == 3
    j_state, _ = j_checkpoint.load_state(back)
    np.testing.assert_array_equal(np.asarray(j_state.vax_pool), arrays["vax_pool"])
    assert int(j_state.vax_pool_size) == 3
    arrays["vax_pool"] = np.zeros(0, np.int32)
    del arrays["vax_pool_size"]
    np.savez(path, **arrays)
    state, _ = t_checkpoint.load_state(path, device="cpu")
    assert state.vax_pool.shape == (0,) and int(state.vax_pool_size) == 0


# (f) ---------------------------------------------------------------------
def _cli_args(tmp_path, out, *extra, n=2000):
    return ["demo", "--synthetic", str(n), "--simulate", "--max-steps", "48",
            "--chunk-size", "24", "--directory", str(tmp_path),
            "--output-name", out, "--seed", "3", "--device", "cpu", *extra]


def test_cli_synthetic_simulate(tmp_path):
    """The artifact contract of the JAX CLI's test, and global_stats.json
    equal to a Simulator run on the cached world, params and seed."""
    out = str(tmp_path / "results")
    assert cli.main(_cli_args(tmp_path, out)) == 0
    stats = json.loads(_read(out, "global_stats.json"))
    assert len(stats) == 49
    assert stats[0]["time_step"] == 1
    assert stats[-1] == {
        "time_step": 49, "susceptible": 0, "exposed": 0, "infected": 0,
        "recovered": 0, "vaccinated": 0,
    }
    keys = ("susceptible", "exposed", "infected", "recovered", "vaccinated")
    assert all(sum(row[k] for k in keys) == 2000 for row in stats[:-1])
    exposures = json.loads(_read(out, "exposures.json"))
    assert set(exposures) == {"All", "OutputArea", "PublicTransport"}
    assert len(exposures["All"]["All"]) == 48
    assert all(len(s) == 48 for s in exposures["OutputArea"].values())
    assert len(json.loads(_read(out, "timings.json"))) == 48
    assert len(json.loads(_read(out, "memory.json"))) == 48
    phases = json.loads(_read(out, "cli_phases.json"))
    assert {"world_load_or_build_s", "sim_init_s", "simulate_s",
            "simulate_loop", "total_s"} <= set(phases)
    world = et.World.load_npz(str(tmp_path / "world_demo.npz"))
    # the geometry sidecar loads alike in both packages (the cache they share)
    geo = str(tmp_path / "geometry_demo.npz")
    mine, theirs = TWorldGeometry.load_npz(geo), JWorldGeometry.load_npz(geo)
    assert mine.codes == theirs.codes and len(mine.ring_starts) == world.n_output_areas + 1
    for field in ("rings", "ring_starts", "b_east", "b_north", "b_classes"):
        np.testing.assert_array_equal(getattr(mine, field), getattr(theirs, field))
    et.Simulator(world, et.Params.covid(), et.SimConfig(max_steps=48, chunk_size=24),
                 seed=3, device="cpu", verbose=False).simulate(str(tmp_path / "sim"))
    assert _read(out, "global_stats.json") == _read(tmp_path / "sim", "global_stats.json")


def test_cli_census_like_params_file_and_cache(tmp_path):
    """--census-like with --params-file builds the census-like world (the
    JAX CLI's cache name), and --use-cache runs the same again from it.
    3,600 citizens: the CLI gives them 12 OAs, room for the 10 mega sites."""
    params = str(tmp_path / "v16.json")
    et.Params.covid_v16().to_json(params)
    outs = [str(tmp_path / f"r{i}") for i in range(2)]
    for out, extra in zip(outs, ([], ["--use-cache"])):
        assert cli.main(_cli_args(tmp_path, out, "--census-like",
                                  "--params-file", params, *extra, n=3600)) == 0
    world = et.World.load_npz(str(tmp_path / "world_demo_censuslike.npz"))
    jw = j_census_like(3600, 12, seed=3)
    np.testing.assert_array_equal(world.work_building, np.asarray(jw.work_building))
    assert _read(outs[0], "global_stats.json") == _read(outs[1], "global_stats.json")


def test_cli_checkpoint_and_resume(tmp_path):
    from epidemicsimulator_tpu_torch.engine.checkpoint import load_state

    out = str(tmp_path / "r1")
    assert cli.main(_cli_args(tmp_path, out, "--checkpoint-every", "24")) == 0
    ckpt = tmp_path / "ckpt_demo.npz"
    st, rows = load_state(str(ckpt), device="cpu")
    assert st.hour == 48 and rows.shape == (48, 5)


def test_cli_without_synthetic_exits_with_a_message(tmp_path):
    """Without --synthetic the CLI builds the world from census files; with
    none in --directory it raises the port's MissingDataError naming the
    first missing table."""
    from epidemicsimulator_tpu_torch.errors import MissingDataError

    with pytest.raises(MissingDataError, match="AgeStructure") as info:
        cli.main(["york", "--simulate", "--directory", str(tmp_path),
                  "--device", "cpu"])
    assert "--synthetic" in str(info.value)


# (g) and no fallback -----------------------------------------------------
def test_simulator_refuses_devices(worlds):
    """The sharded engine runs (tests/test_torch_sharded_runs.py); what it
    refuses: one rank per card on the CPU, and (through ``SimConfig``,
    before any run) the JAX sharded engine's options that are not
    ported."""
    with pytest.raises(ValueError, match="visible card"):
        et.Simulator(worlds[1], devices=0, device="cpu")
    with pytest.raises(NotImplementedError, match="use_sortless_sharded"):
        et.Simulator(worlds[1], et.Params.covid(),
                     et.SimConfig(use_sortless_sharded=True), devices=2,
                     device="cpu")


def test_entry_points_refuse_without_a_card(worlds, tmp_path, monkeypatch):
    """With no CUDA device, the default device is an error, not the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        et.Simulator(worlds[1])
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["demo", "--synthetic", "500", "--simulate",
                  "--directory", str(tmp_path)])
    assert not (tmp_path / "world_demo.npz").exists()


def test_simulator_profile_dir_writes_a_trace(worlds, tmp_path):
    """``profile_dir``: a torch.profiler Chrome trace of the third chunk;
    a run of two chunks, which ends before it, still writes the trace it
    started."""
    for steps, name in ((MAX_STEPS, "full"), (2 * CHUNK, "short")):
        cfg = et.SimConfig(max_steps=steps, chunk_size=CHUNK)
        et.Simulator(worlds[1], PARAMS["covid_v16"][1], cfg, seed=SIM_SEED,
                     profile_dir=str(tmp_path / name), device="cpu",
                     verbose=False).simulate()
        with open(tmp_path / name / "chunk_trace.json") as f:
            assert "traceEvents" in json.load(f)

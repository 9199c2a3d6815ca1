"""The sharded entry points of the port against the JAX package's, on the
CPU: ``Simulator(devices=4)``, the CLI's ``--devices 4 --device cpu``,
checkpoints of a sharded run and ``run_ensemble(devices=4)``.

The JAX side runs on the virtual CPU mesh (tests/conftest.py); the port's
as gloo ranks that ``parallel/launch.py`` starts, this process being rank
0.  Every comparison is bitwise: byte-identical artifacts, equal arrays.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.engine.simulator import Simulator as JSimulator
from epidemicsimulator_tpu.parallel.ensemble_mesh import (
    run_packed_ensemble_sharded as j_ensemble_sharded,
)
from epidemicsimulator_tpu.world.census_like import (
    generate_census_like_world as j_census_like,
)

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge, cli
from epidemicsimulator_tpu_torch.engine import ensemble as t_ensemble

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLI's world for ``--census-like --synthetic N --seed SEED``:
# max(4, N // 300) OAs, the seed for both the world and the run
N, N_OA, SEED = 4800, 16, 3
MAX_STEPS, CHUNK = 96, 24
ARTIFACTS = ("global_stats.json", "exposures.json")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This process is rank 0 beside started ranks that run torch on one
    thread each, and it runs the one-device comparisons: on one thread
    too, so that neither waits on an oversubscribed thread pool when the
    suite runs under xdist (a pool of 8 threads made the 8-replica
    one-device run 60 times slower on a loaded 8-core machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deterministic(params_cls):
    """Every draw probability 0, 1 or NaN (masks off); the lockdown goes
    on and off and vaccination runs (as in test_torch_simulator.py)."""
    base = params_cls.covid()
    return params_cls(
        dataclasses.replace(base.disease, exposure_chance=1.0, exposed_time=4,
                            infected_time=8, vaccination_rate=400),
        dataclasses.replace(base.thresholds, lockdown=0.1, vaccination=0.02,
                            mask_public_transport=2.0, mask_everywhere=2.0),
    )


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("ESUCD_NO_COMPILE_CACHE", "1")


def _read(directory, name):
    with open(os.path.join(directory, name), "rb") as f:
        return f.read()


def _transitions(text):
    return [line for line in text.splitlines()
            if line.startswith(("Lockdown is", "Mask wearing"))]


CKPT_CHUNKS = 3  # the checkpoint holds the state after hour 72


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The census-like world, 96 steps under the deterministic parameters,
    through the JAX Simulator on a 4-device mesh and the port's on 4
    ranks, each checkpointing every CKPT_CHUNKS chunks; returns their
    SEIRV rows, artifact directories, printed transition lines and
    checkpoint files.  The world and the seed are those the CLI makes of
    ``--census-like --synthetic N --seed SEED``, so the port's CLI runs
    are held to the same JAX artifacts."""
    import contextlib
    import io

    tmp = tmp_path_factory.mktemp("sharded_sim")
    out = {}
    for name, sim_cls, world, params, cfg, kw in (
        ("jax", JSimulator, j_census_like(N, N_OA, seed=SEED),
         _deterministic(JParams),
         JSimConfig(max_steps=MAX_STEPS, chunk_size=CHUNK), {}),
        ("torch", et.Simulator,
         et.generate_census_like_world(N, N_OA, seed=SEED),
         _deterministic(et.Params),
         et.SimConfig(max_steps=MAX_STEPS, chunk_size=CHUNK),
         {"device": "cpu"}),
    ):
        text = io.StringIO()
        ckpt = str(tmp / f"{name}.npz")
        with contextlib.redirect_stdout(text):
            seirv = sim_cls(world, params, cfg, seed=SEED, devices=4,
                            checkpoint_path=ckpt,
                            checkpoint_every_chunks=CKPT_CHUNKS,
                            **kw).simulate(str(tmp / name) + os.sep)
        out[name] = (np.asarray(seirv), tmp / name, text.getvalue(), ckpt)
    return out


def test_sharded_simulator_artifacts_match_jax(runs):
    """``global_stats.json`` and ``exposures.json`` byte-identical, the
    same SEIRV rows and the same intervention lines."""
    (j_seirv, j_dir, j_text, _), (t_seirv, t_dir, t_text, _) = (
        runs["jax"], runs["torch"])
    np.testing.assert_array_equal(t_seirv, j_seirv)
    for name in ARTIFACTS:
        assert _read(t_dir, name) == _read(j_dir, name), name
    assert _transitions(t_text) == _transitions(j_text)
    assert any("lifted" in line for line in _transitions(t_text))
    assert "population-sharded engine over 4 rank(s)" in t_text
    assert '"comm": "gloo"' in t_text
    assert t_seirv[:, 4].max() > 0  # vaccination ran


def test_sharded_checkpoint_matches_jax_and_resumes(runs):
    """The 4-rank run's checkpoint after hour 72 holds the JAX package's
    sharded checkpoint, lane for lane, in the padded shard layout; a
    Simulator resumed from it steps up to ``max_steps`` (the sharded loop
    counts from the state's hour) and gives the uninterrupted run's rows
    from hour 73 on."""
    ckpts = {}
    for name in ("jax", "torch"):
        with np.load(runs[name][3]) as data:
            ckpts[name] = {k: data[k] for k in data.files}
    j, t = ckpts["jax"], ckpts["torch"]
    for key in ("status", "timer", "eligible", "at_work", "on_bus",
                "bus_to_work", "at_work_ws", "on_bus_ws", "hour", "lockdown",
                "vaccination_started", "mask_status", "rng_key_data",
                "vax_pool", "vax_pool_size", "__seirv__"):
        assert t[key].shape == j[key].shape, key
        np.testing.assert_array_equal(t[key], j[key], key)
    assert t["status"].shape[0] > N  # the padded layout
    hour = CKPT_CHUNKS * CHUNK
    assert int(t["hour"]) == hour
    resumed = et.Simulator(
        et.generate_census_like_world(N, N_OA, seed=SEED),
        _deterministic(et.Params),
        et.SimConfig(max_steps=MAX_STEPS, chunk_size=CHUNK), seed=SEED,
        devices=4, verbose=False, checkpoint_path=runs["torch"][3],
        device="cpu")
    assert resumed.state.hour == hour
    np.testing.assert_array_equal(resumed.simulate(),
                                  runs["torch"][0][hour:])


def test_sharded_cli_matches_jax(runs, tmp_path):
    """The CLI's ``--devices 4 --device cpu`` on the census-like world with
    the deterministic parameters in a ``--params-file``, its ranks started
    by ``parallel/launch.py`` and, as under ``torchrun``, as four
    processes whose environment names each one's rank and the rendezvous
    (rank 0 writes the artifacts, the others nothing): the artifacts
    byte-identical to the JAX ``Simulator(devices=4)``'s on the same
    world, seed and parameters."""
    params = tmp_path / "params.json"
    _deterministic(et.Params).to_json(str(params))
    args = ["york", "--census-like", "--synthetic", str(N), "--simulate",
            "--seed", str(SEED), "--max-steps", str(MAX_STEPS),
            "--chunk-size", str(CHUNK), "--params-file", str(params),
            "--devices", "4", "--device", "cpu"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    jdir, tdir = runs["jax"][1], tmp_path / "torch"
    assert cli.main(args + ["--output-name", str(tdir),
                            "--directory", str(tmp_path / "t")]) == 0
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "epidemicsimulator_tpu_torch.cli", *args,
         "--directory", str(tmp_path / "none"),
         "--output-name", str(tmp_path / f"rank{r}")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for r in range(4)]
    try:
        assert [p.wait(timeout=300) for p in procs] == [0] * 4
    finally:
        for p in procs:
            p.kill()
    for name in ARTIFACTS:
        assert _read(tdir, name) == _read(jdir, name), name
        assert _read(tmp_path / "rank0", name) == _read(jdir, name), name
    assert not any((tmp_path / f"rank{r}").exists() for r in (1, 2, 3))
    with open(tdir / "cli_phases.json") as f:
        assert "simulate_s" in json.load(f)


def test_sharded_ensemble_matches_jax_and_the_packing():
    """``run_ensemble(devices=4)``: 8 replicas of a 4,096-citizen world
    equal the JAX ``run_packed_ensemble_sharded`` on 4 devices and the
    port's one-device packing under id-keyed RNG; an uneven split
    raises."""
    base = JParams.covid()
    sweep = [JParams(dataclasses.replace(base.disease,
                                         exposure_chance=0.01 + 0.005 * r,
                                         vaccination_rate=64),
                     dataclasses.replace(base.thresholds, lockdown=0.02,
                                         vaccination=0.005))
             for r in range(8)]
    tsweep = [bridge.params_from_values(dataclasses.asdict(p.disease),
                                        dataclasses.asdict(p.thresholds))
              for p in sweep]
    kw = dict(max_steps=48, chunk_size=24, starting_infected=40)
    want = np.asarray(j_ensemble_sharded(
        j_world(4096, n_output_areas=8, seed=5), sweep,
        JSimConfig(id_keyed_ensemble_rng=True, **kw), n_devices=4, seed=2))
    tw = et.generate_synthetic_world(4096, n_output_areas=8, seed=5)
    got = t_ensemble.run_ensemble(tw, tsweep, et.SimConfig(**kw), seed=2,
                                  devices=4, device="cpu")
    packed = t_ensemble.run_ensemble(
        tw, tsweep, et.SimConfig(id_keyed_ensemble_rng=True, **kw), seed=2,
        device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, packed)
    assert got.shape == (8, 48, 5)
    assert (got.sum(axis=2) == 4096).all()
    assert got[:, -1, 4].min() > 0  # every replica vaccinated
    with pytest.raises(ValueError, match="do not divide"):
        t_ensemble.run_ensemble(tw, tsweep[:6], et.SimConfig(**kw),
                                devices=4, device="cpu")

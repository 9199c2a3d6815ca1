"""The fixed-priority vaccination pool (``SimConfig.vaccination_fixed_
priority``) against the JAX package's, on the CPU.

The reference is the JAX package's main-path formulation,
``SimConfig(use_fused_citizen=True, use_pallas_scans=True)``, with the
pool on; the port steps from the same state (carried across by
``bridge``) on the same 20,000-citizen world.  After every step the
SEIRV row, the counts, the status, timer, eligible and schedule lanes,
``vax_pool`` and ``vax_pool_size`` are compared bitwise.

Each case shows from the JAX run itself which of the pool's branches ran:
the rebuild when vaccination starts (``vax_pool_size`` leaves 0), the
rebuild when the live pool halves (``vax_pool_size`` changes again), and
the fresh-threshold fallback (the JAX run's own pool, eligible lane and
threefry draws give fewer than k distinct live ids).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.config import STATUS_VACCINATED
from epidemicsimulator_tpu.engine import checkpoint as j_checkpoint
from epidemicsimulator_tpu.engine.state import init_state as j_init
from epidemicsimulator_tpu.engine.step import step as j_step

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge
from epidemicsimulator_tpu_torch.engine import checkpoint as t_checkpoint
from epidemicsimulator_tpu_torch.engine import fastpath as t_fastpath
from epidemicsimulator_tpu_torch.engine.state import unpack_sched

N, N_OA, WORLD_SEED, SIM_SEED = 20_000, 12, 1, 7
DRAWS = 8192
LANES = ("status", "timer", "eligible", "vax_pool")

#: name -> (params, starting infected, steps, faithful_vaccine_bugs)
CASES = {
    # vaccination from step 1; faithful pool quirks keep the pool whole
    "covid": ("covid", 130, 12, True),
    # the intended pool loses each step's vaccinations: it halves, is
    # rebuilt, and ends with fewer live ids than k among the draws
    "covid-intended": ("covid", 130, 16, False),
    # v1.6: 5,100 vaccinations a step once 30% are infected
    "covid_v16": ("covid_v16", 9000, 8, True),
}


def _j_cfg(faithful):
    return JSimConfig(use_fused_citizen=True, use_pallas_scans=True,
                      vaccination_fixed_priority=True,
                      faithful_vaccine_bugs=faithful)


def _t_cfg(faithful):
    return et.SimConfig(vaccination_fixed_priority=True,
                        faithful_vaccine_bugs=faithful)


@functools.lru_cache(maxsize=None)
def _jstep(cfg):
    return jax.jit(lambda w, p, s: j_step(w, p, cfg, s))


def _t_params(jp):
    return bridge.params_from_values(
        dataclasses.asdict(jp.disease), dataclasses.asdict(jp.thresholds))


def _arrays(st):
    names = ("status", "timer", "eligible", "at_work", "on_bus",
             "bus_to_work", "at_work_ws", "on_bus_ws", "hour", "lockdown",
             "vaccination_started", "mask_status", "vax_pool",
             "vax_pool_size")
    out = {k: np.asarray(getattr(st, k)) for k in names}
    out["rng_key"] = np.asarray(jax.random.key_data(st.rng_key))
    return out


@pytest.fixture(scope="module")
def world():
    jw = j_world(N, n_output_areas=N_OA, seed=WORLD_SEED)
    tw = et.generate_synthetic_world(N, n_output_areas=N_OA, seed=WORLD_SEED)
    return jw, tw.to("cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX run of a case: its initial state and (state, output) after
    every step."""
    params, infected, steps, faithful = CASES[case]
    jw = j_world(N, n_output_areas=N_OA, seed=WORLD_SEED)
    jp = getattr(JParams, params)()
    st = j_init(jw, seed=SIM_SEED, starting_infected=infected,
                fixed_priority_vax=True)
    jwd, jpa = jw.device_put(), jp.as_arrays()
    run, s = [], st
    for _ in range(steps):
        s, out = _jstep(_j_cfg(faithful))(jwd, jpa, s)
        run.append((s, out))
    return st, run


def _assert_step(t_state, t_out, j_state, j_out, where):
    np.testing.assert_array_equal(t_out.seirv.numpy(), np.asarray(j_out.seirv),
                                  where)
    np.testing.assert_array_equal(t_out.exposures_per_oa.numpy(),
                                  np.asarray(j_out.exposures_per_oa), where)
    for name in ("n_exposures", "n_bus_exposures", "n_vaccinated_now"):
        assert int(getattr(t_out, name)) == int(getattr(j_out, name)), (name, where)
    ja = _arrays(j_state)
    for name in LANES:
        np.testing.assert_array_equal(getattr(t_state, name).numpy(), ja[name],
                                      f"{name} {where}")
    for name, lane in unpack_sched(t_state.sched).items():
        np.testing.assert_array_equal(lane.numpy(), ja[name], f"{name} {where}")
    assert int(t_state.vax_pool_size) == int(ja["vax_pool_size"]), where
    assert t_state.vaccination_started == bool(ja["vaccination_started"]), where


def _jax_draw(prev, post, rate, faithful):
    """(distinct live ids among the step's draws, k), recomputed from the
    JAX run: its threefry key for the step, the pool it drew from (the
    state after the step holds it) and the eligible lane it drew against
    (the intended pool loses the step's vaccinations after the draw)."""
    key = jax.random.fold_in(prev.rng_key, int(post.hour))
    k_vax = jax.random.split(key, 5)[4]
    u = np.asarray(jax.random.bits(k_vax, (DRAWS,), jnp.uint32)).astype(np.int64)
    pool, size = np.asarray(post.vax_pool), int(post.vax_pool_size)
    elig = np.asarray(post.eligible)
    if not faithful:
        elig = elig | ((np.asarray(post.status) == STATUS_VACCINATED)
                       & (np.asarray(prev.status) != STATUS_VACCINATED))
    size_u = max(size, 1)
    slot = u % size_u
    members = pool[np.minimum(slot, len(pool) - 1)]
    alive = (u >= (2**32 - size_u) % size_u) & (slot < size) & elig[members]
    return len(np.unique(members[alive])), min(rate, int(elig.sum()))


@pytest.mark.parametrize("case", list(CASES))
def test_pool_run_matches_jax(world, case):
    _, tw = world
    params, _, _, faithful = CASES[case]
    st, run = _jax_run(case)
    t_state = bridge.state_from_arrays(_arrays(st), device="cpu")
    tables = t_fastpath.make_step_tables(tw)
    tp = _t_params(getattr(JParams, params)())
    for t, (j_state, j_out) in enumerate(run, 1):
        t_state, t_out = et.step(tw, tp, _t_cfg(faithful), t_state,
                                 tables=tables)
        _assert_step(t_state, t_out, j_state, j_out, f"step {t}")


@pytest.mark.parametrize("case", list(CASES))
def test_pool_branches_taken(case):
    """The branches each case runs, read off the JAX run: every case
    builds its pool the step vaccination starts and takes sampled draws;
    the intended pool is rebuilt when it halves and falls back to the
    fresh threshold selector."""
    params, _, _, faithful = CASES[case]
    rate = getattr(JParams, params)().disease.vaccination_rate
    st, run = _jax_run(case)
    states = [st] + [s for s, _ in run]
    sizes = [int(s.vax_pool_size) for s in states]
    started = [bool(s.vaccination_started) for s in states]
    first = started.index(True)
    assert sizes[:first] == [0] * first and sizes[first] > 0  # built at start
    draws = [_jax_draw(states[t - 1], states[t], rate, faithful)
             for t in range(first, len(states))]
    sampled = [d >= k for d, k in draws]
    vaccinated = [int(out.n_vaccinated_now) for _, out in run][first - 1:]
    assert [v for v, (_, k) in zip(vaccinated, draws)] == [k for _, k in draws]
    rebuilds = [t for t in range(first + 1, len(sizes))
                if sizes[t] != sizes[t - 1]]
    assert sampled[0]
    if faithful:
        assert all(sampled) and not rebuilds
    else:
        # each rebuild at the step where the live pool fell below half
        assert len(rebuilds) >= 2 and not all(sampled)
        for t in rebuilds:
            assert sizes[t] * 2 < sizes[t - 1]


@pytest.mark.parametrize("rule", ["auto at 16M", "forced on"])
def test_step_without_the_pool_lanes_raises(world, rule):
    """Where the config wants the pool and the state has no pool lanes
    (``init_state`` without ``fixed_priority_vax``), the step raises
    rather than vaccinate by the fresh draw: under the auto rule on a
    stand-in world of 16M citizens (no such world is built), and through
    ``run`` with the pool forced on at 20k.  The same state steps under
    ``vaccination_fixed_priority=False``."""
    _, tw = world
    tp = _t_params(JParams.covid())
    state = et.init_state(tw, seed=SIM_SEED, starting_infected=130,
                          device="cpu")
    assert state.vax_pool.shape == (0,)
    with pytest.raises(ValueError, match="fixed_priority_vax"):
        if rule == "auto at 16M":
            stand_in = types.SimpleNamespace(n_citizens=16_000_000,
                                             has_fast_tables=True)
            t_fastpath.fast_step(stand_in, tp, et.SimConfig(), state)
        else:
            et.run(tw, tp, dataclasses.replace(_t_cfg(True), max_steps=2,
                                               chunk_size=2), state)
    _, out = et.step(tw, tp, et.SimConfig(vaccination_fixed_priority=False),
                     state)
    assert int(out.seirv.sum()) == N


def test_jax_checkpoint_with_pool_resumes_in_port(world, tmp_path):
    """A JAX checkpoint after step 8 of the intended case (the pool built
    and rebuilt once), resumed by the port, steps as the JAX run does to
    step 16, through its next rebuilds and the fallback."""
    _, tw = world
    _, run = _jax_run("covid-intended")
    path = str(tmp_path / "ckpt.npz")
    j_checkpoint.save_state(path, run[7][0])
    with np.load(path) as z:
        assert z["vax_pool"].shape == (N,)
    t_state, _ = t_checkpoint.load_state(path, device="cpu")
    tables = t_fastpath.make_step_tables(tw)
    tp = _t_params(JParams.covid())
    for t in range(8, 16):
        t_state, t_out = et.step(tw, tp, _t_cfg(False), t_state, tables=tables)
        _assert_step(t_state, t_out, *run[t], f"step {t + 1}")


def test_port_checkpoint_with_pool_loads_in_jax(world, tmp_path):
    """A port checkpoint after step 10 of the intended case loads in JAX
    with equal lanes, and the JAX package continues from it as its own
    run did."""
    jw, tw = world
    st, run = _jax_run("covid-intended")
    t_state = bridge.state_from_arrays(_arrays(st), device="cpu")
    tables = t_fastpath.make_step_tables(tw)
    tp = _t_params(JParams.covid())
    for _ in range(10):
        t_state, _ = et.step(tw, tp, _t_cfg(False), t_state, tables=tables)
    path = str(tmp_path / "ckpt.npz")
    t_checkpoint.save_state(path, t_state)
    j_state, _ = j_checkpoint.load_state(path)
    for name in LANES:
        np.testing.assert_array_equal(np.asarray(getattr(j_state, name)),
                                      getattr(t_state, name).numpy(), name)
    assert np.asarray(j_state.vax_pool).dtype == np.int32
    assert int(j_state.vax_pool_size) == int(t_state.vax_pool_size) > 0
    jwd, jpa = jw.device_put(), JParams.covid().as_arrays()
    for t in range(10, 16):
        j_state, j_out = _jstep(_j_cfg(False))(jwd, jpa, j_state)
        np.testing.assert_array_equal(np.asarray(j_out.seirv),
                                      np.asarray(run[t][1].seirv), f"step {t + 1}")
    np.testing.assert_array_equal(np.asarray(j_state.vax_pool),
                                  np.asarray(run[15][0].vax_pool))

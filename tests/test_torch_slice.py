"""The port's fused step against the JAX package's, on the CPU.

The reference is ``SimConfig(use_fused_citizen=True,
use_pallas_scans=True)``: the JAX main-path formulation, its Pallas
kernels run in interpret mode.  Both packages start from the same state
(carried across by ``bridge``) on the same world and run free.

* Deterministic regime (exposure_chance = 1, masks off, so every draw
  probability is exactly 0, 1 or NaN): whole trajectories, every lane and
  observable, bitwise.
* ``Params.covid()`` and ``covid_v16()``: the SEIRV, per-OA and count
  series over 48 steps, bitwise.  torch's and XLA's float32
  exp/log/expm1/log1p can differ in the last ulp or two
  (test_torch_ops.py bounds it); a draw would fall the other way only if
  its uniform (a multiple of 2**-24, or 2**-23 on the bus) lay between
  the two probabilities, and in these runs none does.  Such a draw would
  be the one legitimate cause of a difference here.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.config import STATUS_INFECTED
from epidemicsimulator_tpu.engine.scan import run as j_run
from epidemicsimulator_tpu.engine.state import init_state as j_init
from epidemicsimulator_tpu.engine.state import with_status
from epidemicsimulator_tpu.engine.step import step as j_step

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge
from epidemicsimulator_tpu_torch.engine import fastpath as t_fastpath
from epidemicsimulator_tpu_torch.engine.state import unpack_sched

J_CFG = JSimConfig(use_fused_citizen=True, use_pallas_scans=True)


@functools.lru_cache(maxsize=None)
def _jstep(cfg):
    return jax.jit(lambda w, p, s: j_step(w, p, cfg, s))


def _no_transport(world):
    n = world.n_citizens
    return dataclasses.replace(
        world,
        uses_transport=np.zeros(n, bool),
        ws_uses_transport=np.zeros(n, bool),
        rider_perm=np.zeros(0, np.int32),
        rider_route=np.zeros(0, np.int32),
        rider_mask_compliant=np.zeros(0, bool),
    )


def _worlds(n, n_oa, seed, transport=True):
    jw = j_world(n, n_output_areas=n_oa, seed=seed)
    tw = et.generate_synthetic_world(n, n_output_areas=n_oa, seed=seed)
    if not transport:
        jw, tw = _no_transport(jw), _no_transport(tw)
    return jw, tw.to("cpu")


def _state_arrays(st):
    names = ("status", "timer", "eligible", "at_work", "on_bus",
             "bus_to_work", "at_work_ws", "on_bus_ws", "hour", "lockdown",
             "vaccination_started", "mask_status")
    out = {k: np.asarray(getattr(st, k)) for k in names}
    out["rng_key"] = np.asarray(jax.random.key_data(st.rng_key))
    return out


def _t_params(jp):
    return bridge.params_from_values(
        dataclasses.asdict(jp.disease), dataclasses.asdict(jp.thresholds))


def _compare_run(jw, tw, jparams, j_state, steps, t_cfg, lanes=True,
                 j_cfg=J_CFG):
    """Steps both packages from one state; returns the JAX package's last
    StepOutput and the port's bus exposures over the run."""
    tparams = _t_params(jparams)
    t_state = bridge.state_from_arrays(_state_arrays(j_state), device="cpu")
    tables = t_fastpath.make_step_tables(tw)
    jwd, jp = jw.device_put(), jparams.as_arrays()
    n_bus = 0
    for t in range(1, steps + 1):
        j_state, j_out = _jstep(j_cfg)(jwd, jp, j_state)
        t_state, t_out = et.step(tw, tparams, t_cfg, t_state, tables=tables)
        where = f"step {t}"
        np.testing.assert_array_equal(t_out.seirv.numpy(), np.asarray(j_out.seirv), where)
        np.testing.assert_array_equal(t_out.exposures_per_oa.numpy(),
                                      np.asarray(j_out.exposures_per_oa), where)
        assert int(t_out.n_exposures) == int(j_out.n_exposures), where
        assert int(t_out.n_bus_exposures) == int(j_out.n_bus_exposures), where
        n_bus += int(t_out.n_bus_exposures)
        assert int(t_out.n_vaccinated_now) == int(j_out.n_vaccinated_now), where
        assert t_out.lockdown == bool(j_out.lockdown), where
        assert t_out.mask_status == int(j_out.mask_status), where
        if lanes:
            ja = _state_arrays(j_state)
            np.testing.assert_array_equal(t_state.status.numpy(), ja["status"], where)
            np.testing.assert_array_equal(t_state.timer.numpy(), ja["timer"], where)
            np.testing.assert_array_equal(t_state.eligible.numpy(), ja["eligible"], where)
            for name, lane in unpack_sched(t_state.sched).items():
                np.testing.assert_array_equal(lane.numpy(), ja[name], f"{name} {where}")
            assert t_state.vaccination_started == bool(ja["vaccination_started"])
    return j_out, n_bus


@pytest.mark.parametrize("transport,faithful", [
    (False, True), (True, True), (True, False),
])
def test_deterministic_trajectory_bitwise(transport, faithful):
    jw, tw = _worlds(3000, 6, 4, transport)
    base = JParams.covid()
    params = JParams(
        dataclasses.replace(base.disease, exposure_chance=1.0, exposed_time=6,
                            infected_time=12, vaccination_rate=25),
        dataclasses.replace(base.thresholds, lockdown=0.35, vaccination=0.05,
                            mask_public_transport=2.0, mask_everywhere=2.0),
    )
    st = j_init(jw, seed=0, starting_infected=0)
    status0 = np.zeros(jw.n_citizens, np.int8)
    status0[::307] = STATUS_INFECTED
    st = with_status(st, jw, status0)
    out, n_bus = _compare_run(
        jw, tw, params, st, 60, et.SimConfig(faithful_vaccine_bugs=faithful),
        j_cfg=dataclasses.replace(J_CFG, faithful_vaccine_bugs=faithful))
    seirv = np.asarray(out.seirv)
    assert seirv[3] > 100 and seirv[4] > 0  # it spread, and vaccination ran
    assert (n_bus > 0) == transport


@pytest.mark.parametrize("params,infected,flags", [
    pytest.param("covid", 60, {}, id="covid-60"),
    pytest.param("covid", 130, {}, id="covid-130"),
    pytest.param("covid_v16", 200, {}, id="covid_v16-200"),
    pytest.param("covid", 60, {"reference_mask_semantics": False},
                 id="covid-60-mask_semantics_off"),
    pytest.param("covid", 60, {"reference_u8_truncation": False},
                 id="covid-60-u8_truncation_off"),
    pytest.param("covid_v16", 200, {"reference_u8_truncation": False},
                 id="covid_v16-200-u8_truncation_off"),
    pytest.param("covid", 60, {"record_exposures_per_oa": False},
                 id="covid-60-per_oa_off"),
])
def test_series_bitwise(params, infected, flags):
    """20k citizens for 48 steps.  covid(), 60 infected: masks on,
    movement live (work side every work hour).  covid(), 130 infected:
    lockdown and vaccination from the first step.  covid_v16(), 200
    infected: a faster spread with bus exposures.  ``flags`` turns off
    one of the reference's quirks in both packages: the mask semantics
    (masks on a compliant citizen, on transport when masks are only
    required there; with covid() and 60 infected this changes the series)
    or the u8 truncation of infected counts (no count reaches 256 in
    these worlds, so the series stay those of the default, and the case
    holds the flag's path to the JAX package's), or the per-OA series
    (both then record an empty one, and the rest must not change)."""
    jw, tw = _worlds(20_000, 12, 1)
    st = j_init(jw, seed=7, starting_infected=infected)
    out, n_bus = _compare_run(jw, tw, getattr(JParams, params)(), st, 48,
                              et.SimConfig(**flags), lanes=False,
                              j_cfg=dataclasses.replace(J_CFG, **flags))
    if params == "covid_v16":
        assert n_bus > 0
    else:
        assert int(out.mask_status) == 2
        assert bool(out.lockdown) == (infected > 100)
        assert (int(out.n_vaccinated_now) > 0) == (infected > 100)


def test_run_stops_after_first_dead_step():
    """The chunk runner and run against the JAX package's run (overlap
    off): a tiny epidemic that vaccination ends; outputs are cut after the
    first step with no E, I or S, and the per-OA series is int16."""
    jw, tw = _worlds(3000, 6, 4, transport=False)
    base = JParams.covid()
    params = JParams(
        dataclasses.replace(base.disease, exposure_chance=1.0, exposed_time=2,
                            infected_time=3, vaccination_rate=600),
        dataclasses.replace(base.thresholds, vaccination=0.0,
                            mask_public_transport=2.0, mask_everywhere=2.0),
    )
    j_cfg = dataclasses.replace(J_CFG, max_steps=96, chunk_size=12)
    st = j_init(jw, seed=3, starting_infected=5)
    t_state = bridge.state_from_arrays(_state_arrays(st), device="cpu")
    j_final, j_out = j_run(jw.device_put(), params, j_cfg, st, overlap=False)
    t_cfg = et.SimConfig(max_steps=96, chunk_size=12)
    t_final, t_out = et.run(tw, _t_params(params), t_cfg, t_state)
    assert t_out.seirv.shape[0] < 96
    for name in t_out._fields:
        np.testing.assert_array_equal(getattr(t_out, name),
                                      np.asarray(getattr(j_out, name)), name)
    assert t_out.exposures_per_oa.dtype == np.int16
    np.testing.assert_array_equal(t_final.status.numpy(),
                                  np.asarray(j_final.status))

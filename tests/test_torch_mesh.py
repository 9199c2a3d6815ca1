"""The port's portable sharded engine (``parallel/mesh.py``) against the
JAX package's, on the CPU.

The JAX side runs ``run_sharded`` on the virtual CPU mesh
(tests/conftest.py); the port's side runs as gloo ranks that
``parallel/launch.py`` starts (this process is rank 0), with the plain
versions.  Every comparison is bitwise: the padding lane for lane, and
whole runs' SEIRV, per-OA, exposure, bus-exposure, lockdown, mask and
vaccination series and final lanes.  The runs have transport (the
lockdown off, so riders board every day and the per-rank route-key bus
branch runs) and a citizen count that the ranks do not divide.  Outside
the deterministic regime that holds as long as no uniform draw falls
between torch's and XLA's float32 probabilities
(``tests/test_torch_portable.py`` says why); in these runs none does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.engine.state import init_state as j_init
from epidemicsimulator_tpu.parallel import mesh as j_mesh

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge
from epidemicsimulator_tpu_torch.engine.state import unpack_sched
from epidemicsimulator_tpu_torch.parallel import mesh

OUTPUTS = ("seirv", "exposures_per_oa", "n_exposures", "n_bus_exposures",
           "lockdown", "mask_status", "n_vaccinated_now")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This process is rank 0 beside started ranks that run torch on one
    thread each (``tests/test_torch_fastmesh.py`` says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    base = JParams.covid()
    jp = JParams(
        dataclasses.replace(base.disease, exposure_chance=0.02,
                            exposed_time=24, infected_time=72,
                            vaccination_rate=25),
        dataclasses.replace(base.thresholds, lockdown=-1.0, vaccination=0.03,
                            mask_public_transport=0.01, mask_everywhere=0.05))
    return jp, bridge.params_from_values(dataclasses.asdict(jp.disease),
                                         dataclasses.asdict(jp.thresholds))


def _state_arrays(st):
    import jax

    names = ("status", "timer", "eligible", "at_work", "on_bus",
             "bus_to_work", "at_work_ws", "on_bus_ws", "hour", "lockdown",
             "vaccination_started", "mask_status")
    out = {k: np.asarray(getattr(st, k)) for k in names}
    out["rng_key"] = np.asarray(jax.random.key_data(st.rng_key))
    return out


@pytest.mark.parametrize("n_dev", [3, 4])
def test_padding_matches_jax(n_dev):
    """The padded world lane for lane (the pads' building, OA, room and
    flags, one more building, no index tables) and the padded state (the
    pads Recovered, the work-order bits dropped)."""
    n = 4001
    jw = j_world(n, n_output_areas=12, seed=4)
    tw = et.generate_synthetic_world(n, n_output_areas=12, seed=4)
    jp_w, tp_w = (j_mesh.pad_world_for_mesh(jw, n_dev),
                  mesh.pad_world_for_mesh(tw.to("cpu"), n_dev))
    assert tp_w.n_citizens == jp_w.n_citizens == n + (-n) % n_dev
    assert tp_w.n_buildings == jp_w.n_buildings
    assert not tp_w.has_index_tables and not tp_w.has_fast_tables
    for name in et.World.CORE_LANES:
        got, want = getattr(tp_w, name), np.asarray(getattr(jp_w, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, name)

    j_state = j_init(jw, seed=0, starting_infected=40)
    t_state = bridge.state_from_arrays(_state_arrays(j_state), device="cpu")
    t_state = dataclasses.replace(t_state, sched=t_state.sched | 24)
    jp_s = j_mesh.pad_state_for_mesh(j_state, jp_w.n_citizens)
    tp_s = mesh.pad_state_for_mesh(t_state, tp_w.n_citizens)
    for name in ("status", "timer", "eligible"):
        np.testing.assert_array_equal(getattr(tp_s, name).numpy(),
                                      np.asarray(getattr(jp_s, name)), name)
    lanes = unpack_sched(tp_s.sched)
    for name in ("at_work", "on_bus", "bus_to_work"):
        np.testing.assert_array_equal(lanes[name].numpy(),
                                      np.asarray(getattr(jp_s, name)), name)
    assert not lanes["at_work_ws"].any() and not lanes["on_bus_ws"].any()
    assert (tp_s.status[n:] == et.config.STATUS_RECOVERED).all()


def test_pads_stay_inert():
    """Padded to 4 ranks, the pads stay Recovered and in the R column
    through a run with transport, and the population is conserved once
    the pads are taken out."""
    n, n_dev = 3001, 4
    tw = et.generate_synthetic_world(n, n_output_areas=8, seed=2)
    _, tp = _params()
    state = et.init_state(tw.to("cpu"), seed=0, starting_infected=40,
                          device="cpu")
    cfg = et.SimConfig(max_steps=48, chunk_size=24)
    final, out = mesh.run_sharded(tw, tp, cfg, state, devices=n_dev,
                                  device="cpu")
    n_pad = (-n) % n_dev
    assert final.status.shape == (n + n_pad,)
    assert (final.status[n:] == et.config.STATUS_RECOVERED).all()
    assert (final.sched[n:] == 0).all()
    assert (out.seirv.sum(1) == n + n_pad).all()
    assert (out.seirv[:, 3] >= n_pad).all()
    assert out.n_exposures.sum() > 0


@pytest.mark.parametrize("n_dev", [2, 4])
def test_run_sharded_matches_jax(n_dev):
    """``run_sharded`` on n_dev gloo ranks equals the JAX package's on an
    n_dev-device mesh: 4,001 citizens, 96 steps in chunks of 24, riders
    every day, masks and vaccination on (the global k-th threshold over
    every rank's lowest scores)."""
    from epidemicsimulator_tpu.parallel.mesh import make_mesh

    jp, tp = _params()
    kw = dict(max_steps=96, chunk_size=24, max_vaccinations_per_step=64)
    jw = j_world(4001, n_output_areas=12, seed=4)
    tw = et.generate_synthetic_world(4001, n_output_areas=12, seed=4)
    j_state = j_init(jw, seed=0, starting_infected=40)
    t_state = bridge.state_from_arrays(_state_arrays(j_state), device="cpu")
    j_final, want = j_mesh.run_sharded(jw, jp, JSimConfig(**kw), j_state,
                                       make_mesh(n_dev))
    final, got = mesh.run_sharded(tw, tp, et.SimConfig(**kw), t_state,
                                  devices=n_dev, device="cpu")
    for name in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    for name in ("status", "timer", "eligible"):
        np.testing.assert_array_equal(getattr(final, name).numpy(),
                                      np.asarray(getattr(j_final, name)), name)
    lanes = unpack_sched(final.sched)
    for name in ("at_work", "on_bus", "bus_to_work"):
        np.testing.assert_array_equal(lanes[name].numpy(),
                                      np.asarray(getattr(j_final, name)), name)
    assert final.hour == 96
    assert got.n_bus_exposures.sum() > 0, "no bus exposures"
    assert got.n_vaccinated_now.max() > 0, "vaccination never fired"
    assert got.mask_status.max() == 2

"""The port's population-sharded engine (``parallel/fastmesh.py``) against
the JAX package's, on the CPU.

The JAX side runs ``run_fast_sharded`` on the virtual CPU mesh
(tests/conftest.py), in its XLA branch, which ``tests/test_fastmesh.py``
holds bitwise equal to its fused branch.  The port's side runs as gloo
ranks that ``parallel/launch.py`` starts (this process is rank 0), with
the kernels' plain versions.  Worlds are small (4,000 and 6,000
citizens) and every comparison is bitwise: the SEIRV, per-OA, exposure,
bus-exposure, lockdown, mask and vaccination series, and the final lanes
gathered from the padded shard layout.  Under ``covid()``-like
parameters that holds as long as no uniform draw falls between torch's
and XLA's float32 probabilities (``tests/test_torch_slice.py`` says
why); in these runs none does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.parallel import fastmesh as j_fastmesh
from epidemicsimulator_tpu.parallel.mesh import make_mesh

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge
from epidemicsimulator_tpu_torch.engine.scan import run as t_run
from epidemicsimulator_tpu_torch.parallel import fastmesh, partition


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


OUTPUTS = ("seirv", "exposures_per_oa", "n_exposures", "n_bus_exposures",
           "lockdown", "mask_status", "n_vaccinated_now")


def _strip_transport(world):
    n = world.n_citizens
    return dataclasses.replace(
        world,
        uses_transport=np.zeros(n, bool),
        ws_uses_transport=np.zeros(n, bool),
        rider_perm=np.zeros(0, np.int32),
        rider_route=np.zeros(0, np.int32),
        rider_mask_compliant=np.zeros(0, bool),
    )


def _params(regime):
    base = JParams.covid()
    if regime == "deterministic":
        # every draw probability 0, 1 or NaN; vaccination on
        disease = dict(exposure_chance=1.0, exposed_time=6, infected_time=12,
                       vaccination_rate=20)
        th = dict(lockdown=0.35, vaccination=0.05, mask_public_transport=2.0,
                  mask_everywhere=2.0)
    else:
        disease = dict(exposure_chance=0.04, exposed_time=24,
                       infected_time=72, vaccination_rate=25)
        th = dict(lockdown=0.20, vaccination=0.05, mask_public_transport=0.01,
                  mask_everywhere=0.08)
    jp = JParams(dataclasses.replace(base.disease, **disease),
                 dataclasses.replace(base.thresholds, **th))
    return jp, bridge.params_from_values(dataclasses.asdict(jp.disease),
                                         dataclasses.asdict(jp.thresholds))


def _assert_outputs_equal(got, want):
    for name in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)


def _assert_live(out):
    """The run exercised what it claims to: exposures, vaccination, the
    lockdown."""
    assert np.asarray(out.n_exposures).sum() > 0, "no exposures"
    assert np.asarray(out.n_vaccinated_now).max() > 0, "vaccination never fired"
    assert np.asarray(out.lockdown).any(), "lockdown never engaged"


@pytest.mark.parametrize("regime", ["deterministic", "covid_transport"])
@pytest.mark.parametrize("n_dev", [3, 4])
def test_sharded_matches_jax_sharded(n_dev, regime):
    """``run_fast_sharded`` on n_dev gloo ranks equals the JAX package's
    on an n_dev-device mesh, with transport (the bus keys folded with the
    rank on both sides): every output series, and the final status,
    timer, eligible and schedule lanes in the padded shard layout."""
    jp, tp = _params(regime)
    steps, chunk = (60, 20) if regime == "deterministic" else (100, 25)
    kw = dict(max_steps=steps, chunk_size=chunk,
              bus_capacity=1_000_000 if regime == "deterministic" else 20)
    jw = j_world(4000, n_output_areas=12, seed=4)
    tw = et.generate_synthetic_world(4000, n_output_areas=12, seed=4)
    j_state, j_sw, want = j_fastmesh.run_fast_sharded(
        jw, jp, JSimConfig(**kw), make_mesh(n_dev), seed=0,
        starting_infected=40)
    state, sw, got = fastmesh.run_fast_sharded(
        tw, tp, et.SimConfig(**kw), n_dev, seed=0, starting_infected=40,
        device="cpu")
    _assert_outputs_equal(got, want)
    _assert_live(got)
    assert state.hour == steps
    assert state.status.shape == (n_dev * sw.shard_size,)
    for name in ("status", "timer", "eligible"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(j_state, name)), name)
    for bit, name in enumerate(("at_work", "on_bus", "bus_to_work")):
        np.testing.assert_array_equal(((state.sched >> bit) & 1).bool().numpy(),
                                      np.asarray(getattr(j_state, name)), name)
    assert int(state.sched.max()) < 8  # no work-order twin bits


TF_KW = dict(max_steps=120, chunk_size=40)


@pytest.fixture(scope="module")
def transport_free():
    """The 6,000-citizen world without transport, its parameters, the
    4-rank run with the sampled-band vaccination selector forced on (a
    2**6 sample per rank), and the number of the run's selections that
    fell back to the bisection on rank 0 (this process: all ranks take
    the same branch)."""
    from epidemicsimulator_tpu_torch.ops import select

    _, tp = _params("covid")
    base = dataclasses.replace(tp.thresholds, lockdown=0.05, vaccination=0.01,
                               mask_public_transport=0.005,
                               mask_everywhere=0.03)
    tp = et.Params(dataclasses.replace(tp.disease, exposure_chance=0.02,
                                       vaccination_rate=50), base)
    tw = _strip_transport(et.generate_synthetic_world(6000, n_output_areas=10,
                                                      seed=2))
    cfg = et.SimConfig(use_sampled_vax_sharded=True, vax_sharded_sample_log2=6,
                       **TF_KW)
    fallbacks = []
    bisect = select.bisect_threshold_rows

    def counted(*args, **kw):
        fallbacks.append(1)
        return bisect(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(select, "bisect_threshold_rows", counted)
        run = fastmesh.run_fast_sharded(tw, tp, cfg, 4, seed=1,
                                        starting_infected=100, device="cpu")
    return tw, tp, run, len(fallbacks)


@pytest.fixture(scope="module")
def single_card(transport_free):
    """The port's one-device run of the same world: its final state and
    outputs (its selector is the bisection, ``bisect_threshold_rows``)."""
    tw, tp = transport_free[:2]
    world = tw.to("cpu")
    st = et.init_state(world, seed=1, starting_infected=100, device="cpu")
    return t_run(world, tp, et.SimConfig(**TF_KW), st)


def test_transport_free_sharded_matches_single_card(transport_free,
                                                    single_card):
    """Without transport every draw hashes a global id, so 4 ranks equal
    the port's one-device run: the outputs and the final status."""
    _, _, (state, sw, got), _ = transport_free
    st1, want = single_card
    _assert_outputs_equal(got, want)
    _assert_live(got)
    status = partition.gather_state_arrays(
        sw, {"status": state.status.numpy().reshape(4, sw.shard_size)})
    np.testing.assert_array_equal(status["status"], st1.status.numpy())


def test_sampled_selector_matches_bisection(transport_free, single_card):
    """The sampled-band vaccination selector, forced on with a 2**6 sample
    per rank, gives the run of the bisection (the one-device selector;
    the 4-rank bisection is held to the JAX package above), vaccination
    fires, and the band, not its fallback, chose most thresholds."""
    _, _, (_, _, got), fallbacks = transport_free
    _assert_outputs_equal(got, single_card[1])
    vaccinating = int((got.n_vaccinated_now > 0).sum())
    assert vaccinating > 0
    assert fallbacks < vaccinating / 2, (fallbacks, vaccinating)

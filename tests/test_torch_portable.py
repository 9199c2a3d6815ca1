"""The port's portable step (``engine/step.py::portable_step``) against the
JAX package's, on the CPU.

The reference is the JAX ``step`` with ``SimConfig(use_fast_path=False)``,
which has no Pallas call.  Both packages start from the same state
(carried across by ``bridge``) on the same world and run free through
``run``.  Every comparison is bitwise: the SEIRV, per-OA, exposure,
bus-exposure, vaccination, lockdown and mask series, and the final
status, timer, eligible and schedule lanes.  Outside the deterministic
regime that holds as long as no uniform draw falls between torch's and
XLA's float32 probabilities (``-expm1(n * log1p(-p))`` may differ in its
last ulp or two, ``tests/test_torch_ops.py``); in these runs none does.

Also here: ``bus_infection_counts`` alone, with wrapped (negative) route
keys; the vaccination's tie order at the k-th rank; the Simulator's
artifacts; the scalar oracle's distributional check run against the
port; the fast step's fresh selector with ``faithful_vaccine_bugs=False``
under ``covid()``; and the engines that refuse ``use_fast_path=False``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.engine.scan import run as j_run
from epidemicsimulator_tpu.engine.simulator import Simulator as JSimulator
from epidemicsimulator_tpu.engine.state import init_state as j_init
from epidemicsimulator_tpu.engine.step import step as j_step
from epidemicsimulator_tpu.ops import segments as j_segments
from epidemicsimulator_tpu.world.census_like import (
    generate_census_like_world as j_census_like,
)
from epidemicsimulator_tpu.world.schema import make_world as j_make_world

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge
from epidemicsimulator_tpu_torch.engine import fastpath as t_fastpath
from epidemicsimulator_tpu_torch.engine.state import unpack_sched
from epidemicsimulator_tpu_torch.engine.step import lowest_k
from epidemicsimulator_tpu_torch.ops import segments, threefry

OUTPUTS = ("seirv", "exposures_per_oa", "n_exposures", "n_bus_exposures",
           "lockdown", "mask_status", "n_vaccinated_now")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the worlds here are small, and the suite runs
    several processes at once, whose thread pools would share the cores
    (``tests/test_torch_fastmesh.py`` says what that cost)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _params(regime):
    """(JAX Params, port Params) of a regime."""
    base = JParams.covid()
    if regime == "covid":
        jp = base
    elif regime == "covid_v16":
        jp = JParams.covid_v16()
    elif regime == "deterministic":
        # every draw probability 0, 1 or NaN: exposure chance 1, masks off
        jp = JParams(
            dataclasses.replace(base.disease, exposure_chance=1.0,
                                exposed_time=6, infected_time=12,
                                vaccination_rate=20),
            dataclasses.replace(base.thresholds, lockdown=0.35,
                                vaccination=0.05, mask_public_transport=2.0,
                                mask_everywhere=2.0))
    else:  # "transport": covid() disease, riders every day, masks on
        jp = JParams(
            dataclasses.replace(base.disease, exposure_chance=0.02,
                                exposed_time=24, infected_time=72,
                                vaccination_rate=25),
            dataclasses.replace(base.thresholds, lockdown=-1.0,
                                vaccination=0.03, mask_public_transport=0.01,
                                mask_everywhere=0.05))
    return jp, _t_params(jp)


def _compare_runs(jw, tw, jp, tp, kw, starting_infected, seed=0,
                  np_seed=None):
    """``run`` of both packages from one state; returns the port's
    outputs after asserting them and the final lanes equal."""
    jwd = jw.device_put()
    j_state = j_init(jwd, seed=seed, starting_infected=starting_infected,
                     np_seed=np_seed)
    t_state = bridge.state_from_arrays(_state_arrays(j_state), device="cpu")
    j_final, want = j_run(jwd, jp, JSimConfig(**kw), j_state, overlap=False)
    t_final, got = et.run(tw, tp, et.SimConfig(**kw), t_state)
    for name in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    ja = _state_arrays(j_final)
    for name in ("status", "timer", "eligible"):
        np.testing.assert_array_equal(getattr(t_final, name).numpy(),
                                      ja[name], name)
    lanes = unpack_sched(t_final.sched)
    for name in ("at_work", "on_bus", "bus_to_work"):
        np.testing.assert_array_equal(lanes[name].numpy(), ja[name], name)
    assert t_final.hour == int(ja["hour"])
    return got


#: (regime, branch, transport, faithful_vaccine_bugs,
#: reference_mask_semantics, reference_u8_truncation, starting infected,
#: use_fast_path): each flag takes both values, both branches and
#: transport on and off; the last case asks for the fast path on a world
#: without its tables, which both packages' ``step`` answer with the
#: portable step (``step.py:76``)
CASES = [
    ("deterministic", "prefix", True, True, True, True, 10, False),
    ("deterministic", "segment", False, False, True, True, 10, False),
    ("covid", "prefix", True, True, True, True, 60, False),
    ("covid_v16", "segment", True, True, False, False, 60, False),
    ("transport", "prefix", True, False, False, True, 30, False),
    ("transport", "segment", True, True, True, False, 30, True),
]


@pytest.mark.parametrize(
    "regime,branch,transport,faithful,ref_mask,u8,infected,fast", CASES)
def test_portable_run_matches_jax(regime, branch, transport, faithful,
                                  ref_mask, u8, infected, fast):
    """Whole runs, 96 steps in chunks of 48: with the index tables the
    prefix branch (B3's range totals and the rider branch of the bus
    side), without them (``without_index_tables``) the segment-sum
    branch and the per-citizen route keys."""
    jw = j_world(4000, n_output_areas=8, seed=4)
    tw = et.generate_synthetic_world(4000, n_output_areas=8, seed=4)
    if not transport:
        jw, tw = _no_transport(jw), _no_transport(tw)
    if branch == "segment":
        jw, tw = jw.without_index_tables(), tw.without_index_tables()
    jp, tp = _params(regime)
    kw = dict(max_steps=96, chunk_size=48, use_fast_path=fast,
              faithful_vaccine_bugs=faithful,
              reference_mask_semantics=ref_mask,
              reference_u8_truncation=u8, max_vaccinations_per_step=1530)
    got = _compare_runs(jw, tw.to("cpu"), jp, tp, kw, infected)
    # covid() vaccinates 1,530 an hour from hour 1 (the clamp of
    # max_vaccinations_per_step), draining this world's pool in 3 hours
    assert got.n_exposures.sum() > 0 or regime == "covid"
    if regime in ("deterministic", "covid", "transport"):
        assert got.n_vaccinated_now.sum() > 0, "vaccination never fired"
    if regime == "transport":
        assert got.n_bus_exposures.sum() > 0, "no bus exposures"
        assert got.mask_status.max() == 2


def _big_workplace(make_world):
    """600 workers of one workplace (300 of them infected in the test)
    and their 150 households: the work count, 300, wraps to 44 under the
    reference's u8 truncation."""
    n = 600
    return make_world(
        age=np.full(n, 30), occupation=np.ones(n, int),
        home_building=np.arange(n) // 4, work_building=np.full(n, 150),
        home_oa=np.zeros(n, int), work_oa=np.zeros(n, int),
        room=np.zeros(n, int), is_school_work=np.zeros(n, bool),
        uses_transport=np.zeros(n, bool), mask_compliant=np.zeros(n, bool),
        n_buildings=151, n_rooms=0, n_output_areas=1)


@pytest.mark.parametrize("u8", [True, False])
def test_u8_truncation_bites_and_matches_jax(u8):
    """A workplace with 300 infected at work: with the truncation its
    count is 44, so the two flag values give different runs, and each
    equals the JAX package's."""
    jw, tw = _big_workplace(j_make_world), _big_workplace(et.make_world)
    base = JParams.covid()
    jp = JParams(
        dataclasses.replace(base.disease, exposure_chance=0.002,
                            exposed_time=200, infected_time=400),
        dataclasses.replace(base.thresholds, lockdown=-1.0, vaccination=-1.0,
                            mask_public_transport=2.0, mask_everywhere=2.0))
    kw = dict(max_steps=48, chunk_size=48, use_fast_path=False,
              reference_u8_truncation=u8)
    jwd = jw.device_put()
    j_state = j_init(jwd, seed=0, starting_infected=0)
    status = np.zeros(600, np.int8)
    status[::2] = 2
    j_state = dataclasses.replace(j_state, status=jnp.asarray(status))
    t_state = bridge.state_from_arrays(_state_arrays(j_state), device="cpu")
    _, want = j_run(jwd, jp, JSimConfig(**kw), j_state)
    _, got = et.run(tw.to("cpu"), _t_params(jp), et.SimConfig(**kw), t_state)
    for name in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    # the count of 300 saturates q; 44 does not
    assert (got.n_exposures.sum() < 290) == u8


# the vaccination's order among equal scores ------------------------------
def test_lowest_k_breaks_ties_as_xla_top_k():
    """XLA's TopK takes the lower index first among equal values; the
    stable sort does too, where ``torch.topk`` need not."""
    x = np.array([0.5, 0.25, 0.5, 0.25, 2.0, 0.25, 2.0, 0.5], np.float32)
    want_v, want_i = jax.lax.top_k(-jnp.asarray(x), 6)
    got_v, got_i = lowest_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), -np.asarray(want_v))
    rng = np.random.default_rng(3)
    y = rng.integers(0, 64, 200_000).astype(np.float32) / 64
    want_v, want_i = jax.lax.top_k(-jnp.asarray(y), 1530)
    got_v, got_i = lowest_k(torch.from_numpy(y), 1530)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _tie_hour(seed, eligible, rate, hours):
    """The first hour in ``hours`` whose vaccination scores (the portable
    step's threefry stream under ``seed``) tie at ranks ``rate`` and
    ``rate + 1`` of the eligible pool, or None."""
    key = threefry.key(seed)
    for hour in hours:
        k_vax = threefry.split(threefry.fold_in(key, hour), 3)[2]
        u = threefry.uniform(k_vax, eligible.shape[0])
        s = torch.sort(torch.where(eligible, u, 2.0)).values
        if s[rate - 1] == s[rate]:
            return hour
    return None


def test_vaccination_tie_at_the_kth_rank_matches_jax():
    """A run that ends on a vaccinating hour whose rate-th and next
    eligible scores tie, so the tie order decides who is vaccinated.  No
    exposure happens (exposure chance 0) and the faithful pool never
    shrinks, so the pool is everyone susceptible at the start, and the
    seed and hour of a tie are found on the host before the run (about
    one hour in 400 has one at 20,000 citizens)."""
    n, rate = 20_000, 20
    jw = j_world(n, n_output_areas=32, seed=6)
    tw = et.generate_synthetic_world(n, n_output_areas=32, seed=6)
    base = JParams.covid()
    jp = JParams(
        dataclasses.replace(base.disease, exposure_chance=0.0,
                            vaccination_rate=rate),
        dataclasses.replace(base.thresholds, lockdown=-1.0, vaccination=0.0,
                            mask_public_transport=2.0, mask_everywhere=2.0))
    eligible = torch.from_numpy(np.asarray(
        j_init(jw.device_put(), seed=0, starting_infected=10).status) == 0)
    seed, hour = next((s, h) for s in range(0, 4000, 97)
                      if (h := _tie_hour(s, eligible, rate, range(1, 9))))
    kw = dict(max_steps=hour, chunk_size=hour, use_fast_path=False)
    # the key from the seed found, the infected (and so the pool) from 0
    got = _compare_runs(jw, tw.to("cpu"), jp, _t_params(jp), kw, 10,
                        seed=seed, np_seed=0)
    assert got.n_vaccinated_now[-1] == rate


# bus_infection_counts and its sort -----------------------------------------
def test_shuffle_order_orders_negative_route_keys():
    rng = np.random.default_rng(7)
    rk = rng.integers(-(2**31), 2**31, 5000, dtype=np.int64)
    rk[::7] = rk[0]
    tie = rng.integers(0, 2**32, 5000, dtype=np.int64)
    tie[::5] = tie[1]
    rk_s, order = segments.shuffle_order(torch.from_numpy(rk),
                                         torch.from_numpy(tie))
    want = np.lexsort((np.arange(5000), tie.astype(np.uint32).view(np.int32),
                       rk))
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(rk_s.numpy(), rk[want])


@pytest.mark.parametrize("capacity", [20, 3])
def test_bus_infection_counts_matches_jax(capacity):
    """Route keys ``src * n_oa + dst`` over 227,759 OAs (the full UK's)
    wrap in int32, some to negative values, and equal wrapped keys share
    buses in both packages."""
    rng = np.random.default_rng(capacity)
    n, n_oa = 20_000, 227_759
    src = rng.integers(0, n_oa, 40).astype(np.int32)
    dst = rng.integers(0, n_oa, 40).astype(np.int32)
    pick = rng.integers(0, 40, n)
    with np.errstate(over="ignore"):
        route_key = src[pick] * np.int32(n_oa) + dst[pick]
    assert (route_key < 0).any()
    on_bus = rng.random(n) < 0.6
    infected = on_bus & (rng.random(n) < 0.2)
    key = jax.random.key(11)
    want = j_segments.bus_infection_counts(
        key, jnp.asarray(on_bus), jnp.asarray(route_key),
        jnp.asarray(infected), capacity)
    got = segments.bus_infection_counts(
        tuple(int(k) for k in np.asarray(jax.random.key_data(key))),
        torch.from_numpy(on_bus), torch.from_numpy(route_key),
        torch.from_numpy(infected), capacity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.max() > 0 and got.max() <= capacity


# the Simulator -------------------------------------------------------------
def test_simulator_artifacts_match_jax(tmp_path, capsys):
    """``Simulator(cfg=SimConfig(use_fast_path=False))`` of both packages
    on a census-like world under ``covid_v16()``: byte-identical
    ``global_stats.json`` and ``exposures.json`` and the same transition
    lines."""
    jw = j_census_like(5000, 16, seed=42)
    tw = et.generate_census_like_world(5000, 16, seed=42)
    kw = dict(max_steps=96, chunk_size=24, use_fast_path=False)

    def transitions():
        return [line for line in capsys.readouterr().out.splitlines()
                if line.startswith(("Lockdown is", "Mask wearing"))]

    j_seirv = JSimulator(jw, JParams.covid_v16(), JSimConfig(**kw),
                         seed=1).simulate(str(tmp_path / "j"))
    j_lines = transitions()
    t_seirv = et.Simulator(tw, et.Params.covid_v16(), et.SimConfig(**kw),
                           seed=1, device="cpu").simulate(str(tmp_path / "t"))
    np.testing.assert_array_equal(t_seirv, np.asarray(j_seirv))
    for name in ("global_stats.json", "exposures.json"):
        with open(tmp_path / "t" / name, "rb") as f, \
                open(tmp_path / "j" / name, "rb") as g:
            assert f.read() == g.read(), name
    assert transitions() == j_lines
    assert t_seirv[-1, 1:3].sum() > 0


def test_simulator_checkpoint_resume_portable(tmp_path):
    """The portable Simulator checkpoints after 2 chunks, and a new one
    resumes from the file: its steps are the straight run's next ones."""
    tw = et.generate_synthetic_world(3000, n_output_areas=8, seed=3)
    tp = et.Params.covid_v16()
    full = et.SimConfig(max_steps=96, chunk_size=24, use_fast_path=False)
    half = et.SimConfig(max_steps=48, chunk_size=24, use_fast_path=False)
    straight = et.Simulator(tw, tp, full, seed=2, device="cpu",
                            verbose=False).simulate()
    path = str(tmp_path / "ckpt.npz")
    first = et.Simulator(tw, tp, half, seed=2, checkpoint_path=path,
                         checkpoint_every_chunks=2, device="cpu",
                         verbose=False).simulate()
    second = et.Simulator(tw, tp, half, seed=2, checkpoint_path=path,
                          device="cpu", verbose=False).simulate()
    np.testing.assert_array_equal(np.concatenate([first, second]), straight)
    assert straight[-1, 1:3].sum() > 0


# the scalar oracle -----------------------------------------------------------
ORACLE_N, ORACLE_T, ORACLE_SEEDS = 600, 240, 12


def _oracle_params(with_interventions):
    """tests/test_oracle_equivalence.py's parameters, in the port's
    classes."""
    base = et.Params.covid()
    d = dataclasses.replace(base.disease, exposure_chance=0.02,
                            exposed_time=24, infected_time=72,
                            vaccination_rate=30)
    t = base.thresholds if with_interventions else dataclasses.replace(
        base.thresholds, lockdown=-1.0, vaccination=-1.0,
        mask_public_transport=2.0, mask_everywhere=2.0)
    return et.Params(d, t)


@pytest.mark.parametrize("with_interventions", [False, True])
def test_portable_step_matches_the_oracle(with_interventions):
    """The distributional check of ``tests/test_oracle_equivalence.py``
    with the port's portable step as the engine: final attack size and
    peak infected over 12 seeds agree with the scalar oracle's within
    4 combined standard errors."""
    from oracle import Oracle

    world = et.generate_synthetic_world(ORACLE_N, n_output_areas=4, seed=9,
                                        oas_per_school=2)
    params = _oracle_params(with_interventions)
    status0 = np.zeros(ORACLE_N, np.int8)
    rng = np.random.default_rng(123)
    status0[rng.choice(ORACLE_N, 4, replace=False)] = 2
    cfg = et.SimConfig(max_steps=ORACLE_T, chunk_size=ORACLE_T,
                       max_vaccinations_per_step=30, use_fast_path=False)
    wd = world.to("cpu")
    engine, oracle = ([], []), ([], [])
    for s in range(ORACLE_SEEDS):
        st = et.init_state(wd, seed=1000 + s, starting_infected=0,
                           device="cpu")
        st = dataclasses.replace(st, status=torch.from_numpy(status0.copy()))
        _, out = et.run(wd, params, cfg, st)
        engine[0].append(1.0 - out.seirv[-1, 0] / ORACLE_N)
        engine[1].append(out.seirv[:, 2].max() / ORACLE_N)
        o = Oracle(world, params, seed=2000 + s)
        o.status[:] = status0
        hist = o.run(ORACLE_T)
        oracle[0].append(1.0 - hist[-1, 0] / ORACLE_N)
        oracle[1].append(hist[:, 2].max() / ORACLE_N)
    for a, b, label in zip(engine, oracle, ("final attack size",
                                            "peak infected")):
        a, b = np.array(a), np.array(b)
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b)) + 1e-9
        z = abs(a.mean() - b.mean()) / se
        assert z < 4.0, (f"{label}: port {a.mean():.4f} vs oracle "
                         f"{b.mean():.4f} (z={z:.2f})")


# the fast step's fresh selector, faithful_vaccine_bugs=False ----------------
@functools.lru_cache(maxsize=None)
def _j_fast_step(cfg):
    return jax.jit(lambda w, p, s: j_step(w, p, cfg, s))


def test_fast_fresh_selector_unfaithful_under_covid():
    """The fast step (fused formulation) with ``faithful_vaccine_bugs=
    False`` under ``covid()``, step by step against the JAX main-path
    formulation: vaccination fires from hour 1 (1.5% infected) and the
    pool drains, so the selector's exact-k choice and its removal of the
    chosen are held outside the deterministic regime."""
    jw = j_world(4000, n_output_areas=8, seed=4)
    tw = et.generate_synthetic_world(4000, n_output_areas=8, seed=4).to("cpu")
    j_cfg = JSimConfig(use_fused_citizen=True, use_pallas_scans=True,
                       faithful_vaccine_bugs=False)
    t_cfg = et.SimConfig(faithful_vaccine_bugs=False)
    jp = JParams.covid()
    tp = _t_params(jp)
    jwd, jpa = jw.device_put(), jp.as_arrays()
    j_state = j_init(jwd, seed=0, starting_infected=60)
    t_state = bridge.state_from_arrays(_state_arrays(j_state), device="cpu")
    tables = t_fastpath.make_step_tables(tw)
    n_vax = 0
    for hour in range(1, 25):
        j_state, j_out = _j_fast_step(j_cfg)(jwd, jpa, j_state)
        t_state, t_out = et.step(tw, tp, t_cfg, t_state, tables=tables)
        np.testing.assert_array_equal(t_out.seirv.numpy(),
                                      np.asarray(j_out.seirv), f"hour {hour}")
        assert int(t_out.n_vaccinated_now) == int(j_out.n_vaccinated_now)
        n_vax += int(t_out.n_vaccinated_now)
        for name in ("status", "eligible"):
            np.testing.assert_array_equal(
                getattr(t_state, name).numpy(),
                np.asarray(getattr(j_state, name)), f"{name}, hour {hour}")
    assert n_vax > 1530, "the pool did not drain"


# refusals ------------------------------------------------------------------
def test_engines_without_a_portable_form_refuse_it():
    """The packed ensemble and the fast sharded engine have only the fast
    formulation: ``use_fast_path=False`` raises, before any run."""
    world = et.generate_synthetic_world(500, n_output_areas=4, seed=1)
    cfg = et.SimConfig(max_steps=4, chunk_size=4, use_fast_path=False)
    with pytest.raises(NotImplementedError, match="use_fast_path"):
        et.run_ensemble(world, [et.Params.covid()] * 2, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="use_fast_path"):
        et.run_ensemble(world, [et.Params.covid()] * 2, cfg, devices=2,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="use_fast_path"):
        et.Simulator(world, et.Params.covid(), cfg, devices=2, device="cpu")
    from epidemicsimulator_tpu_torch.parallel import fastmesh

    with pytest.raises(NotImplementedError, match="use_fast_path"):
        fastmesh.run_fast_sharded(world, et.Params.covid(), cfg, 2,
                                  device="cpu")

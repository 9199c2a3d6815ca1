"""The port's packed-replica ensembles against the JAX package's, on the CPU.

The JAX reference is its packed engine under ``SimConfig(
use_fused_citizen=True, use_pallas_scans=True)``: B1 in its ensemble mode
and B2, both Pallas kernels in interpret mode, as in
``tests/test_torch_slice.py``.  Worlds are small (3 replicas of 3,000
citizens in strides of 4,096 lanes) and every comparison is bitwise: the
packed layout, the (T, R, 5) SEIRV series and the final lanes, pads
included.  Under ``covid()`` that holds as long as no uniform draw falls
between torch's and XLA's float32 probabilities (``tests/test_torch_slice.py``
says why); in these runs none does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.config import STATUS_INFECTED
from epidemicsimulator_tpu.engine import ensemble as j_ensemble
from epidemicsimulator_tpu.engine import fastpath as j_fastpath
from epidemicsimulator_tpu.engine import packed as j_packed
from epidemicsimulator_tpu.ops import pallas_citizen as j_cit
from epidemicsimulator_tpu.ops import runsums as j_runsums
from epidemicsimulator_tpu.ops import segments as j_segments

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge
from epidemicsimulator_tpu_torch.engine import ensemble as t_ensemble
from epidemicsimulator_tpu_torch.engine import packed as t_packed
from epidemicsimulator_tpu_torch.ops import citizen as t_cit
from epidemicsimulator_tpu_torch.ops import runsums as t_runsums
from epidemicsimulator_tpu_torch.ops import segments as t_segments
from epidemicsimulator_tpu_torch.ops import select as t_select
from epidemicsimulator_tpu_torch.ops import threefry

T = torch.from_numpy
J_CFG = JSimConfig(use_fused_citizen=True, use_pallas_scans=True)
N, N_OA, WORLD_SEED, BLOCK_ROWS = 3000, 8, 6, 32


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


def _t_params(jp):
    return bridge.params_from_values(dataclasses.asdict(jp.disease),
                                     dataclasses.asdict(jp.thresholds))


@pytest.fixture(scope="module")
def worlds():
    return (j_world(N, n_output_areas=N_OA, seed=WORLD_SEED),
            et.generate_synthetic_world(N, n_output_areas=N_OA, seed=WORLD_SEED))


def _deterministic_params(base=JParams.covid()):
    """exposure_chance 1 or 0 (every draw probability 0, 1 or NaN), masks
    off, per-replica timers; lockdown and vaccination trigger per
    replica."""
    th = dataclasses.replace(base.thresholds, lockdown=0.2, vaccination=0.05,
                             mask_public_transport=2.0, mask_everywhere=2.0)
    return [JParams(dataclasses.replace(base.disease, exposure_chance=ch,
                                        exposed_time=e, infected_time=i,
                                        vaccination_rate=10), th)
            for ch, e, i in [(1.0, 6, 12), (1.0, 10, 20), (0.0, 4, 30)]]


def _covid_params(base=JParams.covid()):
    """covid() with a chance per replica (one of them 0) and thresholds
    low enough for lockdown, masks and vaccination to start."""
    th = dataclasses.replace(base.thresholds, lockdown=0.02, vaccination=0.01,
                             mask_public_transport=0.003, mask_everywhere=0.006)
    return [JParams(dataclasses.replace(base.disease, exposure_chance=ch,
                                        exposed_time=e, infected_time=i,
                                        vaccination_rate=10), th)
            for ch, e, i in [(0.05, 6, 12), (0.02, 10, 20), (0.0, 4, 30)]]


# --- B1's ensemble mode ---------------------------------------------------


def _q_reference(jpe, status, timer, sched, rep_ints, rep_f32s, h24, ref_sem):
    """The home probability of every lane from the JAX package's own
    pieces (fastpath.py's timers and movement, packed.py's household
    window, the kernel's 1 - exp(n log(1 - p)))."""
    w = jpe.world
    lane = lambda col: jnp.asarray(np.repeat(col, jpe.rep_stride))
    move = lane(rep_ints[:, 0] != 0)

    class D:
        exposed_time = lane(rep_ints[:, 2])
        infected_time = lane(rep_ints[:, 3])

    st1, _ = j_fastpath._advance_disease(jnp.asarray(status),
                                         jnp.asarray(timer), D)
    s = jnp.asarray(sched)
    at_work, on_bus, _ = j_fastpath._movement(
        h24, w.work_start, w.work_end, w.uses_transport, move, (s & 1) != 0,
        (s & 2) != 0, (s & 4) != 0)
    wneq = w.work_building != w.home_building
    contrib = (st1 == 2) & ~on_bus & (~at_work | ~wneq)
    c8 = contrib.astype(jnp.int8)
    n_h = contrib.astype(jnp.int32)
    for d in range(1, w.max_household_size):
        n_h = n_h + jnp.where(w.hh_pos + d < w.hh_size, jnp.roll(c8, -d), 0)
        n_h = n_h + jnp.where(w.hh_pos - d >= 0, jnp.roll(c8, d), 0)
    compliant, ms = w.mask_compliant, lane(rep_ints[:, 1])
    if ref_sem:
        active = (ms == 2) & ~compliant
    else:
        active = compliant & ((ms == 2) | ((ms == 1) & on_bus))
    p = lane(rep_f32s[:, 0]) * jnp.where(active, lane(rep_f32s[:, 1]), 1.0)
    q = 1.0 - jnp.exp(n_h.astype(jnp.float32) * jnp.log(1.0 - p))
    return np.asarray(jnp.where(~at_work | (w.work_oa == w.home_oa), q, 0.0))


@pytest.mark.parametrize("h24,ref_sem", [(8, True), (17, False)])
def test_b1_ensemble_plain_matches_pallas(worlds, h24, ref_sem):
    """Packed lanes, three replicas with different rows (one with
    exposure_chance 0, one locked down, the mask states differing), a
    random state: status, timer, sched and gates bitwise, the (R, 8)
    census equal to the per-replica sum of the Pallas partials, and q
    within 2**-23 of the JAX package's formula (test_torch_ops.py)."""
    jw, tw = worlds
    plist = _covid_params()
    jpe = j_packed.pack_replicas(jw, plist, block_rows=BLOCK_ROWS)
    tpe = t_packed.pack_replicas(tw, [_t_params(p) for p in plist],
                                 block_rows=BLOCK_ROWS)
    nl = jpe.world.n_citizens
    rng = np.random.default_rng(h24)
    status = rng.choice(5, nl, p=[0.7, 0.1, 0.1, 0.05, 0.05]).astype(np.int8)
    status[np.tile(np.arange(jpe.rep_stride) >= jpe.rep_size, 3)] = 5
    timer = rng.integers(0, 40, nl).astype(np.int32)
    sched = rng.integers(0, 32, nl).astype(np.int8)
    seed = int(rng.integers(0, 2**32))
    f32 = np.float32
    rep_ints = np.array([[1, 2, 6, 12], [0, 1, 10, 20], [1, 0, 4, 30]], np.int32)
    rep_f32s = np.array([[0.05, f32(1) - f32(0.7)], [0.3, f32(1) - f32(0.5)],
                         [0.0, f32(1) - f32(0.7)]], np.float32)
    ints = jnp.asarray([h24, 0, 0, np.uint32(seed).view(np.int32), 0, 0, 0, 0],
                       jnp.int32)
    status1, timer1, sched1, gates, partials = j_cit.citizen_phase(
        j_cit.make_citizen_statics(jpe.world), jnp.asarray(status),
        jnp.asarray(timer), jnp.asarray(sched), ints,
        jnp.zeros(2, jnp.float32), K=jpe.world.max_household_size,
        ref_mask_sem=ref_sem, u8_trunc=True, block_rows=BLOCK_ROWS,
        interpret=True, n_citizens=nl, rep_ints=jnp.asarray(rep_ints),
        rep_f32s=jnp.asarray(rep_f32s), blocks_per_rep=jpe.blocks_per_rep)
    tw_lanes = tpe.world.to("cpu")
    got = t_cit.citizen_phase(
        t_cit.make_citizen_statics(tw_lanes), T(status), T(timer), T(sched),
        h24=h24, seed=seed, K=tpe.world.max_household_size,
        ref_mask_sem=ref_sem, u8_trunc=True, want_q=True,
        rep_ints=T(rep_ints), rep_f32s=T(rep_f32s),
        tiles_per_rep=tpe.rep_stride // t_cit.CITIZEN_TILE)
    for a, b, name in zip(got[:4], (status1, timer1, sched1, gates),
                          ("status", "timer", "sched", "gates")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    census = np.asarray(partials).reshape(3, jpe.blocks_per_rep, 8).sum(1)
    np.testing.assert_array_equal(got[4].numpy(), census)
    assert got[4].shape == (3, 8)
    assert census[0, 7] > 0 and census[2, 7] == 0  # chance 0: no home hit
    q_want = _q_reference(jpe, status, timer, sched, rep_ints, rep_f32s, h24,
                          ref_sem)
    q_got = got[5].numpy()
    np.testing.assert_array_equal(np.isnan(q_got), np.isnan(q_want))
    ok = ~np.isnan(q_want)
    assert np.abs(q_got - q_want)[ok].max() <= 2 * 2.0**-24


def test_b1_ensemble_refuses_bad_rows(worlds):
    _, tw = worlds
    statics = t_cit.make_citizen_statics(tw.to("cpu"))
    z8 = torch.zeros(tw.n_citizens, dtype=torch.int8)
    kw = dict(h24=0, seed=0, K=4, ref_mask_sem=True, u8_trunc=True,
              rep_ints=torch.zeros(2, 4, dtype=torch.int32),
              rep_f32s=torch.zeros(2, 2), tiles_per_rep=1)
    with pytest.raises(ValueError):  # N is not 2 x 1 x CITIZEN_TILE
        t_cit.citizen_phase(statics, z8, z8.int(), z8, **kw)


@pytest.mark.parametrize("fn", ["citizen_phase", "citizen_phase_plain"])
@pytest.mark.parametrize("missing", ["move", "exposure_chance"])
def test_b1_refuses_missing_scalars(worlds, fn, missing):
    """Outside the ensemble mode a missing scalar raises: a missing
    ``move`` must not run as a lockdown."""
    _, tw = worlds
    statics = t_cit.make_citizen_statics(tw.to("cpu"))
    z8 = torch.zeros(tw.n_citizens, dtype=torch.int8)
    kw = dict(h24=0, seed=0, K=4, ref_mask_sem=True, u8_trunc=True, move=True,
              mask_status=0, exposed_time=6, infected_time=12,
              exposure_chance=0.5, mask_scale=1.0)
    kw[missing] = None
    with pytest.raises(ValueError, match=missing):
        getattr(t_cit, fn)(statics, z8, z8.int(), z8, **kw)


# --- the layout -----------------------------------------------------------


@pytest.mark.parametrize("block_rows", [16, 32, 128])
def test_pack_replicas_matches_jax(worlds, block_rows):
    jw, tw = worlds
    plist = _covid_params()
    jpe = j_packed.pack_replicas(jw, plist, block_rows=block_rows)
    tpe = t_packed.pack_replicas(tw, [_t_params(p) for p in plist],
                                 block_rows=block_rows)
    assert (tpe.n_replicas, tpe.rep_size, tpe.rep_stride, tpe.block_rows,
            tpe.blocks_per_rep) == (jpe.n_replicas, jpe.rep_size,
                                    jpe.rep_stride, jpe.block_rows,
                                    jpe.blocks_per_rep)
    assert tpe.rep_stride % t_cit.CITIZEN_TILE == 0
    names = tpe.world.lane_names()
    assert set(names) <= {f.name for f in dataclasses.fields(jpe.world)}
    for name in names:
        want = np.asarray(getattr(jpe.world, name))
        np.testing.assert_array_equal(getattr(tpe.world, name), want, name)
    for name in ("n_buildings", "n_rooms", "n_output_areas",
                 "max_household_size"):
        assert getattr(tpe.world, name) == getattr(jpe.world, name), name
    for name in ("chance", "exposed_time", "infected_time",
                 "mask_effectiveness", "vaccination_rate"):
        a, b = getattr(tpe, name), np.asarray(getattr(jpe, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    js = j_packed.init_packed_state(jpe, seed=3, starting_infected=7)
    ts = t_packed.init_packed_state(tpe, seed=3, starting_infected=7,
                                    device="cpu")
    for name in ("status", "timer", "sched", "eligible"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert ts.rng_key == tuple(np.asarray(jax.random.key_data(js.rng_key)).tolist())


@pytest.mark.parametrize("block_rows", [8, 24, 100, 0])
def test_pack_replicas_refuses_block_rows_off_the_tile(worlds, block_rows):
    """A B1 tile is 2,048 lanes = 16 rows of 128: any other multiple
    would put a tile across two replicas."""
    _, tw = worlds
    with pytest.raises(ValueError, match="block_rows"):
        t_packed.pack_replicas(tw, [et.Params.covid()] * 2,
                               block_rows=block_rows)


def test_permute_by_sort_matches_jax(worlds):
    """The work side's two static permutations of a packed world (gates
    into work order, 5 bits; hits back, 1 bit) and the rider slots, 7
    bits, against the JAX package's sort."""
    jw, tw = worlds
    plist = _covid_params()
    tpe = t_packed.pack_replicas(tw, [_t_params(p) for p in plist],
                                 block_rows=BLOCK_ROWS)
    n = tpe.world.n_citizens
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, n)
    for rank, bits in ((tpe.world.wpos, 5), (tpe.world.work_perm, 1),
                       (tpe.world.rpos, 7)):
        rank = np.asarray(rank, np.int64)
        pay = (payload & ((1 << bits) - 1)).astype(np.int8)
        np.testing.assert_array_equal(
            t_runsums.permute_by_sort(T(rank), T(pay), bits=bits).numpy(),
            np.asarray(j_runsums.permute_by_sort(
                jnp.asarray(rank, jnp.uint32), jnp.asarray(pay), bits=bits)))


def test_row_bisection_matches_vmapped_jax():
    """One bisection over all rows against ``_kth_score_threshold`` under
    jax.vmap, with k from 0 to past the pool and ties at the answer."""
    rng = np.random.default_rng(7)
    R, M = 5, 3000
    scores = rng.integers(0, 2**32, (R, M), dtype=np.uint64).astype(np.uint32)
    scores[1, :50] = scores[1, 60]  # ties
    elig = rng.random((R, M)) < 0.6
    elig[3] = False
    k = np.array([0, 100, 1800, 5, 3000], np.int32)
    want = jax.vmap(j_fastpath._kth_score_threshold)(
        jnp.asarray(scores), jnp.asarray(elig), jnp.asarray(k))
    got = t_select.bisect_threshold_rows(T(scores.astype(np.int64)), T(elig),
                                         T(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("id_keyed", [False, True])
def test_bus_hits_with_rider_chances_match_jax(id_keyed):
    """Per-rider chances ride the shuffle; the id-keyed streams hash
    rider ids."""
    rng = np.random.default_rng(11)
    r, n = 5000, 9000
    route = np.sort(rng.integers(0, 40, r)).astype(np.int32)
    on, inf, susc, comp = (rng.random(r) < p for p in (0.6, 0.2, 0.7, 0.5))
    cid = rng.permutation(n)[:r].astype(np.int32)
    chance = rng.uniform(0, 0.4, r).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k_bus, k_b = jax.random.split(key)
    kd = lambda k: tuple(np.asarray(jax.random.key_data(k)).tolist())
    kw_j, kw_t = {}, {}
    if id_keyed:
        tie = rng.integers(0, 2**32, r, dtype=np.uint64).astype(np.uint32)
        kw_j = dict(tie_bits=jnp.asarray(tie), draw_seed=jnp.uint32(1234567))
        kw_t = dict(tie_bits=T(tie.astype(np.int64)), draw_seed=1234567)
    want = j_segments.bus_hits(
        k_bus, k_b, jnp.asarray(on), jnp.asarray(inf), jnp.asarray(susc),
        jnp.asarray(comp), jnp.asarray(route), jnp.asarray(cid), 20,
        lambda c, v, ch: ch, n, rb_chance=jnp.asarray(chance), **kw_j)
    got = t_segments.bus_hits(
        kd(k_bus), kd(k_b), T(on), T(inf), T(susc), T(comp), T(route), T(cid),
        20, lambda c, v, ch: ch, n, rb_chance=T(chance), **kw_t)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[4]) > 0


# --- whole packed runs ----------------------------------------------------


def _lanes(state):
    return {"status": np.asarray(state.status), "timer": np.asarray(state.timer),
            "sched": np.asarray(state.sched), "eligible": np.asarray(state.eligible),
            "lockdown": np.asarray(state.lockdown),
            "mask_status": np.asarray(state.mask_status),
            "vaccination_started": np.asarray(state.vaccination_started)}


def _run_both(jw, tw, plist, steps, status0=None, starting_infected=15,
              **cfg_kw):
    """The JAX and the port's packed runners from one packed state; the
    shared thresholds are the first replica's."""
    jpe = j_packed.pack_replicas(jw, plist, block_rows=BLOCK_ROWS)
    tpe = t_packed.pack_replicas(tw, [_t_params(p) for p in plist],
                                 block_rows=BLOCK_ROWS)
    js = j_packed.init_packed_state(jpe, seed=0,
                                    starting_infected=starting_infected)
    ts = t_packed.init_packed_state(tpe, seed=0,
                                    starting_infected=starting_infected,
                                    device="cpu")
    if status0 is not None:
        R, n, stride = jpe.n_replicas, jpe.rep_size, jpe.rep_stride
        packed = np.tile(np.concatenate([status0, np.full(stride - n, 5, np.int8)]), R)
        js = dataclasses.replace(js, status=jnp.asarray(packed))
        ts = dataclasses.replace(ts, status=T(packed))
    j_cfg = dataclasses.replace(J_CFG, max_steps=steps, chunk_size=steps, **cfg_kw)
    t_cfg = et.SimConfig(max_steps=steps, chunk_size=steps, **cfg_kw)
    js, j_seirv = j_packed.make_packed_runner(jpe, j_cfg)(
        plist[0].as_arrays().thresholds, js)
    ts, t_seirv = t_packed.make_packed_runner(tpe, t_cfg, device="cpu")(
        _t_params(plist[0]).thresholds, ts)
    return (np.asarray(j_seirv), _lanes(js)), (t_seirv.numpy(), {
        "status": ts.status.numpy(), "timer": ts.timer.numpy(),
        "sched": ts.sched.numpy(), "eligible": ts.eligible.numpy(),
        "lockdown": ts.lockdown, "mask_status": ts.mask_status,
        "vaccination_started": ts.vaccination_started})


def _assert_same(j, t):
    np.testing.assert_array_equal(t[0], j[0], "seirv")
    assert t[0].dtype == np.int32
    for name, lane in j[1].items():
        np.testing.assert_array_equal(t[1][name], lane, name)


@pytest.mark.parametrize("regime", ["deterministic", "covid", "covid_id_keyed"])
def test_packed_run_matches_jax(worlds, regime):
    """60 steps of three replicas with transport: the (T, R, 5) SEIRV and
    every final lane, pads included, bitwise."""
    jw, tw = worlds
    if regime == "deterministic":
        status0 = np.zeros(N, np.int8)
        status0[::191] = STATUS_INFECTED
        j, t = _run_both(jw, tw, _deterministic_params(), 60, status0=status0,
                         bus_capacity=8192)
    else:
        j, t = _run_both(jw, tw, _covid_params(), 60,
                         id_keyed_ensemble_rng=regime == "covid_id_keyed")
    _assert_same(j, t)
    seirv = t[0]
    assert (seirv.sum(2) == N).all()
    assert (seirv[:, 2, 1] == 0).all()  # chance 0: nobody exposed
    assert not np.array_equal(seirv[:, 0], seirv[:, 1])
    assert t[1]["vaccination_started"].any()
    if regime != "deterministic":
        assert t[1]["lockdown"].any() and (t[1]["mask_status"] > 0).any()


def test_id_keyed_streams_differ_from_counter_streams(worlds):
    """The id-keyed bus streams are other draws of the same law: the two
    runs part where a bus exposure first happens."""
    jw, tw = worlds
    plist = [_t_params(p) for p in _covid_params()]
    runs = [t_packed.run_packed_ensemble(
        tw, plist, et.SimConfig(max_steps=48, chunk_size=48,
                                id_keyed_ensemble_rng=k),
        block_rows=BLOCK_ROWS, device="cpu") for k in (False, True)]
    assert not np.array_equal(*runs)


def test_per_replica_thresholds_match_jax(worlds):
    """run_packed_ensemble with a threshold row per replica against the
    JAX package's."""
    jw, tw = worlds
    base = _covid_params()
    plist = [JParams(p.disease, dataclasses.replace(
        p.thresholds, lockdown=lk, vaccination=vx))
        for p, lk, vx in zip(base, (0.01, 0.5, -1.0), (0.005, -1.0, 0.02))]
    cfg = dataclasses.replace(J_CFG, max_steps=60, chunk_size=30)
    want = j_packed.run_packed_ensemble(jw, plist, cfg, seed=2,
                                        block_rows=BLOCK_ROWS)
    got = t_packed.run_packed_ensemble(
        tw, [_t_params(p) for p in plist],
        et.SimConfig(max_steps=60, chunk_size=30), seed=2,
        block_rows=BLOCK_ROWS, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (3, 60, 5)


def test_early_exit_rules(worlds):
    """With exposure chance 0 the epidemic dies while vaccination drains
    S: ``"ei"`` stops chunks earlier than ``"sei"``, and each run stops
    after the first chunk whose last row is over."""
    _, tw = worlds
    tw = _no_transport(tw)
    base = et.Params.covid()
    p = et.Params(dataclasses.replace(base.disease, exposure_chance=0.0,
                                      exposed_time=4, infected_time=25,
                                      vaccination_rate=600),
                  dataclasses.replace(base.thresholds, vaccination=0.0))
    cfg = et.SimConfig(max_steps=400, chunk_size=10, starting_infected=5)
    runs = {rule: t_packed.run_packed_ensemble(
        tw, [p, p], cfg, block_rows=16, early_exit=rule, device="cpu")
        for rule in ("sei", "ei")}
    for rule, seirv in runs.items():
        assert t_packed.ensemble_done(seirv[:, -1], rule)
        assert not t_packed.ensemble_done(seirv[:, -11], rule)
    assert runs["ei"].shape[1] < runs["sei"].shape[1] < 400
    np.testing.assert_array_equal(runs["ei"], runs["sei"][:, :runs["ei"].shape[1]])


def test_ensemble_done_semantics():
    row = np.array([[100, 0, 0, 5, 20], [0, 0, 0, 50, 10]], np.int64)
    row2 = np.array([[0, 0, 0, 105, 20], [0, 0, 0, 50, 10]], np.int64)
    row3 = np.array([[0, 0, 3, 102, 20], [0, 0, 0, 50, 10]], np.int64)
    for r in (row, row2, row3):
        for rule in ("sei", "ei"):
            assert t_packed.ensemble_done(r, rule) == j_packed.ensemble_done(r, rule)
    assert not t_packed.ensemble_done(row, "sei") and t_packed.ensemble_done(row, "ei")
    with pytest.raises(ValueError):
        t_packed.ensemble_done(row, "bogus")


def test_packed_matches_port_solo_deterministic(worlds):
    """Without transport, in the deterministic regime, each replica of the
    port's packed run equals the port's own solo fast_step run of its
    parameters."""
    _, tw = worlds
    tw = _no_transport(tw)
    plist = [_t_params(p) for p in _deterministic_params()]
    th = dataclasses.replace(plist[0].thresholds, lockdown=0.5, vaccination=-1.0)
    plist = [et.Params(dataclasses.replace(p.disease, vaccination_rate=0), th)
             for p in plist]
    status0 = np.zeros(N, np.int8)
    status0[::191] = STATUS_INFECTED
    steps = 50
    pe = t_packed.pack_replicas(tw, plist)
    st = t_packed.init_packed_state(pe, seed=0, starting_infected=0, device="cpu")
    packed0 = np.tile(np.concatenate(
        [status0, np.full(pe.rep_stride - N, 5, np.int8)]), pe.n_replicas)
    st = dataclasses.replace(st, status=T(packed0))
    cfg = et.SimConfig(max_steps=steps, chunk_size=steps)
    _, seirv = t_packed.make_packed_runner(pe, cfg, device="cpu")(th, st)
    world = tw.to("cpu")
    for r, params in enumerate(plist):
        state = dataclasses.replace(
            et.init_state(world, seed=0, starting_infected=0, device="cpu"),
            status=T(status0.copy()))
        _, out = et.make_chunk_runner(world, cfg)(params, state)
        np.testing.assert_array_equal(seirv[:, r].numpy(), out.seirv.numpy(),
                                      f"replica {r}")


def test_run_ensemble_matches_jax_and_refuses_the_rest(worlds):
    jw, tw = worlds
    plist = _covid_params()[:2]
    cfg = dataclasses.replace(J_CFG, max_steps=40, chunk_size=20)
    want = j_ensemble.run_ensemble(jw, plist, cfg, seed=1)
    tplist = [_t_params(p) for p in plist]
    t_cfg = et.SimConfig(max_steps=40, chunk_size=20)
    got = t_ensemble.run_ensemble(tw, tplist, t_cfg, seed=1, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(NotImplementedError):
        t_ensemble.run_ensemble(tw, tplist, t_cfg, engine="vmap", device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        t_ensemble.run_ensemble(tw, tplist, t_cfg, devices=3, device="cpu")
    with pytest.raises(ValueError):
        t_ensemble.run_ensemble(tw, tplist, t_cfg, engine="bogus", device="cpu")
    stacked = t_ensemble.stack_params(tplist)
    jst = j_ensemble.stack_params(plist)
    for part in ("disease", "thresholds"):
        for f in dataclasses.fields(getattr(jst, part)):
            a = getattr(getattr(stacked, part), f.name)
            b = np.asarray(getattr(getattr(jst, part), f.name))
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, f.name)


def test_derive_step_rng_matches_jax():
    key = jax.random.PRNGKey(9)
    hours = np.arange(5, 12, dtype=np.int32)
    want = j_packed.derive_step_rng(key, jnp.asarray(hours))
    got = t_packed.derive_step_rng(threefry.key(9), hours)
    kd = lambda k: tuple(np.asarray(jax.random.key_data(k)).tolist())
    for i, row in enumerate(got):
        assert row[0] == kd(want[0][i]) and row[1] == kd(want[1][i])
        assert list(row[2:]) == [int(np.asarray(w[i])) for w in want[2:]]

"""The port's ops, world and state against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Integer lanes must agree bitwise; the two float32 probability formulas
within a stated ulp bound (torch and XLA evaluate exp/log/expm1/log1p
with different float32 approximations).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.engine import state as j_state
from epidemicsimulator_tpu.ops import hashrng as j_hash
from epidemicsimulator_tpu.ops import maths as j_maths
from epidemicsimulator_tpu.ops import runsums as j_runsums
from epidemicsimulator_tpu.ops import segments as j_seg
from epidemicsimulator_tpu.ops import select as j_select
from epidemicsimulator_tpu.ops import sparse as j_sparse

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge
from epidemicsimulator_tpu_torch.engine import state as t_state
from epidemicsimulator_tpu_torch.ops import hashrng as t_hash
from epidemicsimulator_tpu_torch.ops import maths as t_maths
from epidemicsimulator_tpu_torch.ops import runsums as t_runsums
from epidemicsimulator_tpu_torch.ops import segments as t_seg
from epidemicsimulator_tpu_torch.ops import select as t_select
from epidemicsimulator_tpu_torch.ops import sparse as t_sparse
from epidemicsimulator_tpu_torch.ops import threefry

T = torch.from_numpy


def _u32(x):
    return np.asarray(x).astype(np.uint32).astype(np.int64)


# --- threefry ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, -1, -(2**31)])
def test_threefry_key_chain_matches_jax(seed):
    jk = jax.random.key(seed)
    tk = threefry.key(seed)
    assert tuple(_u32(jax.random.key_data(jk))) == tk
    for hour in (1, 2, 250, 5000):
        jf = jax.random.fold_in(jk, hour)
        tf = threefry.fold_in(tk, hour)
        assert tuple(_u32(jax.random.key_data(jf))) == tf
        for js, ts in zip(jax.random.split(jf, 5), threefry.split(tf, 5)):
            assert tuple(_u32(jax.random.key_data(js))) == ts
            assert int(jax.random.bits(js, (), jnp.uint32)) == threefry.bits(ts)


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4097])
def test_threefry_streams_match_jax(n):
    k = jax.random.fold_in(jax.random.key(3), n)
    tk = tuple(_u32(jax.random.key_data(k)))
    np.testing.assert_array_equal(
        threefry.bits(tk, n).numpy(),
        _u32(jax.random.bits(k, (n,), jnp.uint32)))
    np.testing.assert_array_equal(
        threefry.uniform(tk, n).numpy(), np.asarray(jax.random.uniform(k, (n,))))


# --- hash streams, formulas -------------------------------------------------

def test_hash_streams_match_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32)
    for seed in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
        jb = j_hash.hash_bits(jnp.uint32(seed), jnp.asarray(idx))
        np.testing.assert_array_equal(
            t_hash.hash_bits(seed, T(idx.astype(np.int64))).numpy(), _u32(jb))
        ju = j_hash.hash_uniform(jnp.uint32(seed), jnp.asarray(idx))
        np.testing.assert_array_equal(
            t_hash.hash_uniform(seed, T(idx.astype(np.int64))).numpy(),
            np.asarray(ju))


def _probability_inputs():
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.random(50_000) * 0.01, rng.random(50_000)])
    p = np.concatenate([p, [0.0, 1.0, 0.00055, 0.000165]]).astype(np.float32)
    n = rng.integers(0, 300, p.shape[0]).astype(np.int32)
    n[-4:] = [3, 0, 1, 2]
    return p, n


def test_binomial_within_8_ulp_of_jax():
    """-expm1(n log1p(-p)): both libraries' float32 expm1/log1p are
    faithful to a few ulp; the difference measured here is at most 5."""
    p, n = _probability_inputs()
    a = np.asarray(j_maths.binomial_at_least_one(jnp.asarray(p), jnp.asarray(n)))
    b = t_maths.binomial_at_least_one(T(p), T(n)).numpy()
    assert b.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    ulp = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    assert ulp[ok].max() <= 8


def test_home_probability_within_2_ulp_of_one():
    """1 - exp(n log(1-p)) as the fused kernel writes it: the exp value
    lies in (0, 1], where an ulp is at most 2**-24, and the subtraction
    from 1 is exact; the difference is at most two such ulps."""
    p, n = _probability_inputs()
    a = np.asarray(1.0 - jnp.exp(jnp.asarray(n, jnp.float32)
                                 * jnp.log(1.0 - jnp.asarray(p))))
    b = t_maths.home_probability(T(p), T(n)).numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    assert np.abs(a - b)[ok].max() <= 2 * 2.0**-24


def test_truncate_u8_matches_jax():
    n = np.arange(-3, 1000, dtype=np.int32)
    np.testing.assert_array_equal(t_maths.truncate_u8(T(n)).numpy(),
                                  np.asarray(j_maths.truncate_u8(jnp.asarray(n))))


# --- run sums ---------------------------------------------------------------

def _random_runs(rng, n, avg_run, within=None):
    start = rng.random(n) < 1.0 / avg_run
    start[0] = True
    if within is not None:
        start |= within
    end = np.empty(n, bool)
    end[:-1] = start[1:]
    end[-1] = True
    return start, end


@pytest.mark.parametrize("n,avg", [(1, 1), (97, 3), (5000, 1), (20_000, 40)])
def test_run_and_range_totals_match_jax(n, avg):
    rng = np.random.default_rng(n)
    v = (rng.random(n) < 0.3).astype(np.int32)
    s, e = _random_runs(rng, n, avg)
    np.testing.assert_array_equal(
        t_runsums.run_totals(T(v), T(s), T(e)).numpy(),
        np.asarray(j_runsums.run_totals(jnp.asarray(v), jnp.asarray(s), jnp.asarray(e))))
    hi = np.sort(rng.integers(0, n + 1, 50)).astype(np.int32)
    lo = np.minimum(hi, rng.integers(0, n + 1, 50)).astype(np.int32)
    np.testing.assert_array_equal(
        t_runsums.range_totals(T(v), T(lo), T(hi)).numpy(),
        np.asarray(j_runsums.range_totals(jnp.asarray(v), jnp.asarray(lo), jnp.asarray(hi))))


# --- sparse -----------------------------------------------------------------

@pytest.mark.parametrize("n,density,block", [(1000, 0.01, 128), (3000, 0.9, 1024)])
def test_compaction_matches_jax(n, density, block):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < density
    jh = j_sparse.block_hierarchy(jnp.asarray(mask), block=block)
    th = t_sparse.block_hierarchy(T(mask), block=block)
    np.testing.assert_array_equal(th[1].numpy(), np.asarray(jh[1]))
    assert int(th[2]) == int(jh[2])
    for k, offset in ((64, 5), (4096, 0), (16, 10_000)):
        jp = j_sparse.compact_from_hierarchy(jh, k, offset, n=n, sb=128)
        tp = t_sparse.compact_from_hierarchy(th, k, offset, n=n, sb=128)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jc = j_sparse.compact_positions(jnp.asarray(mask), 64, offset=3)
    tc = t_sparse.compact_positions(T(mask), 64, offset=3)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dest = rng.integers(0, n + 10, 300).astype(np.int32)
    live = rng.random(300) < 0.5
    np.testing.assert_array_equal(
        t_sparse.scatter_bits(n, T(dest), T(live)).numpy(),
        np.asarray(j_sparse.scatter_bits(n, jnp.asarray(dest), jnp.asarray(live))))


# --- bus --------------------------------------------------------------------

def test_shuffle_order_is_lax_sort_on_signed_ties():
    """Many equal routes and equal ties, ties on both sides of 2**31."""
    rng = np.random.default_rng(5)
    r = 4000
    rk = rng.integers(0, 30, r).astype(np.int32)
    rk[rng.random(r) < 0.3] = 2**31 - 1
    tie = rng.choice(np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1],
                              np.uint32), r)
    idx = jnp.arange(r, dtype=jnp.int32)
    j_rk, _, j_idx = jax.lax.sort(
        (jnp.asarray(rk), jnp.asarray(tie).astype(jnp.int32), idx), num_keys=2)
    t_rk, t_idx = t_seg.shuffle_order(T(rk.astype(np.int64)), T(tie.astype(np.int64)))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_rk.numpy(), np.asarray(j_rk))


def _bus_inputs(seed, r=6000, n=20_000):
    rng = np.random.default_rng(seed)
    on = rng.random(r) < 0.7
    inf = rng.random(r) < 0.08
    susc = rng.random(r) < 0.8
    compliant = rng.random(r) < 0.8
    route = np.sort(rng.integers(0, 150, r)).astype(np.int32)
    cit = np.sort(rng.choice(n, r, replace=False)).astype(np.int32)
    return on, inf, susc, compliant, route, cit, n


def _p_fns(mask_status):
    def j_p(compliant, on_bus):
        active = (mask_status == 2) & ~compliant
        return jnp.float32(0.05) * jnp.where(active, jnp.float32(0.3), 1.0)

    def t_p(compliant, on_bus):
        active = (mask_status == 2) & ~compliant
        return torch.tensor(0.05, dtype=torch.float32) * torch.where(
            active, torch.tensor(0.3, dtype=torch.float32),
            torch.tensor(1.0, dtype=torch.float32))

    return j_p, t_p


@pytest.mark.parametrize("seed,capacity", [(0, 20), (2, 7)])
def test_bus_hits_match_jax(seed, capacity):
    on, inf, susc, compliant, route, cit, n = _bus_inputs(seed)
    j_p, t_p = _p_fns(2)
    kj = jax.random.split(jax.random.key(seed), 2)
    kt = [tuple(_u32(jax.random.key_data(k))) for k in kj]
    j_out = j_seg.bus_hits(kj[0], kj[1], *map(jnp.asarray, (on, inf, susc, compliant, route, cit)),
                           capacity, j_p, n)
    t_cit, t_rider, t_n = t_seg.bus_hits(kt[0], kt[1], *map(T, (on, inf, susc, compliant, route, cit)),
                                         capacity, t_p, n)
    assert int(t_n) == int(j_out[4]) > 0
    np.testing.assert_array_equal(t_cit.numpy(), np.asarray(j_out[0]))
    np.testing.assert_array_equal(t_rider.numpy(), np.asarray(j_out[1]))

    def j_susc(ids):
        return jnp.asarray(susc)[jnp.minimum(ids, len(susc) - 1)]

    def t_susc(ids):
        return T(susc)[ids.long()]

    js = j_seg.bus_hits_sortless(kj[0], kj[1], *map(jnp.asarray, (on, inf, compliant, route, cit)),
                                 capacity, j_p, j_susc, max_hits=512)
    ts = t_seg.bus_hits_sortless(kt[0], kt[1], *map(T, (on, inf, compliant, route, cit)),
                                 capacity, t_p, t_susc, max_hits=512)
    live = np.asarray(js[2])
    np.testing.assert_array_equal(ts[2].numpy(), live)
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))
    np.testing.assert_array_equal(ts[1].numpy()[live], np.asarray(js[1])[live])
    np.testing.assert_array_equal(ts[4].numpy()[live], np.asarray(js[4])[live])
    assert int(ts[3]) == int(js[3]) == int(t_n)
    assert int(ts[5]) == int(js[5])


# --- vaccination selection --------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 1530, 10_000])
def test_kth_threshold_matches_jax(k):
    rng = np.random.default_rng(k)
    n = 9000
    eligible = rng.random(n) < 0.45
    n_el = int(eligible.sum())
    seed = 0x1234567
    want = int(j_select.kth_threshold(jnp.uint32(seed), jnp.asarray(eligible),
                                      jnp.int32(k), jnp.int32(n_el)))
    sampled = int(j_select.kth_threshold(
        jnp.uint32(seed), jnp.asarray(eligible), jnp.int32(k), jnp.int32(n_el),
        force_sampled=True, sample_log2=10))
    got = int(t_select.kth_threshold(seed, T(eligible), k, n_el))
    assert got == want == sampled


# --- world, state, bridge ---------------------------------------------------

def test_synthetic_world_lane_for_lane():
    jw = j_world(3000, n_output_areas=6, seed=4)
    tw = et.generate_synthetic_world(3000, n_output_areas=6, seed=4)
    for f in dataclasses.fields(jw):
        a, b = getattr(jw, f.name), getattr(tw, f.name)
        if f.metadata.get("static"):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), f.name)
            assert np.asarray(b).dtype == np.asarray(a).dtype, f.name


def test_bridge_world_to_device_round_trip():
    jw = j_world(3000, n_output_areas=6, seed=4)
    names = [f.name for f in dataclasses.fields(jw) if not f.metadata.get("static")]
    tw = bridge.world_from_arrays(
        {k: np.asarray(getattr(jw, k)) for k in names},
        n_buildings=jw.n_buildings, n_rooms=jw.n_rooms,
        n_output_areas=jw.n_output_areas,
        max_household_size=jw.max_household_size, device="cpu")
    for k in names:
        lane = getattr(tw, k)
        assert isinstance(lane, torch.Tensor) and lane.device.type == "cpu"
        np.testing.assert_array_equal(lane.numpy(), np.asarray(getattr(jw, k)), k)


def test_init_state_and_sched_packing_match_jax():
    jw = j_world(20_000, n_output_areas=12, seed=1)
    tw = et.generate_synthetic_world(20_000, n_output_areas=12, seed=1)
    js = j_state.init_state(jw, seed=9, starting_infected=77)
    ts = et.init_state(tw, seed=9, starting_infected=77, device="cpu")
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    assert ts.rng_key == tuple(_u32(jax.random.key_data(js.rng_key)))
    rng = np.random.default_rng(2)
    lanes = {k: rng.random(jw.n_citizens) < 0.5 for k in t_state.SCHED_LANES}
    jp = j_state.pack_sched(dataclasses.replace(js, **{k: jnp.asarray(v) for k, v in lanes.items()}))
    tp = t_state.pack_sched(*(T(lanes[k]) for k in t_state.SCHED_LANES))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.sched))
    for k, v in t_state.unpack_sched(tp).items():
        np.testing.assert_array_equal(v.numpy(), lanes[k])


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tw = et.generate_synthetic_world(500, n_output_areas=2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        et.init_state(tw)


@pytest.mark.parametrize("n", [15_999_999, 16_000_000, 63_000_000])
def test_port_refuses_the_fixed_priority_formulation(n):
    """From 16M citizens on, the JAX package's default step vaccinates from
    the fixed-priority pool: the port's wants_fixed_priority_vax resolves
    as the JAX one on stand-in worlds (no 16M world is built), for every
    setting of SimConfig.vaccination_fixed_priority and with and without
    the fast tables, and init_state allocates the pool's lanes exactly
    when the JAX init_state does."""
    from epidemicsimulator_tpu import SimConfig as JSimConfig
    from epidemicsimulator_tpu.engine.fastpath import wants_fixed_priority_vax

    from epidemicsimulator_tpu_torch.engine import fastpath as t_fastpath

    for fast in (True, False):
        world = types.SimpleNamespace(n_citizens=n, has_fast_tables=fast)
        for setting in (None, True, False):
            want = wants_fixed_priority_vax(
                world, JSimConfig(vaccination_fixed_priority=setting))
            got = t_fastpath.wants_fixed_priority_vax(
                world, et.SimConfig(vaccination_fixed_priority=setting))
            assert got == want, (fast, setting)
            if setting is None:
                assert want == (fast and n >= 16_000_000)
    flag = t_fastpath.wants_fixed_priority_vax(
        types.SimpleNamespace(n_citizens=n, has_fast_tables=True), et.SimConfig())
    jw = j_world(500, n_output_areas=2, seed=0)
    tw = et.generate_synthetic_world(500, n_output_areas=2, seed=0)
    js = j_state.init_state(jw, seed=0, fixed_priority_vax=flag)
    ts = et.init_state(tw, seed=0, fixed_priority_vax=flag, device="cpu")
    assert ts.vax_pool.shape == np.asarray(js.vax_pool).shape == ((500,) if flag else (0,))
    assert ts.vax_pool.dtype == torch.int32 and np.asarray(js.vax_pool).dtype == np.int32
    np.testing.assert_array_equal(ts.vax_pool.numpy(), np.asarray(js.vax_pool))
    assert ts.vax_pool_size.shape == () and int(ts.vax_pool_size) == int(js.vax_pool_size) == 0

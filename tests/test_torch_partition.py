"""The pieces of the population-sharded engine that run on the host or in
one process, against the JAX package on the CPU: the partition
(``parallel/partition.py``), the sharded initial state, B1's ``gid0``
mode (its plain version against the Pallas kernel in interpret mode, in
both the one-world and the ensemble mode), a rank's packing against the
JAX package's row-relative orders, the sharded vaccination selector on
one rank, and the options of the JAX sharded engine that the port
refuses.  Every
comparison is bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.engine import packed as j_packed
from epidemicsimulator_tpu.ops import pallas_citizen as j_cit
from epidemicsimulator_tpu.ops import runsums as j_runsums
from epidemicsimulator_tpu.parallel import fastmesh as j_fastmesh
from epidemicsimulator_tpu.parallel import partition as j_part

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge
from epidemicsimulator_tpu_torch.engine import packed as t_packed
from epidemicsimulator_tpu_torch.ops import citizen as t_cit
from epidemicsimulator_tpu_torch.ops import runsums as t_runsums
from epidemicsimulator_tpu_torch.ops import select as t_select
from epidemicsimulator_tpu_torch.ops.hashrng import hash_bits, hash_uniform
from epidemicsimulator_tpu_torch.parallel import comm, fastmesh, partition

T = torch.from_numpy
N, N_OA, WORLD_SEED = 6000, 14, 8
GID0S = [0, 12_345, 2**31 - 7]


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


@pytest.fixture(scope="module")
def worlds():
    return (j_world(N, n_output_areas=N_OA, seed=WORLD_SEED),
            et.generate_synthetic_world(N, n_output_areas=N_OA,
                                        seed=WORLD_SEED))


def _fields(sw):
    return {f.name: getattr(sw, f.name) for f in dataclasses.fields(sw)}


@pytest.mark.parametrize("transport", [True, False])
@pytest.mark.parametrize("n_dev", [2, 3, 4, 8])
def test_partition_matches_jax(worlds, n_dev, transport):
    """Every array and static of ``partition_world``, and its stats."""
    jw, tw = worlds
    if not transport:
        jw, tw = _no_transport(jw), _no_transport(tw)
    j_stats, t_stats = {}, {}
    want = _fields(j_part.partition_world(jw, n_dev, stats=j_stats))
    got = _fields(partition.partition_world(tw, n_dev, stats=t_stats))
    assert got.keys() == want.keys()
    for name, b in want.items():
        a = got[name]
        if isinstance(b, int):
            assert a == b, name
        else:
            b = np.asarray(b)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, name)
    assert t_stats == j_stats
    # a rank's row
    one = partition.shard(partition.partition_world(tw, n_dev), n_dev - 1)
    np.testing.assert_array_equal(one.sort_rank,
                                  np.asarray(want["sort_rank"])[n_dev - 1])
    assert one.shard_size == want["shard_size"]


@pytest.mark.parametrize("n_dev", [3, 4])
def test_state_layout_matches_jax(worlds, n_dev):
    """The sharded initial state in the padded shard layout, lane for
    lane, and ``gather_state_arrays(shard_state_arrays(...))`` round
    trip, as the JAX package's."""
    jw, tw = worlds
    jsw = j_part.partition_world(jw, n_dev)
    tsw = partition.partition_world(tw, n_dev)
    jst = j_fastmesh.init_sharded_state(jw, jsw, seed=3, starting_infected=25)
    tst = fastmesh.init_sharded_state(tw, tsw, seed=3, starting_infected=25)
    for name in ("status", "timer", "eligible"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)), name)
    for bit, name in enumerate(("at_work", "on_bus", "bus_to_work")):
        np.testing.assert_array_equal(((tst.sched >> bit) & 1).bool().numpy(),
                                      np.asarray(getattr(jst, name)), name)
    assert tst.vax_pool.shape == (0,) == np.asarray(jst.vax_pool).shape
    rng = np.random.default_rng(n_dev)
    lanes = {"a": (rng.integers(0, 9, N).astype(np.int8), 5),
             "b": (rng.random(N) < 0.5, False)}
    for pkg, sw in ((j_part, jsw), (partition, tsw)):
        stacked = pkg.shard_state_arrays(sw, lanes)
        back = pkg.gather_state_arrays(sw, stacked)
        for name, (lane, _) in lanes.items():
            np.testing.assert_array_equal(back[name], lane)
    t_stacked = partition.shard_state_arrays(tsw, lanes)
    j_stacked = j_part.shard_state_arrays(jsw, lanes)
    for name in lanes:
        np.testing.assert_array_equal(t_stacked[name], j_stacked[name])


def _assert_b1_equal(got, want, seed, gid0, n_reps=None):
    """Every output lane and the census equal, except that a home hit may
    differ where its uniform lies within 2**-23 of the home probability:
    torch's and XLA's float32 exp and log may differ in the last bits
    (test_torch_ops.py), and a draw on the grid of 2**-24 can fall
    between the two values.  Returns the home hits."""
    q = got[5]
    idx = (torch.arange(q.shape[0], dtype=torch.int64) + gid0) & 0xFFFFFFFF
    u = hash_uniform(seed, idx)
    flip = ((got[3] & 4) != 0).numpy() != ((np.asarray(want[3]) & 4) != 0)
    assert (np.abs(u.numpy() - q.numpy())[flip] <= 2.0**-23).all()
    keep = ~flip
    for a, b, name in zip(got[:4], want[:4], ("status", "timer", "sched",
                                              "gates")):
        np.testing.assert_array_equal(a.numpy()[keep], np.asarray(b)[keep],
                                      name)
    census = np.asarray(want[4])
    census = (census.reshape(n_reps, -1, 8).sum(1) if n_reps
              else census.sum(0))
    got_census = got[4].numpy()
    np.testing.assert_array_equal(got_census[..., :7], census[..., :7])
    assert np.abs(got_census[..., 7] - census[..., 7]).sum() <= flip.sum()
    return got_census[..., 7]


def _random_state(n, rng, pads=None):
    status = rng.choice(5, n, p=[0.7, 0.1, 0.1, 0.05, 0.05]).astype(np.int8)
    if pads is not None:
        status[pads] = 5
    timer = rng.integers(0, 40, n).astype(np.int32)
    sched = rng.integers(0, 32, n).astype(np.int8)
    return status, timer, sched, int(rng.integers(0, 2**32))


@pytest.mark.parametrize("gid0", GID0S)
def test_b1_gid0_matches_pallas(worlds, gid0):
    """B1's plain version with ``gid0`` against the Pallas kernel with the
    same ``int_scalars[6]``, on one shard of the partitioned world: every
    output lane and the census (:func:`_assert_b1_equal`).  The hash index
    wraps as a u32."""
    jw, tw = worlds
    jsw = j_part.partition_world(jw, 3)
    tsw = partition.shard(partition.partition_world(tw, 3), 1)
    sq = lambda x: jnp.asarray(np.asarray(x)[1])[None]
    j_statics = j_fastmesh._shard_citizen_statics(jsw, lambda x: sq(x)[0])
    t_statics = fastmesh.shard_citizen_statics(tsw, "cpu")
    n = tsw.shard_size
    rng = np.random.default_rng(gid0 % 1000)
    status, timer, sched, seed = _random_state(n, rng, tsw.global_id < 0)
    f32 = np.float32
    p0, scale = f32(0.6), f32(1.0) - f32(0.7)
    ints = jnp.asarray([20, 1, 1, np.uint32(seed).view(np.int32), 6, 12,
                        np.uint32(gid0).view(np.int32), 0], jnp.int32)
    want = j_cit.citizen_phase(
        j_statics, jnp.asarray(status), jnp.asarray(timer), jnp.asarray(sched),
        ints, jnp.asarray([p0, scale], jnp.float32), K=tsw.max_household_size,
        ref_mask_sem=False, u8_trunc=True, block_rows=32, interpret=True)
    got = t_cit.citizen_phase_plain(
        t_statics, T(status), T(timer), T(sched), h24=20, move=True,
        mask_status=1, seed=seed, exposed_time=6, infected_time=12,
        exposure_chance=p0, mask_scale=scale, K=tsw.max_household_size,
        ref_mask_sem=False, u8_trunc=True, gid0=gid0, want_q=True)
    assert _assert_b1_equal(got, want, seed, gid0) > 0  # home hits happened
    # the offset moves the draws: gid0 = 0 gives other hits
    other = t_cit.citizen_phase_plain(
        t_statics, T(status), T(timer), T(sched), h24=20, move=True,
        mask_status=1, seed=seed, exposed_time=6, infected_time=12,
        exposure_chance=p0, mask_scale=scale, K=tsw.max_household_size,
        ref_mask_sem=False, u8_trunc=True, gid0=(gid0 + 1) % 2**32)
    assert not torch.equal(other[3], got[3])


@pytest.mark.parametrize("gid0", GID0S)
def test_b1_gid0_ensemble_matches_pallas(worlds, gid0):
    """B1's ensemble mode with ``gid0``: two replicas of a 3,000-citizen
    world, the rows differing, against the Pallas kernel, as in
    :func:`test_b1_gid0_matches_pallas`."""
    base = JParams.covid()
    plist = [JParams(dataclasses.replace(base.disease, exposure_chance=ch),
                     base.thresholds) for ch in (0.2, 0.05)]
    jw = j_world(3000, n_output_areas=6, seed=2)
    tw = et.generate_synthetic_world(3000, n_output_areas=6, seed=2)
    jpe = j_packed.pack_replicas(jw, plist, block_rows=32)
    tpe = t_packed.pack_replicas(
        tw, [bridge.params_from_values(dataclasses.asdict(p.disease),
                                       dataclasses.asdict(p.thresholds))
             for p in plist], block_rows=32)
    n = jpe.world.n_citizens
    rng = np.random.default_rng(gid0 % 997)
    pads = np.tile(np.arange(jpe.rep_stride) >= jpe.rep_size, 2)
    status, timer, sched, seed = _random_state(n, rng, pads)
    f32 = np.float32
    rep_ints = np.array([[1, 2, 6, 12], [1, 0, 10, 20]], np.int32)
    rep_f32s = np.array([[0.2, f32(1) - f32(0.7)], [0.05, f32(1) - f32(0.7)]],
                        np.float32)
    ints = jnp.asarray([8, 0, 0, np.uint32(seed).view(np.int32), 0, 0,
                        np.uint32(gid0).view(np.int32), 0], jnp.int32)
    want = j_cit.citizen_phase(
        j_cit.make_citizen_statics(jpe.world), jnp.asarray(status),
        jnp.asarray(timer), jnp.asarray(sched), ints,
        jnp.zeros(2, jnp.float32), K=jpe.world.max_household_size,
        ref_mask_sem=True, u8_trunc=True, block_rows=32, interpret=True,
        n_citizens=n, rep_ints=jnp.asarray(rep_ints),
        rep_f32s=jnp.asarray(rep_f32s), blocks_per_rep=jpe.blocks_per_rep)
    got = t_cit.citizen_phase_plain(
        t_cit.make_citizen_statics(tpe.world.to("cpu")), T(status), T(timer),
        T(sched), h24=8, seed=seed, K=tpe.world.max_household_size,
        ref_mask_sem=True, u8_trunc=True, rep_ints=T(rep_ints),
        rep_f32s=T(rep_f32s), tiles_per_rep=tpe.rep_stride // t_cit.CITIZEN_TILE,
        gid0=gid0, want_q=True)
    assert _assert_b1_equal(got, want, seed, gid0, n_reps=2).min() > 0


def test_b1_refuses_gid0_outside_u32(worlds):
    _, tw = worlds
    statics = t_cit.make_citizen_statics(tw.to("cpu"))
    z8 = torch.zeros(tw.n_citizens, dtype=torch.int8)
    for bad in (-1, 2**32):
        with pytest.raises(ValueError, match="gid0"):
            t_cit.citizen_phase(statics, z8, z8.int(), z8, h24=0, move=True,
                                mask_status=0, seed=0, exposed_time=1,
                                infected_time=1, exposure_chance=0.1,
                                mask_scale=0.3, K=4, ref_mask_sem=True,
                                u8_trunc=True, gid0=bad)


def test_perm_rels_and_row_permutes_match_jax():
    """A rank of the replica-sharded ensemble packs its own replicas, so
    ``permute_by_sort`` on its local ``wpos`` and ``work_perm`` gives the
    JAX package's row-relative permutes (``make_perm_rels`` and
    ``permute_by_sort_rows``) of the whole four-replica packing, block for
    block, with no row-relative ranks of its own."""
    plist = [JParams.covid()] * 4
    jw = j_world(3000, n_output_areas=6, seed=5)
    tw = et.generate_synthetic_world(3000, n_output_areas=6, seed=5)
    jpe = j_packed.pack_replicas(jw, plist, block_rows=16)
    rels = j_packed.make_perm_rels(jpe.world, 4, jpe.rep_stride)[:2]
    payload = np.random.default_rng(0).integers(0, 32, jpe.world.n_citizens,
                                                dtype=np.int8)
    want = [np.asarray(j_runsums.permute_by_sort_rows(
        rel, jnp.asarray(payload), 4, bits=5)) for rel in rels]
    for r in range(2):  # two ranks of two replicas each
        tpe = t_packed.pack_replicas(tw, [et.Params.covid()] * 2,
                                     block_rows=16)
        lanes = slice(2 * r * tpe.rep_stride, 2 * (r + 1) * tpe.rep_stride)
        world = tpe.world.to("cpu")
        for rank, w in zip((world.wpos, world.work_perm), want):
            got = t_runsums.permute_by_sort(rank, T(payload[lanes]), bits=5)
            np.testing.assert_array_equal(got.numpy(), w[lanes])


@pytest.mark.parametrize("k", [0, 1, 37, 900])
def test_sharded_selector_on_one_rank(k):
    """On one rank the sampled band (forced, a small sample) and the
    bisection both give the k-th smallest eligible score exactly."""
    group = comm.RankGroup(0, 1, comm.placement(1, "cpu"))
    rng = np.random.default_rng(k)
    eligible = T(rng.random(20_000) < 0.4)
    scores = hash_bits(12345, torch.arange(20_000, dtype=torch.int64))
    n_elig = eligible.sum(dtype=torch.int32)
    kk = torch.tensor(k, dtype=torch.int32)
    sorted_scores = np.sort(scores[eligible].numpy())
    want = 0 if k == 0 else int(sorted_scores[k - 1])
    for forced in (True, False):
        got = t_select.kth_threshold_sharded(
            scores, eligible, kk, n_elig, group, force_sampled=forced,
            sample_log2=8)
        assert int(got) == want, forced


@pytest.mark.parametrize("flag,value", [
    ("use_sortless_sharded", True), ("use_sparse_workback", True),
    ("debug_shard_parts", 2), ("debug_force_gates", (True, None)),
    ("debug_bus_hit_slots", 64)])
def test_not_ported_options_raise(flag, value):
    """Each of the JAX package's options that the port does not carry
    raises NotImplementedError naming it when the config is made, so no
    entry point (one card, sharded, ensemble) can run with it ignored;
    the values that mean "off" are accepted."""
    with pytest.raises(NotImplementedError, match=flag):
        et.SimConfig(max_steps=4, chunk_size=4, **{flag: value})
    off = {"use_sortless_sharded": False, "use_sparse_workback": False,
           "debug_shard_parts": 0}
    if flag in off:
        assert getattr(et.SimConfig(**{flag: off[flag]}), flag) == off[flag]

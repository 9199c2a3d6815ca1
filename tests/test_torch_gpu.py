"""The CUDA kernels of the port against their plain torch versions, on a
card.  Every test here is marked ``gpu`` and skips without a CUDA device.
This file imports nothing of JAX; run it on a machine with a card as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the CPU tests).
"""

import dataclasses
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import runtime
from epidemicsimulator_tpu_torch.engine import packed
from epidemicsimulator_tpu_torch.ops import benes, citizen, scans

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tool(name):
    """A module of tools/ by file path (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _runs(rng, n, avg_run, within=None):
    start = rng.random(n) < 1.0 / avg_run
    start[0] = True
    if within is not None:
        start |= within
    end = np.empty(n, bool)
    end[:-1] = start[1:]
    end[-1] = True
    return start, end


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 16_383, 16_384, 16_385,
                               1_000_003, 16_777_217])
def test_cumsum_kernel_matches_plain(cuda, n):
    """B3 (a tile is 16,384 elements in four sub-tiles of 4,096): lanes of
    0-3, of any int8 and of bools, and the same lane one byte off 16-byte
    alignment."""
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.integers(0, 4, n).astype(np.int8)).to(cuda)
    assert torch.equal(scans.cumsum_i8(v), scans.cumsum_i8_plain(v))
    b = v > 1
    assert torch.equal(scans.cumsum_i8(b), scans.cumsum_i8_plain(b))
    w = torch.from_numpy(rng.integers(-128, 128, n + 1).astype(np.int8)).to(cuda)
    for lane in (w[:n], w[1:]):
        assert torch.equal(scans.cumsum_i8(lane), scans.cumsum_i8_plain(lane))


def test_cumsum_kernel_back_to_back(cuda):
    """50 calls of different lengths on one stream with no sync between
    them: each call's look-back must read only its own descriptors, not
    the flags an earlier call left in recycled scratch."""
    rng = np.random.default_rng(50)
    lanes = [torch.from_numpy(rng.integers(-128, 128, int(n)).astype(np.int8)).to(cuda)
             for n in rng.integers(1, 300_000, 50)]
    torch.cuda.synchronize()
    got = [scans.cumsum_i8(v) for v in lanes]
    for v, g in zip(lanes, got):
        assert torch.equal(g, scans.cumsum_i8_plain(v))


def test_cumsum_kernel_total_near_int32_max(cuda):
    n = (2**31 - 1) // 127
    v = torch.full((n,), 127, dtype=torch.int8, device=cuda)
    got = scans.cumsum_i8(v)
    assert int(got[-1]) == 127 * n > 2**31 - 128
    assert torch.equal(got, scans.cumsum_i8_plain(v))


@pytest.mark.parametrize("n", [1, 1023, 1025, 16_383, 16_384, 16_385,
                               3 * 16_384 + 5, 70_001, 200_001, 1_000_003])
def test_cumsum_2phase_kernel_matches_plain(cuda, n):
    """B4 (units of 16,384 elements) on a signed int8 lane and a bool
    lane, against its plain version and B3's."""
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(cuda)
    want = scans.cumsum_i8_2phase_plain(v)
    assert torch.equal(scans.cumsum_i8_2phase(v), want)
    assert torch.equal(want, scans.cumsum_i8_plain(v))
    b = v > 0
    got = scans.cumsum_i8_2phase(b)
    assert torch.equal(got, scans.cumsum_i8_2phase_plain(b))
    assert torch.equal(got, scans.cumsum_i8_plain(b))


@pytest.mark.parametrize("n", [16_385, 1_000_003])
def test_cumsum_2phase_kernel_reads_an_unaligned_lane(cuda, n):
    """A view one byte off 16-byte alignment."""
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.integers(-128, 128, n + 1).astype(np.int8)).to(cuda)
    assert w[1:].data_ptr() % 16 == 1
    assert torch.equal(scans.cumsum_i8_2phase(w[1:]),
                       scans.cumsum_i8_2phase_plain(w[1:]))


def test_cumsum_2phase_kernel_back_to_back(cuda):
    """50 calls of different lengths on one stream with no sync between
    them: each call's memset resets the ticket, so each call's last
    reduce block is its own."""
    rng = np.random.default_rng(51)
    lanes = [torch.from_numpy(rng.integers(-128, 128, int(n)).astype(np.int8)).to(cuda)
             for n in rng.integers(1, 300_000, 50)]
    torch.cuda.synchronize()
    got = [scans.cumsum_i8_2phase(v) for v in lanes]
    for v, g in zip(lanes, got):
        assert torch.equal(g, scans.cumsum_i8_2phase_plain(v))


def test_cumsum_2phase_kernel_total_near_int32_max(cuda):
    n = (2**31 - 1) // 127
    v = torch.full((n,), 127, dtype=torch.int8, device=cuda)
    got = scans.cumsum_i8_2phase(v)
    assert int(got[-1]) == 127 * n > 2**31 - 128
    assert torch.equal(got, scans.cumsum_i8_2phase_plain(v))


def _inverse(src):
    inv = np.empty_like(src)
    inv[src] = np.arange(src.shape[0], dtype=src.dtype)
    return inv


@pytest.mark.parametrize("n", [2, 1000, 40_000, 100_003, 2_500_000])
def test_benes_kernel_matches_plain_and_gather(cuda, n):
    """Routed tables: k = 10 (middle pass only), 16, 17 and 22 (an outer
    pass on each side); forward and reverse against the plain replay and
    the gathers."""
    rng = np.random.default_rng(n)
    src = rng.permutation(n).astype(np.int64)
    ctrl, k = benes.route_permutation(src)
    ctrl = ctrl.to(cuda)
    x = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(cuda)
    for reverse, idx in ((False, src), (True, _inverse(src))):
        got = benes.benes_permute(x, ctrl, k, reverse=reverse)
        assert torch.equal(got, benes.benes_permute_plain(
            x, ctrl, k, reverse=reverse))
        assert torch.equal(got, x[torch.from_numpy(idx).to(cuda)])


@pytest.mark.parametrize("k", [10, 12, 13, 14, 15, 16, 17, 19, 22, 23])
def test_benes_kernel_matches_plain_on_random_ctrl(cuda, k):
    """Control bytes that no router made: each element reads its own bit.
    The kernel's tile is 2^13 bytes: k = 10 and 12 run on a smaller one,
    13 on one tile with no outer pass, 14-22 with one outer pass of k - 13
    stages on each side, 23 with two on each side."""
    rng = np.random.default_rng(k)
    n2 = 1 << k
    ctrl = torch.from_numpy(rng.integers(
        0, 256, ((2 * k - 1 + 7) // 8, n2)).astype(np.uint8)).to(cuda)
    for n, n_out in ((n2, n2), (n2 - 3, n2 - 3), (n2 // 2 + 1, 100)):
        x = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(cuda)
        for reverse in (False, True):
            assert torch.equal(
                benes.benes_permute(x, ctrl, k, reverse=reverse, n_out=n_out),
                benes.benes_permute_plain(x, ctrl, k, reverse=reverse,
                                          n_out=n_out))


def test_benes_kernel_reads_an_unaligned_payload(cuda):
    k = 16
    rng = np.random.default_rng(7)
    ctrl = torch.from_numpy(rng.integers(
        0, 256, ((2 * k - 1 + 7) // 8, 1 << k)).astype(np.uint8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, 50_001).astype(np.int8)).to(cuda)
    for reverse in (False, True):
        assert torch.equal(benes.benes_permute(w[1:], ctrl, k, reverse=reverse),
                           benes.benes_permute_plain(w[1:], ctrl, k,
                                                     reverse=reverse))


def test_benes_kernel_refuses_ctrl_on_another_device(cuda):
    ctrl, k = benes.route_permutation(np.arange(100))
    x = torch.zeros(100, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        benes.benes_permute(x, ctrl, k)


@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
def test_run_totals_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    v = torch.from_numpy((rng.random(n) < 0.3).astype(np.int8)).to(cuda)
    coarse = _runs(rng, n, 5000)
    fine = _runs(rng, n, 9, within=coarse[0])
    to = lambda pair: tuple(torch.from_numpy(m).to(cuda) for m in pair)
    for sets in ([to(coarse)], [to(coarse), to(fine)], [to(fine)]):
        got = scans.run_totals_fused(v, sets)
        want = scans.run_totals_fused_plain(v, sets)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [4096 * 7 + 3, 1_000_003])
def test_run_totals_kernel_edge_runs(cuda, n):
    """B2 (units of 4,096): one run over the whole lane, every element its
    own run, runs longer than several units, with one and two sets, on
    aligned lanes and on lanes one byte off 16-byte alignment; values of
    0-3 and of any int8 (the walk forward then runs to the lane's end)."""
    rng = np.random.default_rng(n)
    whole = np.zeros(n, bool), np.zeros(n, bool)
    whole[0][0] = whole[1][-1] = True
    each = np.ones(n, bool), np.ones(n, bool)
    long_runs = _runs(rng, n, 20_000)
    fine = _runs(rng, n, 9, within=long_runs[0])
    for values in (rng.integers(0, 4, n + 1), rng.integers(-128, 128, n + 1)):
        w = torch.from_numpy(values.astype(np.int8)).to(cuda)
        for sets_np in ([whole], [each], [long_runs], [whole, each],
                        [long_runs, fine], [each, long_runs]):
            for off in (0, 1):
                v = w[off:off + n]
                sets = []
                for start, end in sets_np:
                    pair = []
                    for m in (start, end):
                        lane = torch.zeros(n + 1, dtype=torch.bool, device=cuda)
                        lane[off:off + n] = torch.from_numpy(m).to(cuda)
                        pair.append(lane[off:off + n])
                    sets.append(tuple(pair))
                got = scans.run_totals_fused(v, sets)
                want = scans.run_totals_fused_plain(v, sets)
                assert len(got) == len(sets)
                assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_run_totals_kernel_back_to_back(cuda):
    """50 calls of different lengths on one stream with no sync between
    them: each call's look-back must read only its own descriptors."""
    rng = np.random.default_rng(51)
    calls = []
    for n in rng.integers(1, 300_000, 50):
        n = int(n)
        v = torch.from_numpy(rng.integers(0, 4, n).astype(np.int8)).to(cuda)
        coarse = _runs(rng, n, int(rng.integers(2, 30_000)))
        fine = _runs(rng, n, 9, within=coarse[0])
        sets = [tuple(torch.from_numpy(m).to(cuda) for m in pair)
                for pair in ((coarse, fine) if n % 2 else (fine,))]
        calls.append((v, sets))
    torch.cuda.synchronize()
    got = [scans.run_totals_fused(v, sets) for v, sets in calls]
    for (v, sets), g in zip(calls, got):
        assert all(torch.equal(a, b) for a, b in
                   zip(g, scans.run_totals_fused_plain(v, sets)))


def _check_citizen(got, want):
    """Lanes bitwise; q within 2 ulp; a home hit may differ only where q
    differs by exactly 1 ulp, and the census only by such hits."""
    same = (got[5] == want[5]) | (got[5].isnan() & want[5].isnan())
    ulp = torch.where(same, 0, (got[5].view(torch.int32).long()
                                - want[5].view(torch.int32).long()).abs())
    assert int(ulp.max()) <= 2
    flip = ((got[3] & 4) != 0) != ((want[3] & 4) != 0)
    assert not bool((flip & (ulp != 1)).any())
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a[~flip], b[~flip])
    # the census, (8,) or (R, 8) in the ensemble mode
    assert torch.equal(got[4][..., :7], want[4][..., :7])
    assert int((got[4][..., 7] - want[4][..., 7]).abs().sum()) <= int(flip.sum())


@pytest.mark.parametrize("h24,move,mask_status,p0", [
    (8, True, 2, 0.00055), (9, True, 1, 0.05), (17, False, 0, 1.0),
])
def test_citizen_kernel_matches_plain(cuda, h24, move, mask_status, p0):
    """Lanes bitwise; q within 2 ulp; a home hit may differ only where q
    differs by exactly 1 ulp."""
    world = et.generate_synthetic_world(200_000, n_output_areas=40, seed=2).to(cuda)
    n = world.n_citizens
    rng = np.random.default_rng(h24)
    dev = lambda x: torch.from_numpy(x).to(cuda)
    status = dev(rng.choice(5, n, p=[0.7, 0.1, 0.1, 0.05, 0.05]).astype(np.int8))
    timer = dev(rng.integers(0, 400, n).astype(np.int32))
    sched = dev(rng.integers(0, 32, n).astype(np.int8))
    f32 = np.float32
    kw = dict(h24=h24, move=move, mask_status=mask_status,
              seed=int(rng.integers(0, 2**32)), exposed_time=96,
              infected_time=336, exposure_chance=f32(p0),
              mask_scale=f32(1.0) - f32(0.7), K=world.max_household_size,
              ref_mask_sem=True, u8_trunc=True, want_q=True)
    statics = citizen.make_citizen_statics(world)
    got = citizen.citizen_phase(statics, status, timer, sched, **kw)
    want = citizen.citizen_phase_plain(statics, status, timer, sched, **kw)
    _check_citizen(got, want)


@pytest.mark.parametrize("gid0", [0, 12_345, 2**31 - 7, 2**32 - 5])
def test_citizen_kernel_gid0_matches_plain(cuda, gid0):
    """B1's gid0 mode (the home draw hashes gid0 + lane, wrapping as a
    u32; the last offset wraps inside the lane): as
    :func:`test_citizen_kernel_matches_plain`, and other draws than
    gid0 = 0 where gid0 is not 0."""
    world = et.generate_synthetic_world(200_000, n_output_areas=40, seed=2).to(cuda)
    n = world.n_citizens
    rng = np.random.default_rng(7)
    dev = lambda x: torch.from_numpy(x).to(cuda)
    status = dev(rng.choice(5, n, p=[0.7, 0.1, 0.1, 0.05, 0.05]).astype(np.int8))
    timer = dev(rng.integers(0, 400, n).astype(np.int32))
    sched = dev(rng.integers(0, 32, n).astype(np.int8))
    f32 = np.float32
    kw = dict(h24=20, move=True, mask_status=1, seed=1234, exposed_time=96,
              infected_time=336, exposure_chance=f32(0.05),
              mask_scale=f32(1.0) - f32(0.7), K=world.max_household_size,
              ref_mask_sem=False, u8_trunc=True, want_q=True)
    statics = citizen.make_citizen_statics(world)
    got = citizen.citizen_phase(statics, status, timer, sched, gid0=gid0, **kw)
    want = citizen.citizen_phase_plain(statics, status, timer, sched,
                                       gid0=gid0, **kw)
    _check_citizen(got, want)
    zero = citizen.citizen_phase(statics, status, timer, sched, **kw)
    assert torch.equal(got[3], zero[3]) == (gid0 == 0)


def test_sharded_run_on_card_matches_cpu(cuda):
    """Two ranks sharing the card (gloo, host-staged) against two gloo
    ranks on the CPU: 4,000 citizens with transport, ``covid()``-like
    parameters, 48 steps; every output series and the final lanes equal,
    and B1-B3 launched on both ranks (their launches summed on rank 0)."""
    from epidemicsimulator_tpu_torch.parallel import fastmesh

    base = et.Params.covid()
    params = et.Params(
        dataclasses.replace(base.disease, exposure_chance=0.04,
                            exposed_time=24, infected_time=72,
                            vaccination_rate=25),
        dataclasses.replace(base.thresholds, lockdown=0.2, vaccination=0.05,
                            mask_public_transport=0.01, mask_everywhere=0.08))
    world = et.generate_synthetic_world(4000, n_output_areas=12, seed=4)
    cfg = et.SimConfig(max_steps=48, chunk_size=24)
    runs = []
    for device in ("cuda", "cpu"):
        et.reset_launches()
        state, _, out = fastmesh.run_fast_sharded(
            world, params, cfg, 2, seed=0, starting_infected=40, device=device)
        if device == "cuda":
            launches = dict(et.launches)
        runs.append([torch.from_numpy(np.asarray(x)) for x in out]
                    + [state.status, state.timer, state.sched, state.eligible])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert launches["citizen_phase"] == 2 * 48
    assert all(launches[name] for name in runtime.MAIN_PATH_KERNELS), launches


def _standin_world(rng, n, tile=4096, big=24):
    """The lanes that citizen statics are packed from, for n citizens in
    households of 1 to ``big``: one of ``big`` across every tile edge,
    one at each end of the lane, the rest of random sizes."""
    sizes, at = [], 0
    cuts = [0] + [e - big // 2 for e in range(tile, n - big, tile)] + [n - big]
    for cut in cuts:
        while at < cut:
            s = min(int(rng.integers(1, big + 1)), cut - at)
            sizes.append(s)
            at += s
        if at == cut and cut + big <= n:
            sizes.append(big)
            at += big
    while at < n:
        s = min(int(rng.integers(1, big + 1)), n - at)
        sizes.append(s)
        at += s
    size = np.repeat(sizes, sizes)
    pos = np.concatenate([np.arange(s) for s in sizes])
    hours = lambda: torch.from_numpy(rng.integers(0, 24, n).astype(np.int32))
    bits = lambda: torch.from_numpy(rng.random(n) < 0.5)
    ints = lambda lo, hi: torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32))
    return SimpleNamespace(
        work_start=hours(), work_end=hours(), uses_transport=bits(),
        work_building=ints(0, 3), home_building=ints(0, 3),
        hh_pos=torch.from_numpy(pos), hh_size=torch.from_numpy(size),
        mask_compliant=bits(), work_oa=ints(0, 2), home_oa=ints(0, 2),
        ws_work_start=hours(), ws_work_end=hours(),
        ws_uses_transport=bits(),
    ), int(max(sizes))


@pytest.mark.parametrize("n", [1, 17, 4096 * 5, 50_003])
@pytest.mark.parametrize("ref_mask_sem,u8_trunc", [
    (True, True), (True, False), (False, True), (False, False)])
def test_citizen_kernel_on_standin_households(cuda, n, ref_mask_sem, u8_trunc):
    """B1 (tiles of 4,096 citizens): households of up to 24 across every
    tile edge and at both lane ends, N not a multiple of 16 or of the
    tile, all four flag combinations, exposure_chance 1 (q is NaN where
    no housemate is infected), q asked for and not, and the state lanes
    one byte off 16-byte alignment."""
    rng = np.random.default_rng(n)
    world, K = _standin_world(rng, n)
    statics = citizen.CitizenStatics(
        *(x.to(cuda) for x in citizen.make_citizen_statics(world)))
    status_np = rng.choice(5, n + 1, p=[0.5, 0.1, 0.3, 0.05, 0.05]).astype(np.int8)
    timer_np = rng.integers(0, 20, n + 1).astype(np.int32)
    sched_np = rng.integers(0, 32, n + 1).astype(np.int8)
    f32 = np.float32
    for h24, move, mask_status, p0 in ((8, True, 2, 1.0), (9, True, 1, 0.05),
                                       (17, False, 0, 0.3)):
        kw = dict(h24=h24, move=move, mask_status=mask_status,
                  seed=int(rng.integers(0, 2**32)), exposed_time=10,
                  infected_time=15, exposure_chance=f32(p0),
                  mask_scale=f32(1.0) - f32(0.7), K=K,
                  ref_mask_sem=ref_mask_sem, u8_trunc=u8_trunc)
        for off in (0, 1):
            lanes = [torch.from_numpy(x[off:off + n]).to(cuda) if off == 0
                     else torch.from_numpy(x).to(cuda)[1:]
                     for x in (status_np, timer_np, sched_np)]
            want = citizen.citizen_phase_plain(statics, *lanes, want_q=True, **kw)
            got = citizen.citizen_phase(statics, *lanes, want_q=True, **kw)
            _check_citizen(got, want)
            if p0 == 1.0 and n > 1000:
                assert bool(want[5].isnan().any())
            got_noq = citizen.citizen_phase(statics, *lanes, **kw)
            assert len(got_noq) == 5
            for a, b in zip(got_noq, got[:5]):
                assert torch.equal(a, b)


def _ensemble_rows(R, cuda):
    """Different rows per replica: one locked down, one with chance 0,
    the three mask states, p0 = 1 (q NaN where no housemate is
    infected)."""
    f32 = np.float32
    rng = np.random.default_rng(R)
    ints = np.stack([rng.random(R) < 0.7, np.arange(R) % 3,
                     rng.integers(2, 100, R), rng.integers(5, 300, R)],
                    1).astype(np.int32)
    ints[0, 0] = 0
    chance = rng.uniform(0.0, 0.3, R).astype(f32)
    chance[min(1, R - 1)], chance[-1] = 0.0, 1.0
    scale = (f32(1.0) - rng.uniform(0.2, 0.9, R).astype(f32)).astype(f32)
    return (torch.from_numpy(ints).to(cuda),
            torch.from_numpy(np.stack([chance, scale], 1)).to(cuda))


@pytest.mark.parametrize("R,block_rows", [(1, 16), (5, 128), (12, 16)])
def test_citizen_kernel_ensemble_mode_matches_plain(cuda, R, block_rows):
    """B1's ensemble mode on packed lanes (tiles_per_rep 1 to 64), a
    random state, under two flag combinations, with q and without; the
    (R, 8) census against the plain per-replica sums; and a scalar call
    between two ensemble calls on the same stream (the census ticket)."""
    base = et.generate_synthetic_world(30_000, n_output_areas=10, seed=R)
    pe = packed.pack_replicas(base, [et.Params.covid()] * R,
                              block_rows=block_rows)
    world = pe.world.to(cuda)
    n = world.n_citizens
    rng = np.random.default_rng(R)
    dev = lambda x: torch.from_numpy(x).to(cuda)
    status = rng.choice(5, n, p=[0.6, 0.1, 0.2, 0.05, 0.05]).astype(np.int8)
    status[np.tile(np.arange(pe.rep_stride) >= pe.rep_size, R)] = 5
    status, timer, sched = (dev(status), dev(rng.integers(0, 400, n).astype(np.int32)),
                            dev(rng.integers(0, 32, n).astype(np.int8)))
    rep_ints, rep_f32s = _ensemble_rows(R, cuda)
    statics = citizen.make_citizen_statics(world)
    tiles = pe.rep_stride // citizen.CITIZEN_TILE
    for h24, ref_mask_sem, u8_trunc in ((8, True, True), (16, False, False)):
        kw = dict(h24=h24, seed=int(rng.integers(0, 2**32)),
                  K=world.max_household_size, ref_mask_sem=ref_mask_sem,
                  u8_trunc=u8_trunc, rep_ints=rep_ints, rep_f32s=rep_f32s,
                  tiles_per_rep=tiles)
        got = citizen.citizen_phase(statics, status, timer, sched, want_q=True, **kw)
        want = citizen.citizen_phase_plain(statics, status, timer, sched,
                                           want_q=True, **kw)
        assert got[4].shape == (R, 8)
        _check_citizen(got, want)
        scalar = citizen.citizen_phase(
            statics, status, timer, sched, h24=h24, seed=kw["seed"], move=True,
            mask_status=0, exposed_time=96, infected_time=336,
            exposure_chance=np.float32(0.01), mask_scale=np.float32(0.3),
            K=kw["K"], ref_mask_sem=ref_mask_sem, u8_trunc=u8_trunc)
        again = citizen.citizen_phase(statics, status, timer, sched, **kw)
        assert torch.equal(scalar[4], citizen.citizen_phase(
            statics, status, timer, sched, h24=h24, seed=kw["seed"], move=True,
            mask_status=0, exposed_time=96, infected_time=336,
            exposure_chance=np.float32(0.01), mask_scale=np.float32(0.3),
            K=kw["K"], ref_mask_sem=ref_mask_sem, u8_trunc=u8_trunc)[4])
        for a, b in zip(again, got[:5]):
            assert torch.equal(a, b)
    if R > 1:
        assert int(got[4][1, 7]) == 0  # chance 0: no home hit


@pytest.mark.parametrize("regime", ["deterministic", "covid"])
def test_packed_run_on_card_matches_cpu(cuda, regime):
    """Three replicas of 3,000 citizens with transport, 60 steps
    (tools/run_torch_ensemble.py::small_card_vs_cpu): the card's packed
    run (B1's ensemble mode, B2) equals the CPU's plain run, SEIRV and
    final lanes bitwise."""
    on_card, on_cpu, launches = _tool("run_torch_ensemble").small_card_vs_cpu(
        et, regime, cuda)
    assert launches["citizen_phase_ensemble"] == 60
    assert launches["run_totals_fused"] > 0
    assert launches["citizen_phase"] == 0
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a, b)
    assert (on_cpu[0].sum(2) == 3000).all()


def test_main_path_on_card_matches_cpu(cuda):
    """Deterministic regime, 3000 citizens, 48 steps: the card's run
    through the kernels equals the CPU run through the plain versions,
    and every kernel of the main path was launched."""
    base = et.Params.covid()
    params = et.Params(
        dataclasses.replace(base.disease, exposure_chance=1.0, exposed_time=6,
                            infected_time=12, vaccination_rate=25),
        dataclasses.replace(base.thresholds, lockdown=0.35, vaccination=0.05,
                            mask_public_transport=2.0, mask_everywhere=2.0),
    )
    cfg = et.SimConfig(max_steps=48, chunk_size=48)
    runs = []
    for device in (cuda, "cpu"):
        world = et.generate_synthetic_world(3000, n_output_areas=6, seed=4).to(device)
        state = et.init_state(world, seed=0, starting_infected=10, device=device)
        et.reset_launches()
        state, out = et.make_chunk_runner(world, cfg)(params, state)
        if device is cuda:
            assert all(et.launches[name] for name in runtime.MAIN_PATH_KERNELS), \
                et.launches
        runs.append([state.status.cpu(), state.sched.cpu(), out.seirv.cpu(),
                     out.exposures_per_oa.cpu()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("regime", ["covid_v16", "deterministic"])
def test_simulator_on_card_matches_cpu(cuda, tmp_path, regime):
    """The Simulator runs of tests/test_torch_simulator.py, census-like
    world of 5,000 citizens, 4 chunks of 24 steps: on the card through the
    kernels, and on the CPU through the plain versions; SEIRV and
    global_stats.json and exposures.json bitwise equal.  covid_v16() runs
    all 96 steps; the deterministic regime (exposure chance 1, masks off)
    ends at step 92."""
    if regime == "covid_v16":
        params = et.Params.covid_v16()
    else:
        base = et.Params.covid()
        params = et.Params(
            dataclasses.replace(base.disease, exposure_chance=1.0,
                                exposed_time=4, infected_time=8,
                                vaccination_rate=400),
            dataclasses.replace(base.thresholds, lockdown=0.1, vaccination=0.02,
                                mask_public_transport=2.0, mask_everywhere=2.0),
        )
    world = et.generate_census_like_world(5000, 16, seed=42)
    cfg = et.SimConfig(max_steps=96, chunk_size=24)
    seirv = {}
    for device in ("cuda", "cpu"):
        et.reset_launches()
        seirv[device] = et.Simulator(world, params, cfg, seed=1, device=device,
                                     verbose=False).simulate(str(tmp_path / device))
        if device == "cuda":
            assert all(et.launches[name] for name in runtime.MAIN_PATH_KERNELS), \
                et.launches
    np.testing.assert_array_equal(seirv["cuda"], seirv["cpu"])
    assert len(seirv["cpu"]) == (96 if regime == "covid_v16" else 92)
    for name in ("global_stats.json", "exposures.json"):
        assert (tmp_path / "cuda" / name).read_bytes() == \
            (tmp_path / "cpu" / name).read_bytes(), name


# -- the census/OSM pipeline ---------------------------------------------------
def edge_world_inputs(census_cls, osm_cls, seed=5):
    """``build_world`` inputs (census, OSM buildings, OA rings, ring
    starts, OA codes), in national-grid metres, for a world that the
    fixture's average OA never gives: OA k is the square [1000 k,
    1000 (k + 1)] x [0, 1000].  E02 and E04 have no household building,
    so no residents; E03's residents all commute out and nobody works in
    E03 or E04, so neither has a work-side run; E05 has no occupation
    counts and is dropped by ``filter_incomplete_output_areas``; one
    household lies outside every polygon; E01 holds one giant commercial
    building and schools stand in E00 and E01."""
    rng = np.random.default_rng(seed)
    n_oa = 6
    codes = [f"E{k:02d}" for k in range(n_oa)]
    age = np.zeros((n_oa, 101), np.int32)
    age[:, :80] = 3
    occ = rng.integers(5, 20, (n_oa, 9)).astype(np.int32)
    occ[5] = 0
    pop = np.zeros((n_oa, 6), np.int32)
    pop[:, 0] = [240, 200, 150, 220, 90, 100]
    flows = [(0, "E00", 30), (0, "E01", 20), (0, "E02", 10), (1, "E01", 20),
             (1, "E02", 15), (1, "E09", 5), (2, "E00", 4), (3, "E00", 10),
             (3, "E01", 10), (4, "E01", 3), (5, "E05", 7)]
    census = census_cls(
        oa_codes=codes, age_histogram=age, occupation_counts=occ,
        population_counts=pop, area_hectares=np.zeros(n_oa, np.float32),
        density=np.zeros(n_oa, np.float32),
        commute_home=np.array([f[0] for f in flows], np.int32),
        commute_work_code=np.array([f[1] for f in flows], dtype=object),
        commute_count=np.array([f[2] for f in flows], np.int32))
    buildings = []  # (class, oa, count, area)
    for oa, n in ((0, 60), (1, 50), (3, 40), (5, 30)):
        buildings.append((3, oa, n, 0.0))
    for oa, n in ((0, 3), (1, 2), (2, 2)):
        buildings.append((4, oa, n, None))
    buildings += [(4, 1, 1, 40_000.0), (1, 0, 1, 0.0), (1, 1, 1, 0.0),
                  (2, 1, 1, 0.0), (0, 0, 1, 0.0)]
    cls, east, north, area = [], [], [], []
    for c, oa, n, a in buildings:
        cls += [c] * n
        east.append(1000 * oa + rng.uniform(50, 950, n))
        north.append(rng.uniform(50, 950, n))
        area.append(rng.uniform(100, 3000, n) if a is None else np.full(n, a))
    cls.append(3)
    east.append(np.array([-500.0]))
    north.append(np.array([500.0]))
    area.append(np.zeros(1))
    osm = osm_cls(classes=np.array(cls, np.int32), east=np.concatenate(east),
                  north=np.concatenate(north), areas=np.concatenate(area))
    rings = np.concatenate([np.array([(1000 * k, 0), (1000 * (k + 1), 0),
                                      (1000 * (k + 1), 1000), (1000 * k, 1000)],
                                     np.float64) for k in range(n_oa)])
    starts = np.arange(0, 4 * n_oa + 1, 4, dtype=np.int64)
    return census, osm, rings, starts, codes


def _deterministic_params():
    base = et.Params.covid()
    return et.Params(
        dataclasses.replace(base.disease, exposure_chance=1.0, exposed_time=4,
                            infected_time=8, vaccination_rate=400),
        dataclasses.replace(base.thresholds, lockdown=0.1, vaccination=0.02,
                            mask_public_transport=2.0, mask_everywhere=2.0),
    )


def test_edge_world_on_card_matches_cpu(cuda, tmp_path):
    """The world of ``edge_world_inputs``: OAs with no residents and with
    no work-side run step on the card as the plain path steps on the CPU,
    under covid_v16() and in the deterministic regime, bitwise."""
    from epidemicsimulator_tpu_torch.data.census.container import CensusData
    from epidemicsimulator_tpu_torch.world.preprocess.builder import (
        OSMBuildings, build_world)

    world = build_world(*edge_world_inputs(CensusData, OSMBuildings), seed=2)
    home = np.bincount(world.home_oa, minlength=world.n_output_areas)
    work = np.bincount(world.work_oa, minlength=world.n_output_areas)
    assert world.n_output_areas == 5
    assert (home == 0).any() and ((work == 0) & (home > 0)).any()
    cfg = et.SimConfig(max_steps=72, chunk_size=24)
    for params in (et.Params.covid_v16(), _deterministic_params()):
        seirv = {}
        for device in ("cuda", "cpu"):
            et.reset_launches()
            seirv[device] = et.Simulator(
                world, params, cfg, seed=1, device=device, verbose=False,
            ).simulate(str(tmp_path / device))
            if device == "cuda":
                assert all(et.launches[name] for name in runtime.MAIN_PATH_KERNELS), \
                    et.launches
        np.testing.assert_array_equal(seirv["cuda"], seirv["cpu"])
        for name in ("global_stats.json", "exposures.json"):
            assert (tmp_path / "cuda" / name).read_bytes() == \
                (tmp_path / "cpu" / name).read_bytes(), name


@pytest.mark.parametrize("regime", ["covid_v16", "deterministic"])
def test_pipeline_cli_on_card_matches_cpu(cuda, tmp_path, regime):
    """The CLI's census/OSM pipeline on a 16-OA fixture of
    tools/gen_fixture_torch.py, 48 steps: on the card and with
    ``--device cpu``, SEIRV, global_stats.json and exposures.json
    bitwise equal."""
    import json

    from epidemicsimulator_tpu_torch import cli

    gen = _tool("gen_fixture_torch")
    pbf, shp, _ = gen.write_fixture(str(tmp_path), n_oas=16, pop_per_oa=200, seed=2)
    params = (et.Params.covid_v16() if regime == "covid_v16"
              else _deterministic_params())
    params_file = str(tmp_path / "params.json")
    params.to_json(params_file)
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = tmp_path / device
        et.reset_launches()
        assert cli.main([
            "pipe", "--directory", str(tmp_path), "--pbf", pbf,
            "--shapefile", shp, "--simulate", "--max-steps", "48",
            "--chunk-size", "24", "--seed", "1", "--params-file", params_file,
            "--output-name", str(out[device]), "--device", device]) == 0
        if device == "cuda":
            assert all(et.launches[name] for name in runtime.MAIN_PATH_KERNELS), \
                et.launches
    for name in ("global_stats.json", "exposures.json"):
        assert (out["cuda"] / name).read_bytes() == (out["cpu"] / name).read_bytes(), name
    stats = json.loads((out["cpu"] / "global_stats.json").read_text())
    assert len(stats) > 2 and stats[-2]["infected"] + stats[-2]["recovered"] > 0


def test_device_build_on_card_matches_cpu(cuda):
    """The synthetic world built on the card (sorts, scans and scatters on
    the device) equals the port's CPU build, every lane bitwise."""
    from epidemicsimulator_tpu_torch.world.device_build import (
        generate_synthetic_world_device,
    )

    on_card = generate_synthetic_world_device(20_000, n_output_areas=64,
                                              seed=3, device=cuda)
    on_cpu = generate_synthetic_world_device(20_000, n_output_areas=64,
                                             seed=3, device="cpu")
    for name in ("n_buildings", "n_rooms", "n_output_areas",
                 "max_household_size"):
        assert getattr(on_card, name) == getattr(on_cpu, name), name
    assert on_card.lane_names() == on_cpu.lane_names()
    for name in on_cpu.lane_names():
        lane = getattr(on_card, name)
        assert lane.device.type == "cuda", name
        assert torch.equal(lane.cpu(), getattr(on_cpu, name)), name


@pytest.mark.parametrize("regime", ["deterministic", "covid"])
def test_pool_run_on_card_matches_cpu(cuda, regime):
    """The fixed-priority vaccination pool with the intended pool
    semantics (rebuilt when it halves): the card's run equals the CPU's
    plain run, SEIRV, per-OA series and final lanes, the pool included,
    bitwise.  Deterministic: 3,000 citizens, 60 steps; covid(): 20,000
    citizens and 130 infected, 16 steps (the pool built, rebuilt, and the
    fresh fallback)."""
    base = et.Params.covid()
    if regime == "deterministic":
        params = et.Params(
            dataclasses.replace(base.disease, exposure_chance=1.0,
                                exposed_time=6, infected_time=12,
                                vaccination_rate=25),
            dataclasses.replace(base.thresholds, lockdown=0.35,
                                vaccination=0.05, mask_public_transport=2.0,
                                mask_everywhere=2.0))
        n, n_oa, seed, infected, steps = 3000, 6, 4, 10, 60
    else:
        params, n, n_oa, seed, infected, steps = base, 20_000, 12, 1, 130, 16
    cfg = et.SimConfig(max_steps=steps, chunk_size=steps,
                       vaccination_fixed_priority=True,
                       faithful_vaccine_bugs=False)
    runs = []
    for device in (cuda, "cpu"):
        world = et.generate_synthetic_world(n, n_output_areas=n_oa,
                                            seed=seed).to(device)
        state = et.init_state(world, seed=0, starting_infected=infected,
                              fixed_priority_vax=True, device=device)
        state, out = et.make_chunk_runner(world, cfg)(params, state)
        runs.append([state.status.cpu(), state.sched.cpu(),
                     state.eligible.cpu(), state.vax_pool.cpu(),
                     state.vax_pool_size.cpu(), out.seirv.cpu(),
                     out.exposures_per_oa.cpu(), out.n_vaccinated_now.cpu()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert int(runs[1][-1].sum()) > 0 and runs[1][3].shape == (n,)


@pytest.mark.parametrize("branch", ["prefix", "segment"])
def test_portable_run_on_card_matches_cpu(cuda, branch):
    """The portable step (``SimConfig(use_fast_path=False)``) on a 20,000
    citizen world, riders every day, masks and vaccination on: the card's
    run equals the CPU's plain run, SEIRV, per-OA and count series and
    final lanes, bitwise.  ``prefix``: the world's index tables (B3's
    range totals, the rider branch); ``segment``: without them
    (``index_add_`` segment sums, the per-citizen route keys)."""
    base = et.Params.covid()
    params = et.Params(
        dataclasses.replace(base.disease, exposure_chance=0.02,
                            exposed_time=24, infected_time=72,
                            vaccination_rate=25),
        dataclasses.replace(base.thresholds, lockdown=-1.0, vaccination=0.03,
                            mask_public_transport=0.01, mask_everywhere=0.05))
    cfg = et.SimConfig(max_steps=48, chunk_size=48, use_fast_path=False)
    runs = []
    for device in (cuda, "cpu"):
        world = et.generate_synthetic_world(20_000, n_output_areas=32, seed=2)
        if branch == "segment":
            world = world.without_index_tables()
        world = world.to(device)
        state = et.init_state(world, seed=0, starting_infected=150,
                              device=device)
        et.reset_launches()
        state, out = et.make_chunk_runner(world, cfg)(params, state)
        runs.append([state.status.cpu(), state.timer.cpu(), state.sched.cpu(),
                     state.eligible.cpu(), out.seirv.cpu(),
                     out.exposures_per_oa.cpu(), out.n_bus_exposures.cpu(),
                     out.n_vaccinated_now.cpu()])
        if device is cuda:
            launches = dict(et.launches)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert int(runs[1][6].sum()) > 0 and int(runs[1][7].sum()) > 0
    assert launches["cumsum_i8"] > 0
    assert launches["citizen_phase"] == launches["run_totals_fused"] == 0


@pytest.mark.parametrize("capacity", [20, 3])
def test_bus_infection_counts_on_card_matches_cpu(cuda, capacity):
    """The portable step's bus grouping on the card against the CPU, with
    route keys over 227,759 OAs that wrap in int32 (negative keys)."""
    from epidemicsimulator_tpu_torch.ops import segments

    rng = np.random.default_rng(capacity)
    n, n_oa = 200_003, 227_759
    src = rng.integers(0, n_oa, 500).astype(np.int64)
    dst = rng.integers(0, n_oa, 500).astype(np.int64)
    pick = rng.integers(0, 500, n)
    key = (src[pick] * n_oa + dst[pick]) & 0xFFFFFFFF
    key = torch.from_numpy(np.where(key >= 2**31, key - 2**32, key))
    assert (key < 0).any()
    on_bus = torch.from_numpy(rng.random(n) < 0.6)
    infected = on_bus & torch.from_numpy(rng.random(n) < 0.2)
    args = ((7, 11), on_bus, key, infected, capacity)
    got = segments.bus_infection_counts(
        *(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args))
    want = segments.bus_infection_counts(*args)
    assert torch.equal(got.cpu(), want)
    assert int(want.max()) > 0

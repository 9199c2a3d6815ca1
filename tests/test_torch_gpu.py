"""The CUDA kernels of the port against their plain torch versions, on a
card.  Every test here is marked ``gpu`` and skips without a CUDA device.
This file imports nothing of JAX; run it on a machine with a card as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the CPU tests).
"""

import dataclasses

import numpy as np
import pytest
import torch

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import runtime
from epidemicsimulator_tpu_torch.ops import benes, citizen, scans

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


@pytest.mark.parametrize("tile_elems", [1024, 4096, 131_072])
@pytest.mark.parametrize("n", [1, 1023, 1025, 70_001, 1_000_003])
def test_cumsum_2phase_kernel_matches_plain(cuda, n, tile_elems):
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(cuda)
    want = scans.cumsum_i8_2phase_plain(v, tile_elems=tile_elems)
    assert torch.equal(scans.cumsum_i8_2phase(v, tile_elems=tile_elems), want)
    assert torch.equal(want, scans.cumsum_i8_plain(v))
    b = v > 0
    assert torch.equal(scans.cumsum_i8_2phase(b, tile_elems=tile_elems),
                       scans.cumsum_i8_plain(b))


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
    same = (got[5] == want[5]) | (got[5].isnan() & want[5].isnan())
    ulp = torch.where(same, 0, (got[5].view(torch.int32).long()
                                - want[5].view(torch.int32).long()).abs())
    assert int(ulp.max()) <= 2
    flip = ((got[3] & 4) != 0) != ((want[3] & 4) != 0)
    assert not bool((flip & (ulp != 1)).any())
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a[~flip], b[~flip])
    assert torch.equal(got[4][:7], want[4][:7])


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

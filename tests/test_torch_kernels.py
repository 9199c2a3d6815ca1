"""The plain torch versions of kernels B1, B2, B3 and B4 against the JAX
package's Pallas kernels (interpret mode), on the CPU.

On the CPU each wrapper runs its plain version; on the card the same
wrapper launches the CUDA kernel, which chip_smoke.py and
test_torch_gpu.py hold against this plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu.ops import pallas_citizen as j_cit
from epidemicsimulator_tpu.ops import pallas_scans as j_scans

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch.ops import citizen as t_cit
from epidemicsimulator_tpu_torch.ops import scans as t_scans

T = torch.from_numpy


def _random_runs(rng, n, avg_run, within=None):
    start = rng.random(n) < 1.0 / avg_run
    start[0] = True
    if within is not None:
        start |= within
    end = np.empty(n, bool)
    end[:-1] = start[1:]
    end[-1] = True
    return start, end


@pytest.mark.parametrize("n", [1, 127, 5000, 70_000])
def test_b3_cumsum_and_range_totals_match_pallas(n):
    rng = np.random.default_rng(n)
    v = (rng.random(n) < 0.4).astype(np.int8)
    want = j_scans.cumsum_pallas(jnp.asarray(v), tile_rows=8, interpret=True)
    np.testing.assert_array_equal(t_scans.cumsum_i8(T(v)).numpy(), np.asarray(want))
    np.testing.assert_array_equal(t_scans.cumsum_i8(T(v.astype(bool))).numpy(),
                                  np.asarray(want))
    hi = np.sort(rng.integers(0, n + 1, 40)).astype(np.int32)
    lo = np.minimum(hi, rng.integers(0, n + 1, 40)).astype(np.int32)
    want_r = j_scans.range_totals_pallas(jnp.asarray(v), jnp.asarray(lo),
                                         jnp.asarray(hi), tile_rows=8,
                                         interpret=True)
    np.testing.assert_array_equal(
        t_scans.range_totals(T(v), T(lo), T(hi)).numpy(), np.asarray(want_r))


UNIT = t_scans.CUMSUM_UNIT


def _b4_lanes(rng, n):
    """A 0/1 lane, its bool form and a signed int8 lane."""
    v01 = (rng.random(n) < 0.4).astype(np.int8)
    return v01, v01.astype(bool), rng.integers(-128, 128, n).astype(np.int8)


@pytest.mark.parametrize("n", [1, 1000, 5000, 70_001, UNIT - 1, UNIT,
                               3 * UNIT + 5, 200_001])
def test_b4_two_phase_cumsum_matches_pallas(n):
    """The port's B4 (units of CUMSUM_UNIT elements) bitwise against the
    JAX two-phase cumsum at tiles of 8 x 128 elements, and against B3."""
    for v in _b4_lanes(np.random.default_rng(n), n):
        want = np.asarray(j_scans._cumsum_pallas2(
            jnp.asarray(v), tile_rows=8, interpret=True))
        np.testing.assert_array_equal(want, np.cumsum(v, dtype=np.int32))
        np.testing.assert_array_equal(t_scans.cumsum_i8_2phase(T(v)).numpy(), want)
        np.testing.assert_array_equal(t_scans.cumsum_i8(T(v)).numpy(), want)


@pytest.mark.parametrize("tile_elems", [2048, 4096, 131_072])
def test_b4_matches_b3_at_other_tiles(tile_elems):
    """The JAX two-phase cumsum at other tiles (tile_rows = tile_elems /
    128): the port's result, whose unit is its own, is the same."""
    for n in (1, UNIT - 1, UNIT, 3 * UNIT + 5, 200_001):
        for v in _b4_lanes(np.random.default_rng(n), n)[1:]:
            # the bool lane goes to JAX as int8, which shares its compile
            want = np.asarray(j_scans._cumsum_pallas2(
                jnp.asarray(v.astype(np.int8)), tile_rows=tile_elems // 128,
                interpret=True))
            got = t_scans.cumsum_i8_2phase(T(v))
            np.testing.assert_array_equal(got.numpy(), want)
            assert torch.equal(got, t_scans.cumsum_i8(T(v)))


def test_b4_refuses_bad_input():
    v = torch.zeros(5000, dtype=torch.int8)
    for bad in (v.int(), v.view(50, 100)):
        with pytest.raises(ValueError):
            t_scans.cumsum_i8_2phase(bad)
    assert t_scans.cumsum_i8_2phase(v[:0]).shape == (0,)
    assert t_scans.cumsum_i8_2phase(v[:0]).dtype == torch.int32


@pytest.mark.parametrize("n", [96, 4096, 70_000])
def test_b2_run_totals_match_pallas(n):
    """One set, and two nested sets (the work side's building and room)."""
    rng = np.random.default_rng(n)
    v = (rng.random(n) < 0.3).astype(np.int8)
    coarse = _random_runs(rng, n, 60)
    fine = _random_runs(rng, n, 9, within=coarse[0])
    for sets in ([coarse], [coarse, fine]):
        want = j_scans.run_totals_fused(
            jnp.asarray(v), [tuple(map(jnp.asarray, s)) for s in sets],
            tile_rows=8, interpret=True)
        got = t_scans.run_totals_fused(T(v), [tuple(map(T, s)) for s in sets])
        assert len(got) == len(sets)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def worlds():
    return (j_world(20_000, n_output_areas=12, seed=1),
            et.generate_synthetic_world(20_000, n_output_areas=12, seed=1).to("cpu"))


def test_b1_statics_match_pallas(worlds):
    jw, tw = worlds
    n = jw.n_citizens
    js = j_cit.make_citizen_statics(jw.device_put())
    ts = t_cit.make_citizen_statics(tw)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).reshape(-1)[:n])


@pytest.mark.parametrize("h24,move,mask_status,p0,ref_sem", [
    (8, True, 2, 0.00055, True),    # bus out, masks everywhere
    (9, True, 1, 0.05, False),      # to work, masks on transport
    (17, False, 0, 0.3, True),      # lockdown: frozen schedule
    (16, True, 2, 1.0, False),      # certain exposure
])
def test_b1_citizen_phase_matches_pallas(worlds, h24, move, mask_status, p0,
                                         ref_sem):
    """Random state on the 20k world; every lane, and the census against
    the Pallas per-block partials summed.  The home probabilities differ
    by at most 2**-23 (test_torch_ops.py), on a grid where the uniforms
    are multiples of 2**-24, and no draw here falls between them."""
    jw, tw = worlds
    n = jw.n_citizens
    rng = np.random.default_rng(h24)
    status = rng.choice(5, n, p=[0.7, 0.1, 0.1, 0.05, 0.05]).astype(np.int8)
    timer = rng.integers(0, 400, n).astype(np.int32)
    sched = rng.integers(0, 32, n).astype(np.int8)
    seed = int(rng.integers(0, 2**32))
    e_time, i_time = 96, 336
    f32 = np.float32
    mask_scale = f32(1.0) - f32(0.7)
    ints = jnp.asarray([h24, int(move), mask_status,
                        np.uint32(seed).view(np.int32), e_time, i_time, 0, 0],
                       jnp.int32)
    f32s = jnp.asarray([p0, mask_scale], jnp.float32)
    want = j_cit.citizen_phase(
        j_cit.make_citizen_statics(jw.device_put()), jnp.asarray(status),
        jnp.asarray(timer), jnp.asarray(sched), ints, f32s,
        K=jw.max_household_size, ref_mask_sem=ref_sem, u8_trunc=True,
        block_rows=32, interpret=True)
    got = t_cit.citizen_phase(
        t_cit.make_citizen_statics(tw), T(status), T(timer), T(sched),
        h24=h24, move=move, mask_status=mask_status, seed=seed,
        exposed_time=e_time, infected_time=i_time, exposure_chance=f32(p0),
        mask_scale=mask_scale, K=tw.max_household_size, ref_mask_sem=ref_sem,
        u8_trunc=True)
    for a, b, name in zip(got[:4], want[:4], ("status", "timer", "sched", "gates")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]).sum(0))
    assert int(got[4][7]) > 0  # home hits happened


def test_b1_refuses_large_households(worlds):
    _, tw = worlds
    statics = t_cit.make_citizen_statics(tw)
    z8 = torch.zeros(tw.n_citizens, dtype=torch.int8)
    with pytest.raises(ValueError):
        t_cit.citizen_phase(statics, z8, z8.int(), z8, h24=0, move=True,
                            mask_status=0, seed=0, exposed_time=1,
                            infected_time=1, exposure_chance=0.1,
                            mask_scale=0.3, K=25, ref_mask_sem=True,
                            u8_trunc=True)

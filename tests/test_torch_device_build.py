"""The port's device world build (world/device_build.py) against the JAX
package's and the host path, on the CPU.

* ``build_tables_device`` is bit for bit the port's numpy ``make_world``
  and the JAX package's ``build_tables_device``, field for field and
  dtype for dtype, for the same core lanes (the cases of
  ``tests/test_device_build.py``).
* ``generate_synthetic_world_device`` is the JAX one lane for lane.  The
  one float step is the commute shift, ``rint(-sign(u) * log1p(-2|u|) *
  commute_spread)``: torch's and XLA's float32 ``log1p`` may differ in
  the last ulp, and a shift can then round the other way only where
  ``lap * commute_spread`` lies within a few ulp of a half-integer.  The
  test computes the scaled shift with both packages and requires every
  citizen whose rounded shift differs to lie within 4 ulp of a
  half-integer; in these worlds none differs, and every lane is equal.
* The structure and determinism checks of the JAX package's test hold on
  the port's world, and a ``covid()`` run of 96 steps on device-built
  worlds is bitwise the JAX package's main-path formulation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu.engine.scan import run as j_run
from epidemicsimulator_tpu.engine.state import init_state as j_init
from epidemicsimulator_tpu.ops.hashrng import hash_bits as j_hash_bits
from epidemicsimulator_tpu.ops.hashrng import hash_uniform as j_hash_uniform
from epidemicsimulator_tpu.world import device_build as j_db
from epidemicsimulator_tpu.world.schema import World as JWorld

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import bridge
from epidemicsimulator_tpu_torch.config import (
    HOUSEHOLD_SIZE,
    MAX_STUDENT_AGE,
    OCC_STUDENT,
    OCC_UNEMPLOYED,
)
from epidemicsimulator_tpu_torch.world import device_build as t_db
from epidemicsimulator_tpu_torch.world.schema import World, make_world

ULP_BOUND = 4  # a differing rounded shift must be this close to a half-integer


def _core_only(w):
    return World(
        n_buildings=w.n_buildings, n_rooms=w.n_rooms,
        n_output_areas=w.n_output_areas,
        **{name: np.asarray(getattr(w, name)) for name in World.CORE_LANES},
    )


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_worlds_equal(ref, got, what):
    for name in ("n_buildings", "n_rooms", "n_output_areas",
                 "max_household_size"):
        assert getattr(ref, name) == getattr(got, name), (what, name)
    for f in dataclasses.fields(World):
        if f.metadata.get("static") or getattr(ref, f.name) is None:
            continue
        a, b = _host(getattr(ref, f.name)), _host(getattr(got, f.name))
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f.name}")


@pytest.mark.parametrize("n,n_oa,seed", [(5000, 12, 7), (33333, 24, 1)])
def test_tables_device_match_numpy_and_jax(n, n_oa, seed):
    ref = et.generate_synthetic_world(n, n_output_areas=n_oa, seed=seed)
    core = _core_only(ref)
    got = t_db.build_tables_device(core, device="cpu")
    _assert_worlds_equal(ref, got, "numpy make_world")
    _assert_worlds_equal(got, j_db.build_tables_device(JWorld(
        n_buildings=core.n_buildings, n_rooms=core.n_rooms,
        n_output_areas=core.n_output_areas,
        **{name: getattr(core, name) for name in World.CORE_LANES})), "JAX")
    for name in World.CORE_LANES:
        assert getattr(got, name).device.type == "cpu"


def test_tables_device_non_canonical_input():
    """Core lanes in a scrambled citizen order canonicalise as make_world
    and the JAX build canonicalise the same scrambled lanes."""
    base = et.generate_synthetic_world(4000, n_output_areas=8, seed=13)
    perm = np.random.default_rng(0).permutation(base.n_citizens)
    lanes = {name: np.asarray(getattr(base, name))[perm]
             for name in World.CORE_LANES}
    sizes = dict(n_buildings=base.n_buildings, n_rooms=base.n_rooms,
                 n_output_areas=base.n_output_areas)
    got = t_db.build_tables_device(World(**sizes, **lanes), device="cpu")
    _assert_worlds_equal(make_world(**sizes, **lanes), got, "numpy make_world")
    _assert_worlds_equal(got, j_db.build_tables_device(JWorld(**sizes, **lanes)),
                         "JAX")


def _scaled_shifts(n, seed, commute_spread=3.0):
    """``lap * commute_spread`` in float32 by each package's formula, in
    generation order."""
    c = (0xA5A5A5A5 + 6 * 0x9E3779B9) & 0xFFFFFFFF
    sub_t = t_db.hash_bits(c, seed)
    sub_j = j_hash_bits(jnp.uint32(c), jnp.uint32(seed))
    assert int(sub_j) == sub_t
    u_t = t_db.hash_uniform(sub_t, torch.arange(n)) - 0.5
    lap_t = -torch.sign(u_t) * torch.log1p(-2.0 * torch.abs(u_t))
    u_j = j_hash_uniform(sub_j, jnp.arange(n, dtype=jnp.uint32)) - 0.5
    lap_j = -jnp.sign(u_j) * jnp.log1p(-2.0 * jnp.abs(u_j))
    cs = np.float32(commute_spread)
    return (lap_t * float(cs)).numpy(), np.asarray(lap_j * cs)


def shift_mismatches(x_t, x_j, n_oa):
    """Citizens whose rounded shifts differ, and each one's distance from
    the nearest half-integer in ulp of the larger value."""
    r = lambda x: np.rint(np.clip(x, -n_oa, n_oa))
    diff = np.flatnonzero(r(x_t) != r(x_j))
    x = x_t[diff].astype(np.float64)
    ulps = np.abs(x - (np.floor(x) + 0.5)) / np.spacing(
        np.maximum(np.abs(x_t[diff]), np.abs(x_j[diff])))
    return diff, ulps


@pytest.mark.parametrize("n,n_oa,seed", [(5000, 12, 7), (20_000, 64, 3)])
def test_synthetic_device_matches_jax(n, n_oa, seed):
    x_t, x_j = _scaled_shifts(n, seed)
    diff, ulps = shift_mismatches(x_t, x_j, n_oa)
    assert (ulps <= ULP_BOUND).all(), (diff, ulps)
    assert len(diff) == 0  # so every lane must be equal
    got = t_db.generate_synthetic_world_device(n, n_output_areas=n_oa,
                                               seed=seed, device="cpu")
    want = j_db.generate_synthetic_world_device(n, n_output_areas=n_oa,
                                                seed=seed)
    _assert_worlds_equal(want, got, "JAX generate_synthetic_world_device")


def test_synthetic_device_structure():
    w = t_db.generate_synthetic_world_device(5000, n_output_areas=12, seed=7,
                                             device="cpu")
    age, occ = w.age.numpy(), w.occupation.numpy()
    assert ((occ == OCC_STUDENT) == (age < MAX_STUDENT_AGE)).all()
    hb, wb = w.home_building.numpy(), w.work_building.numpy()
    unemployed = occ == OCC_UNEMPLOYED
    assert (hb[unemployed] == wb[unemployed]).all()
    ho = w.home_oa.numpy()
    for b in np.unique(hb[:200]):
        members = np.flatnonzero(hb == b)
        assert len(np.unique(ho[members])) == 1
        assert len(members) <= HOUSEHOLD_SIZE
    rooms, school = w.room.numpy(), w.is_school_work.numpy()
    assert (rooms[school] < w.n_rooms).all()
    assert (rooms[~school] == w.n_rooms).all()
    assert abs(w.uses_transport.float().mean().item() - 0.2) < 0.03
    assert abs(w.mask_compliant.float().mean().item() - 0.8) < 0.03
    # every class room has exactly one staff member
    students = occ == OCC_STUDENT
    staff = school & ~students
    class_rooms = np.unique(rooms[students & school])
    staff_per_room = np.bincount(rooms[staff], minlength=w.n_rooms + 1)
    assert (staff_per_room[class_rooms] == 1).all()
    sizes = np.bincount(rooms[students], minlength=w.n_rooms + 1)[class_rooms]
    assert sizes.max() <= 27
    office_rooms = np.setdiff1d(np.unique(rooms[staff]), class_rooms)
    if len(office_rooms):
        assert staff_per_room[office_rooms].max() <= 12
    # index tables self-consistent: validate + canonical orderings
    w.validate()
    _core_only(w).validate()
    assert (np.diff(hb) >= 0).all()
    wb_ws = wb[w.work_perm.numpy()]
    assert (np.diff(wb_ws) >= 0).all()


def test_synthetic_device_deterministic():
    gen = lambda seed: t_db.generate_synthetic_world_device(
        3000, n_output_areas=6, seed=seed, device="cpu")
    a, b, c = gen(5), gen(5), gen(6)
    for name in World.CORE_LANES + ("work_perm", "rpos"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not torch.equal(a.age, c.age)


def test_device_build_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_db.generate_synthetic_world_device(100, n_output_areas=2)
    core = _core_only(et.generate_synthetic_world(100, n_output_areas=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_db.build_tables_device(core)


def test_covid_run_on_device_built_world_matches_jax():
    """96 steps of covid() (chunk 24) on each package's device-built world
    of 6,000 citizens: the SEIRV, per-OA and count series and the final
    lanes, bitwise."""
    n, n_oa, seed = 6000, 8, 2
    jw = j_db.generate_synthetic_world_device(n, n_output_areas=n_oa, seed=seed)
    tw = t_db.generate_synthetic_world_device(n, n_output_areas=n_oa, seed=seed,
                                              device="cpu")
    j_cfg = JSimConfig(use_fused_citizen=True, use_pallas_scans=True,
                       max_steps=96, chunk_size=24)
    jp = JParams.covid()
    st = j_init(jw, seed=0, starting_infected=60)
    j_final, j_out = j_run(jw, jp.as_arrays(), j_cfg, st, overlap=False)
    t_state = et.init_state(tw, seed=0, starting_infected=60, device="cpu")
    t_final, t_out = et.run(tw, bridge.params_from_values(
        dataclasses.asdict(jp.disease), dataclasses.asdict(jp.thresholds)),
        et.SimConfig(max_steps=96, chunk_size=24), t_state)
    assert t_out.seirv.shape == (96, 5)
    for name in t_out._fields:
        np.testing.assert_array_equal(getattr(t_out, name),
                                      np.asarray(getattr(j_out, name)), name)
    for name in ("status", "timer", "eligible"):
        np.testing.assert_array_equal(getattr(t_final, name).numpy(),
                                      np.asarray(getattr(j_final, name)), name)
    assert t_out.seirv[-1, 4] > 0 and t_out.lockdown.any()

"""The port's census/OSM world pipeline against the JAX package's, on the
CPU: the fixture generator, ``build_world`` and ``dedupe_close_buildings``
(identical ``World``, npz included), a world with empty OAs, and the
CLI's pipeline branch, whose artifacts are byte-identical to the JAX
package's reference run.  Every comparison is bitwise."""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import cli as j_cli
from epidemicsimulator_tpu.data.census.container import CensusData as JCensusData
from epidemicsimulator_tpu.engine.simulator import Simulator as JSimulator
from epidemicsimulator_tpu.world import geometry as j_geometry
from epidemicsimulator_tpu.world.preprocess import builder as j_builder

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import cli as t_cli
from epidemicsimulator_tpu_torch.data.census.container import CensusData
from epidemicsimulator_tpu_torch.world import geometry as t_geometry
from epidemicsimulator_tpu_torch.world.preprocess import builder as t_builder
from test_torch_gpu import edge_world_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATICS = ("n_buildings", "n_rooms", "n_output_areas", "max_household_size")
ARTIFACTS = ("global_stats.json", "exposures.json")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def generators():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    return _tool("gen_fixture"), _tool("gen_fixture_torch")


@pytest.fixture(scope="module")
def fixture40(generators, tmp_path_factory):
    """The fixture of both generators at 40 OAs x 310: 12,480 citizens."""
    base = tmp_path_factory.mktemp("fx40")
    out = {}
    for name, gen in zip(("jax", "port"), generators):
        pbf, shp, codes = gen.write_fixture(str(base / name), n_oas=40,
                                            pop_per_oa=310, seed=0)
        out[name] = (base / name, pbf, shp, codes)
    return out


def _assert_worlds_equal(t, j):
    assert t.lane_names() == [f.name for f in dataclasses.fields(j)
                              if not f.metadata.get("static")
                              and getattr(j, f.name) is not None]
    for name in t.lane_names():
        a, b = np.asarray(getattr(j, name)), np.asarray(getattr(t, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, name)
    for name in STATICS:
        assert getattr(t, name) == getattr(j, name), name


def test_fixture_files_byte_identical(fixture40):
    (jdir, *_, jcodes), (tdir, *_, tcodes) = fixture40["jax"], fixture40["port"]
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 7
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    assert tcodes == jcodes


def _pipeline_world(pkg, directory, pbf, shp, seed):
    """The CLI's pipeline steps, one package's modules throughout."""
    container, convert, native, shapefile, builder = (
        __import__(f"{pkg}.{m}", fromlist=["x"]) for m in (
            "data.census.container", "data.geo.convert", "data.osm.native",
            "data.osm.shapefile", "world.preprocess.builder"))
    census = container.load_census_data(str(directory))
    codes, rings, starts = shapefile.read_polygons(shp)
    classes, lats, lons, areas = native.parse_pbf(pbf)
    east, north = convert.wgs84_to_national_grid(lats, lons)
    keep = builder.dedupe_close_buildings(classes, east, north)
    assert (~keep).any()  # the fixture's duplicate schools
    osm = builder.OSMBuildings(classes=classes[keep], east=east[keep],
                               north=north[keep], areas=areas[keep])
    timings = {}
    world = builder.build_world(census, osm, rings, starts, codes, seed=seed,
                                timings=timings)
    return world, timings


def test_build_world_matches_jax(fixture40, tmp_path):
    """Every lane and static of the World, and the npz files each package
    saves, equal; the eight phases are timed."""
    d, pbf, shp, _ = fixture40["port"]
    jw, _ = _pipeline_world("epidemicsimulator_tpu", d, pbf, shp, seed=3)
    tw, timings = _pipeline_world("epidemicsimulator_tpu_torch", d, pbf, shp, seed=3)
    _assert_worlds_equal(tw, jw)
    assert tw.n_citizens == 12_480
    assert list(timings) == [
        "1_oa_setup", "2_building_to_oa", "3_citizens_households",
        "4_schools", "5_workplace_oa_sampling", "6_workplace_packing",
        "7_school_building_ids", "8_world_tables"]
    jw.save_npz(str(tmp_path / "j.npz"))
    tw.save_npz(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(b[name], a[name], name)
    np.testing.assert_array_equal(t_geometry.buildings_per_output_area(tw),
                                  j_geometry.buildings_per_output_area(jw))


@pytest.mark.parametrize("which,radius", [((1, 2), 500.0), ((1,), 50.0),
                                          ((2, 4), 1500.0)])
def test_dedupe_matches_jax(which, radius):
    rng = np.random.default_rng(len(which) + int(radius))
    classes = rng.integers(0, 5, 3000).astype(np.int32)
    east = rng.uniform(0, 20_000, 3000)
    north = rng.uniform(0, 20_000, 3000)
    got = t_builder.dedupe_close_buildings(classes, east, north, which, radius)
    want = j_builder.dedupe_close_buildings(classes, east, north, which, radius)
    assert got.dtype == want.dtype and (~got).any()
    np.testing.assert_array_equal(got, want)


def test_cumcount_matches_jax():
    rng = np.random.default_rng(9)
    ids = np.sort(rng.integers(0, 50, 1000))
    np.testing.assert_array_equal(t_builder._cumcount(ids), j_builder._cumcount(ids))
    assert t_builder._cumcount(ids[:0]).dtype == np.int64


def _deterministic(params_cls):
    """Every draw probability 0, 1 or NaN (masks off)."""
    base = params_cls.covid()
    return params_cls(
        dataclasses.replace(base.disease, exposure_chance=1.0, exposed_time=4,
                            infected_time=8, vaccination_rate=400),
        dataclasses.replace(base.thresholds, lockdown=0.1, vaccination=0.02,
                            mask_public_transport=2.0, mask_everywhere=2.0),
    )


def test_edge_world_matches_jax(tmp_path):
    """OAs with no residents, an OA whose residents all work elsewhere,
    an OA dropped by the filter and a building outside every polygon:
    the same World in both packages, and the port's plain path runs it
    as the JAX package's fused Simulator does."""
    jw = j_builder.build_world(*edge_world_inputs(JCensusData, j_builder.OSMBuildings),
                               seed=2)
    tw = t_builder.build_world(*edge_world_inputs(CensusData, t_builder.OSMBuildings),
                               seed=2)
    _assert_worlds_equal(tw, jw)
    home = np.bincount(tw.home_oa, minlength=tw.n_output_areas)
    work = np.bincount(tw.work_oa, minlength=tw.n_output_areas)
    assert list(home == 0) == [False, False, True, False, True]
    assert list(work == 0) == [False, False, False, True, True]
    for jp, tp in ((JParams.covid_v16(), et.Params.covid_v16()),
                   (_deterministic(JParams), _deterministic(et.Params))):
        j_seirv = JSimulator(jw, jp, JSimConfig(
            use_fused_citizen=True, use_pallas_scans=True, max_steps=48,
            chunk_size=24), seed=1, verbose=False).simulate(str(tmp_path / "j"))
        t_seirv = et.Simulator(tw, tp, et.SimConfig(max_steps=48, chunk_size=24),
                               seed=1, device="cpu",
                               verbose=False).simulate(str(tmp_path / "t"))
        np.testing.assert_array_equal(t_seirv, np.asarray(j_seirv))
        for name in ARTIFACTS:
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes(), name


@pytest.fixture(scope="module")
def fixture16(generators, tmp_path_factory):
    base = tmp_path_factory.mktemp("fx16")
    pbf, shp, _ = generators[1].write_fixture(str(base), n_oas=16,
                                              pop_per_oa=200, seed=2)
    return base, pbf, shp


@pytest.mark.parametrize("regime", ["covid", "deterministic"])
def test_cli_pipeline_matches_jax_reference(fixture16, tmp_path, regime):
    """``cli.main(... --pbf --shapefile --simulate --device cpu)`` writes
    global_stats.json and exposures.json byte-identical to the JAX
    package's reference: its CLI's ``load_or_build_world`` world run by
    its Simulator with the fused citizen phase and the Pallas scans."""
    src, pbf, shp = fixture16
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    for d in (jdir, tdir):
        shutil.copytree(src, d)
    pbf, shp = os.path.basename(pbf), os.path.basename(shp)
    jp, tp = ((JParams.covid(), et.Params.covid()) if regime == "covid"
              else (_deterministic(JParams), _deterministic(et.Params)))
    args = j_cli.make_parser().parse_args([
        "pipe", "--directory", str(jdir), "--pbf", str(jdir / pbf),
        "--shapefile", str(jdir / shp), "--seed", "1"])
    jw, _ = j_cli.load_or_build_world(args)
    JSimulator(jw, jp, JSimConfig(use_fused_citizen=True, use_pallas_scans=True,
                                  max_steps=48, chunk_size=24),
               seed=1, verbose=False).simulate(str(jdir / "out"))
    params_file = str(tmp_path / "params.json")
    tp.to_json(params_file)
    assert t_cli.main([
        "pipe", "--directory", str(tdir), "--pbf", str(tdir / pbf),
        "--shapefile", str(tdir / shp), "--simulate", "--max-steps", "48",
        "--chunk-size", "24", "--seed", "1", "--params-file", params_file,
        "--output-name", str(tdir / "out"), "--device", "cpu"]) == 0
    for name in ARTIFACTS:
        assert (tdir / "out" / name).read_bytes() == \
            (jdir / "out" / name).read_bytes(), name
    stats = json.loads((tdir / "out" / "global_stats.json").read_text())
    assert len(stats) == 49 and stats[-2]["infected"] + stats[-2]["recovered"] > 0
    phases = json.loads((tdir / "out" / "cli_phases.json").read_text())
    assert list(phases["world_pipeline"]) == [
        "census_s", "shapefile_s", "pbf_s", "national_grid_s", "dedupe_s",
        "build_world_s", "caches_written_s"]
    # the caches under the JAX package's names, loadable by it
    world_cache = tdir / "world_pipe.npz"
    timings = json.loads((tdir / "world_pipe.npz.build_timings.json").read_text())
    assert len(timings) == 8
    _assert_worlds_equal(et.World.load_npz(str(world_cache)), jw)
    geo = j_geometry.WorldGeometry.load_npz(str(tdir / "geometry_pipe.npz"))
    mine = t_geometry.WorldGeometry.load_npz(str(tdir / "geometry_pipe.npz"))
    assert geo.n_polygons == mine.n_polygons == 16 and geo.codes == mine.codes
    with np.load(tdir / (pbf + ".parsed.npz")) as a, \
            np.load(jdir / (pbf + ".parsed.npz")) as b:
        for name in ("classes", "lats", "lons", "areas"):
            assert a[name].tobytes() == b[name].tobytes(), name


def test_cli_pipeline_use_cache(fixture16, tmp_path):
    """--use-cache reads the world cache (and would read the parse
    cache): the rerun gives the same artifacts."""
    src, pbf, shp = fixture16
    shutil.copytree(src, tmp_path / "d")
    d = tmp_path / "d"
    common = ["pipe", "--directory", str(d), "--pbf",
              str(d / os.path.basename(pbf)), "--shapefile",
              str(d / os.path.basename(shp)), "--simulate", "--max-steps", "24",
              "--chunk-size", "24", "--seed", "4", "--device", "cpu"]
    assert t_cli.main(common + ["--output-name", str(tmp_path / "a")]) == 0
    (d / "world_pipe.npz.build_timings.json").unlink()
    assert t_cli.main(common + ["--use-cache", "--output-name",
                                str(tmp_path / "b")]) == 0
    assert not (d / "world_pipe.npz.build_timings.json").exists()
    for name in ARTIFACTS:
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name


def test_cli_download_needs_no_card(tmp_path, monkeypatch):
    """--download and --resume compute nothing on a device: they run with
    no card, where every simulating mode raises."""
    from epidemicsimulator_tpu_torch.data.census import nomis
    from epidemicsimulator_tpu_torch.data.census.tables import (
        CensusTable, TABLE_SPECS)

    calls = []
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.setattr(nomis, "download_all_tables",
                        lambda directory, area: calls.append(("all", directory, area)))
    monkeypatch.setattr(nomis, "download_table",
                        lambda table, geo, dest, resume_from_row=None:
                        calls.append((table, geo, dest, resume_from_row)))
    d = str(tmp_path / "data")
    assert t_cli.main(["1946157112", "--directory", d, "--download"]) == 0
    assert t_cli.main(["1946157112", "--directory", d, "--resume", "2000000",
                       "--table", "OCCUPATION_COUNT"]) == 0
    assert calls == [
        ("all", d, "1946157112"),
        (CensusTable.OCCUPATION_COUNT, nomis.GEOGRAPHY_CODES["1946157112"],
         os.path.join(d, TABLE_SPECS[CensusTable.OCCUPATION_COUNT].filename),
         2_000_000)]
    with pytest.raises(RuntimeError, match="CUDA device"):
        t_cli.main(["york", "--directory", d, "--simulate"])


"""The port's ``viz/`` and the CLI's drawing flags against the JAX
package's, on the CPU.

Each drawing function of both packages draws the same inputs here, and
the PNG files must be byte-identical (both use this machine's matplotlib,
so they are).  Graphs must have equal node and edge sets (with equal
weights), and the DOT dumps equal text.  ``render_live`` with
``device="cpu"`` runs the port's fast step, the formulation of the JAX
package's ``SimConfig(use_fused_citizen=True, use_pallas_scans=True)``,
and its GIF must decode to the JAX ``render_live``'s frames, pixel for
pixel, titles (hour and S/E/I/R/V) included.  The CLI's ``--render``,
``--visualise`` and ``--visualise-buildings`` write the JAX CLI's files
and print its graph statistics.
"""

import os

import numpy as np
import pytest
import torch

from epidemicsimulator_tpu import Params as JParams
from epidemicsimulator_tpu import SimConfig as JSimConfig
from epidemicsimulator_tpu import generate_synthetic_world as j_world
from epidemicsimulator_tpu import cli as j_cli
from epidemicsimulator_tpu.viz import graphs as j_graphs
from epidemicsimulator_tpu.viz import live as j_live
from epidemicsimulator_tpu.viz import maps as j_maps

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch import cli as t_cli
from epidemicsimulator_tpu_torch.viz import graphs, live, maps
from epidemicsimulator_tpu_torch.world.geometry import synthetic_geometry


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the worlds here are small, and the suite runs
    several processes at once, whose thread pools would share the cores
    (``tests/test_torch_fastmesh.py`` says what that cost)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    return (j_world(3000, n_output_areas=6, seed=0),
            et.generate_synthetic_world(3000, n_output_areas=6, seed=0))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _rings():
    rings = np.array([(0, 0), (1, 0), (1, 1), (0, 1), (1, 0), (2, 0), (2, 1),
                      (1, 1)], float)
    return rings, np.array([0, 4, 4, 8], np.int64)  # one empty polygon


def _draw_calls():
    rng = np.random.default_rng(0)
    east, north = rng.uniform(0, 100, 500), rng.uniform(0, 100, 500)
    classes = rng.integers(0, 6, 500)
    rings, starts = _rings()
    t = np.arange(100)
    seirv = np.stack([1000 - t * 5, t * 2, t * 2, t, np.zeros_like(t)], 1)
    return {
        "draw_output_areas": ((rings, starts),
                              dict(values=np.array([1.0, 5.0]))),
        "draw_output_areas_plain": ((rings, starts), {}),
        "draw_buildings": ((east, north, classes), {}),
        "draw_buildings_sampled": ((east, north, classes),
                                   dict(max_points=200)),
        "draw_buildings_and_output_areas": (
            (rings, starts, east, north, classes), {}),
        "draw_school_catchments": ((east[:8], north[:8], east, north), {}),
        "plot_seirv_curves": ((seirv,), {}),
    }


@pytest.mark.parametrize("name", list(_draw_calls()))
def test_maps_draw_the_same_png(name, tmp_path):
    args, kw = _draw_calls()[name]
    fn = name.replace("_plain", "").replace("_sampled", "")
    want = getattr(j_maps, fn)(str(tmp_path / "j.png"), *args, **kw)
    got = getattr(maps, fn)(str(tmp_path / "t.png"), *args, **kw)
    assert got == str(tmp_path / "t.png")
    assert os.path.getsize(got) > 1000
    assert _bytes(got) == _bytes(want)


def _edges(g):
    return {(u, v, tuple(sorted(d.items()))) for u, v, d in g.edges(data=True)}


def test_graphs_match_jax(worlds, tmp_path):
    jw, tw = worlds
    for name, kw in (("citizen_connections", dict(max_citizens=1000)),
                     ("citizen_connections", dict(max_citizens=None)),
                     ("commuting_digraph", {}),
                     ("building_graph", dict(max_citizens=2000)),
                     ("building_graph", dict(max_citizens=None))):
        want = getattr(j_graphs, name)(jw, **kw)
        got = getattr(graphs, name)(tw.to("cpu"), **kw)
        assert set(got.nodes) == set(want.nodes), name
        assert _edges(got) == _edges(want), name
        assert got.is_directed() == want.is_directed()
        assert (graphs.connected_components_count(got)
                == j_graphs.connected_components_count(want))
        got_dot = graphs.dump_graphviz(got, str(tmp_path / "t.dot"))
        want_dot = j_graphs.dump_graphviz(want, str(tmp_path / "j.dot"))
        assert _bytes(got_dot) == _bytes(want_dot), name
    dg = graphs.commuting_digraph(tw)
    assert sum(d["weight"] for _, _, d in dg.edges(data=True)) == tw.n_citizens


def _gif_frames(path):
    from PIL import Image

    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
    return frames


def test_render_live_matches_jax(tmp_path):
    """Four frames of 12 steps on a 3,000-citizen world under a strong
    disease: the GIFs decode to the same frames."""
    import dataclasses

    jw = j_world(3000, n_output_areas=9, seed=3)
    tw = et.generate_synthetic_world(3000, n_output_areas=9, seed=3)
    geo = synthetic_geometry(tw, seed=3)
    base = JParams.covid()
    jp = JParams(dataclasses.replace(base.disease, exposure_chance=0.05),
                 base.thresholds)
    tp = et.Params(dataclasses.replace(et.Params.covid().disease,
                                       exposure_chance=0.05),
                   et.Params.covid().thresholds)
    kw = dict(frames=4, steps_per_frame=12, seed=1)
    want = j_live.render_live(
        jw, jp, JSimConfig(use_fused_citizen=True, use_pallas_scans=True,
                           starting_infected=30),
        geo.rings, geo.ring_starts, out_path=str(tmp_path / "j.gif"), **kw)
    got = live.render_live(tw, tp, et.SimConfig(starting_infected=30),
                           geo.rings, geo.ring_starts,
                           out_path=str(tmp_path / "t.gif"), device="cpu",
                           **kw)
    got_f, want_f = _gif_frames(got), _gif_frames(want)
    assert len(got_f) == len(want_f) == 4
    for a, b in zip(got_f, want_f):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got_f[0], got_f[-1])


@pytest.mark.parametrize("flag,default", [
    ("--render", "demo_building_density.png"),
    ("--visualise", "demo_buildings_and_oas.png"),
    ("--visualise-buildings", "demo_raw_buildings.png"),
])
def test_cli_drawing_flags_match_jax(flag, default, tmp_path, capsys,
                                     monkeypatch):
    """Each flag on a synthetic world, built (which writes the geometry
    sidecar) and then from the cache: the port writes the JAX CLI's file,
    byte for byte, and prints its statistics; with no ``--output-name``
    the default name."""
    monkeypatch.setenv("ESUCD_NO_COMPILE_CACHE", "1")
    outs = {}
    for name, main, extra in (("j", j_cli.main, ["--no-compile-cache"]),
                              ("t", t_cli.main, [])):
        d = tmp_path / name
        d.mkdir()
        out = str(d / "out.png")
        assert main(["demo", "--synthetic", "2000", flag, "--directory",
                     str(d), "--output-name", out, *extra]) == 0
        printed = capsys.readouterr().out
        assert main(["demo", "--synthetic", "2000", flag, "--use-cache",
                     "--directory", str(d), "--output-name",
                     str(d / "cached.png"), *extra]) == 0
        assert capsys.readouterr().out == printed
        outs[name] = (_bytes(out), _bytes(d / "cached.png"), printed)
    assert outs["t"] == outs["j"]
    assert outs["t"][0] == outs["t"][1]
    if flag == "--render":
        assert "nodes and" in outs["t"][2] and "connected groups" in outs["t"][2]
    monkeypatch.chdir(tmp_path / "t")
    assert t_cli.main(["demo", "--synthetic", "2000", flag, "--use-cache",
                       "--directory", str(tmp_path / "t")]) == 0
    assert _bytes(tmp_path / "t" / default) == outs["t"][0]


def test_cli_drawing_needs_geometry(tmp_path):
    """A cached world without its geometry sidecar cannot be drawn."""
    assert t_cli.main(["demo", "--synthetic", "500", "--simulate",
                       "--max-steps", "1", "--chunk-size", "1", "--device",
                       "cpu", "--directory", str(tmp_path), "--output-name",
                       str(tmp_path / "run")]) == 0
    os.remove(tmp_path / "geometry_demo.npz")
    assert t_cli.main(["demo", "--synthetic", "500", "--render",
                       "--use-cache", "--directory", str(tmp_path)]) == 1

"""PNG map export: OA polygons coloured by a measure + building scatter.

The port's copy of ``epidemicsimulator_tpu/viz/maps.py``: the matplotlib
replacement for the reference's plotters-based image export
(visualisation/src/image_export.rs: DrawingRecord, draw_output_areas,
draw_buildings, draw_buildings_and_output_areas).  Host-only: matplotlib
(and scipy for the catchments) are imported inside each function.
"""

from __future__ import annotations

import numpy as np


def _polygons(rings, ring_starts):
    """The non-empty polygons of a ring table."""
    return [
        rings[ring_starts[i]: ring_starts[i + 1]]
        for i in range(len(ring_starts) - 1)
        if ring_starts[i + 1] > ring_starts[i]
    ]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_output_areas(
    filename: str,
    rings: np.ndarray,
    ring_starts: np.ndarray,
    values: np.ndarray | None = None,
    *,
    title: str = "Output Areas",
    dpi: int = 150,
):
    """Render OA polygons, colour-scaled by ``values`` (one per polygon)."""
    plt = _pyplot()
    from matplotlib.collections import PolyCollection

    fig, ax = plt.subplots(figsize=(10, 10))
    pc = PolyCollection(_polygons(rings, ring_starts), edgecolor="black",
                        linewidth=0.2)
    if values is not None:
        pc.set_array(np.asarray(values, float))
        pc.set_cmap("viridis")
        fig.colorbar(pc, ax=ax, shrink=0.7)
    else:
        pc.set_facecolor("#dddddd")
    ax.add_collection(pc)
    ax.autoscale()
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.savefig(filename, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return filename


def draw_buildings(
    filename: str,
    east: np.ndarray,
    north: np.ndarray,
    classes: np.ndarray,
    *,
    title: str = "Buildings",
    dpi: int = 150,
    max_points: int = 500_000,
):
    """Scatter of classified buildings (image_export.rs draw_buildings)."""
    plt = _pyplot()

    from ..data.osm.native import BUILDING_CLASSES

    n = len(east)
    if n > max_points:
        sel = np.random.default_rng(0).choice(n, max_points, replace=False)
        east, north, classes = east[sel], north[sel], classes[sel]
    fig, ax = plt.subplots(figsize=(10, 10))
    colors = ["tab:orange", "tab:green", "tab:red", "tab:blue", "tab:purple", "grey"]
    for cls in np.unique(classes):
        m = classes == cls
        ax.scatter(
            east[m], north[m], s=0.5,
            c=colors[int(cls) % len(colors)],
            label=BUILDING_CLASSES[int(cls)],
        )
    ax.legend(markerscale=20)
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.savefig(filename, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return filename


def draw_buildings_and_output_areas(
    filename: str, rings, ring_starts, east, north, classes, **kw
):
    """OA outlines with every building on top (image_export.rs
    draw_buildings_and_output_areas); ``classes`` is accepted for the
    reference's signature and not drawn."""
    plt = _pyplot()
    from matplotlib.collections import PolyCollection

    fig, ax = plt.subplots(figsize=(12, 12))
    ax.add_collection(
        PolyCollection(_polygons(rings, ring_starts), facecolor="none",
                       edgecolor="black", linewidth=0.3)
    )
    ax.scatter(east, north, s=0.4, c="tab:blue")
    ax.autoscale()
    ax.set_aspect("equal")
    fig.savefig(filename, dpi=kw.get("dpi", 150), bbox_inches="tight")
    plt.close(fig)
    return filename


def draw_school_catchments(
    filename: str,
    school_east: np.ndarray,
    school_north: np.ndarray,
    point_east: np.ndarray,
    point_north: np.ndarray,
    *,
    dpi: int = 150,
):
    """Nearest-school catchments: the matplotlib equivalent of the
    reference's Voronoi PNG dump (osm_data/src/draw_voronoi.rs), each
    point coloured by its nearest school (the Voronoi cell it falls in)."""
    plt = _pyplot()
    from scipy.spatial import cKDTree

    tree = cKDTree(np.c_[school_east, school_north])
    _, owner = tree.query(np.c_[point_east, point_north])
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.scatter(point_east, point_north, s=1, c=owner, cmap="tab20")
    ax.scatter(school_east, school_north, s=80, c="black", marker="*")
    ax.set_aspect("equal")
    ax.set_title("school catchments (nearest-seed)")
    fig.savefig(filename, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return filename


def plot_seirv_curves(filename: str, seirv: np.ndarray, *, title="SEIRV"):
    """Epidemic curves from a (T, 5) series (the statistics notebooks'
    main figure, statistics_results/statistics.ipynb)."""
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(10, 6))
    labels = ["Susceptible", "Exposed", "Infected", "Recovered", "Vaccinated"]
    for i, lbl in enumerate(labels):
        ax.plot(np.arange(1, len(seirv) + 1), seirv[:, i], label=lbl)
    ax.set_xlabel("hour")
    ax.set_ylabel("citizens")
    ax.legend()
    ax.set_title(title)
    fig.savefig(filename, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return filename

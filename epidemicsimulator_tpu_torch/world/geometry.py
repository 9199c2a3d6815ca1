"""World geometry sidecar: OA boundary rings + building scatter.

The reference keeps polygons inside each OutputArea object so every
visualise mode can draw them (run/src/visualise.rs:33-41,
run/src/main.rs:214-288).  Here the device world is pure index tables, so
the drawable geometry lives in a sidecar ``.npz`` written at world-build
time and reloaded for cached worlds — which is what lets ``--render`` /
``--visualise`` work together with ``--use-cache`` (the reference
re-derives polygons from the shapefile on every run instead).

The port's copy of ``epidemicsimulator_tpu/world/geometry.py``; a
world's lanes may be numpy arrays or torch tensors on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class WorldGeometry:
    rings: np.ndarray        # (M, 2) float64 national-grid vertices
    ring_starts: np.ndarray  # (P + 1,) int64, polygon p = rings[s[p]:s[p+1]]
    codes: list[str]         # OA code per polygon
    b_east: np.ndarray       # (B,) building scatter (may be empty)
    b_north: np.ndarray      # (B,)
    b_classes: np.ndarray    # (B,) int8 BUILDING_CLASSES index

    @property
    def n_polygons(self) -> int:
        return len(self.ring_starts) - 1

    def save_npz(self, path: str) -> None:
        np.savez_compressed(
            path,
            rings=self.rings,
            ring_starts=self.ring_starts,
            codes=np.asarray(self.codes, dtype="U16"),
            b_east=self.b_east,
            b_north=self.b_north,
            b_classes=self.b_classes,
        )

    @staticmethod
    def load_npz(path: str) -> "WorldGeometry":
        with np.load(path) as z:
            return WorldGeometry(
                rings=z["rings"],
                ring_starts=z["ring_starts"],
                codes=[str(c) for c in z["codes"]],
                b_east=z["b_east"],
                b_north=z["b_north"],
                b_classes=z["b_classes"],
            )


def buildings_per_output_area(world) -> np.ndarray:
    """Distinct buildings assigned to each OA (the reference's
    ``area.buildings.len()`` measure for the BuildingDensity choropleth,
    run/src/main.rs:246-261): households count toward their home OA,
    workplaces/schools toward their work OA."""
    home_b = _host(world.home_building)
    home_oa = _host(world.home_oa)
    work_b = _host(world.work_building)
    work_oa = _host(world.work_oa)
    pairs = np.unique(
        np.concatenate(
            [
                np.stack([home_b, home_oa], 1),
                np.stack([work_b, work_oa], 1),
            ]
        ),
        axis=0,
    )
    return np.bincount(pairs[:, 1], minlength=world.n_output_areas)


def synthetic_geometry(world, seed: int = 0) -> WorldGeometry:
    """Drawable geometry for a synthetic world: OAs as unit tiles on a
    square grid, buildings scattered uniformly inside their OA's tile.
    Gives the CLI visualise modes a real surface to draw without census
    shapefiles (class indices follow data.osm.native.BUILDING_CLASSES:
    household=3, workplace=4)."""
    n_oa = world.n_output_areas
    side = int(np.ceil(np.sqrt(n_oa)))
    rings = []
    starts = [0]
    for oa in range(n_oa):
        x, y = oa % side, oa // side
        rings.append(
            np.array(
                [(x, y), (x + 1, y), (x + 1, y + 1), (x, y + 1)], float
            )
        )
        starts.append(starts[-1] + 4)

    home_b = _host(world.home_building)
    home_oa = _host(world.home_oa)
    work_b = _host(world.work_building)
    work_oa = _host(world.work_oa)
    hh = np.unique(np.stack([home_b, home_oa], 1), axis=0)
    wp = np.unique(np.stack([work_b, work_oa], 1), axis=0)
    # a workplace building may double as someone's home in degenerate toy
    # worlds; classify household first like dedupe order in the builder
    wp = wp[~np.isin(wp[:, 0], hh[:, 0])]
    oa_of = np.concatenate([hh[:, 1], wp[:, 1]])
    classes = np.concatenate(
        [np.full(len(hh), 3, np.int8), np.full(len(wp), 4, np.int8)]
    )
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(0.05, 0.95, (len(oa_of), 2))
    east = (oa_of % side) + jitter[:, 0]
    north = (oa_of // side) + jitter[:, 1]
    return WorldGeometry(
        rings=np.concatenate(rings, axis=0),
        ring_starts=np.asarray(starts, np.int64),
        codes=[f"SYN{int(i):08d}" for i in range(n_oa)],
        b_east=east,
        b_north=north,
        b_classes=classes,
    )

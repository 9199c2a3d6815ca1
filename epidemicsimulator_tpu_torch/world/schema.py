"""Static world tables: struct-of-arrays over N citizens.

A copy of ``epidemicsimulator_tpu/world/schema.py`` without JAX.  Lanes are
built on the host as numpy arrays (``make_world`` canonicalises the order
and derives the index and fast-path tables); :meth:`World.to` moves every
lane onto a torch device.  Citizens are sorted by home building, buildings
are numbered OA-major, and the "work order" sorts citizens by
(work_building, room), so households, work buildings, school rooms and
OAs are all contiguous runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

_STATIC = dict(static=True)


@dataclasses.dataclass(frozen=True)
class World:
    """Immutable world tables; every per-citizen lane has shape (N,)."""

    # per-citizen lanes
    age: Any                    # int16
    occupation: Any             # int8
    home_building: Any          # int32
    work_building: Any          # int32
    home_oa: Any                # int32
    work_oa: Any                # int32
    room: Any                   # int32, n_rooms = "no room"
    is_school_work: Any         # bool
    uses_transport: Any         # bool
    mask_compliant: Any         # bool
    work_start: Any             # int8
    work_end: Any               # int8

    n_buildings: int = dataclasses.field(metadata=_STATIC)
    n_rooms: int = dataclasses.field(metadata=_STATIC)
    n_output_areas: int = dataclasses.field(metadata=_STATIC)

    # index tables (build_index_tables)
    home_lo: Any = None
    home_hi: Any = None
    work_perm: Any = None      # citizen ids in work order
    wb_lo: Any = None
    wb_hi: Any = None
    room_lo: Any = None
    room_hi: Any = None
    rider_perm: Any = None     # transport users sorted by (home_oa, work_oa)
    rider_route: Any = None    # dense route id per rider
    rider_mask_compliant: Any = None
    rpos: Any = None           # rider slot, non-riders get fillers >= R

    # fast-path tables (build_fast_tables)
    wpos: Any = None           # rank of each citizen in work order
    home_start_mask: Any = None
    home_end_mask: Any = None
    ws_wb_start_mask: Any = None
    ws_wb_end_mask: Any = None
    ws_room_start_mask: Any = None
    ws_room_end_mask: Any = None
    ws_home_oa: Any = None
    ws_work_oa: Any = None
    ws_mask_compliant: Any = None
    ws_is_school: Any = None
    ws_work_neq_home: Any = None
    ws_uses_transport: Any = None
    ws_work_start: Any = None
    ws_work_end: Any = None
    oa_lo: Any = None
    oa_hi: Any = None
    ws_oa_lo: Any = None
    ws_oa_hi: Any = None
    hh_pos: Any = None
    hh_size: Any = None
    max_household_size: int = dataclasses.field(default=0, metadata=_STATIC)

    CORE_LANES = (
        "age", "occupation", "home_building", "work_building", "home_oa",
        "work_oa", "room", "is_school_work", "uses_transport",
        "mask_compliant", "work_start", "work_end",
    )

    @property
    def n_citizens(self) -> int:
        return int(self.age.shape[-1])

    @property
    def n_riders(self) -> int:
        return int(self.rider_perm.shape[0])

    @property
    def has_fast_tables(self) -> bool:
        return self.wpos is not None and self.wpos.shape[0] > 0

    @property
    def has_index_tables(self) -> bool:
        return self.home_lo is not None and self.home_lo.shape[0] > 0

    def without_index_tables(self) -> "World":
        """The world with every derived lane size 0 (the JAX package's
        ``without_index_tables``): its steps take the portable step's
        segment-sum branch, and the sharded engine slices the core lanes
        alone.  The lanes keep the world's kind: numpy, or tensors on the
        world's device."""
        lane = self.home_building
        empty = (torch.zeros(0, dtype=torch.int32, device=lane.device)
                 if isinstance(lane, torch.Tensor) else np.zeros(0, np.int32))
        return dataclasses.replace(self, **{
            f.name: empty for f in dataclasses.fields(self)
            if f.name not in self.CORE_LANES and not f.metadata.get("static")
        })

    def lane_names(self):
        return [
            f.name for f in dataclasses.fields(self)
            if not f.metadata.get("static") and getattr(self, f.name) is not None
        ]

    def to(self, device) -> "World":
        """Every lane as a torch tensor on ``device`` (dtypes kept)."""
        return dataclasses.replace(self, **{
            name: torch.as_tensor(np.asarray(getattr(self, name))).to(device)
            if not isinstance(getattr(self, name), torch.Tensor)
            else getattr(self, name).to(device)
            for name in self.lane_names()
        })

    # The world cache: the JAX package's npz layout, key for key (the
    # statics in ``__meta__``), so a world saved by either package loads
    # in the other.
    def save_npz(self, path: str) -> None:
        """Every lane, from the host or a device, to a compressed npz."""
        host = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.savez_compressed(
            path,
            __meta__=np.array(
                [self.n_buildings, self.n_rooms, self.n_output_areas,
                 self.max_household_size],
                np.int64,
            ),
            **{name: host(getattr(self, name)) for name in self.lane_names()},
        )

    @staticmethod
    def load_npz(path: str) -> "World":
        """A world with numpy lanes (move it with :meth:`to`)."""
        with np.load(path) as data:
            meta = data["__meta__"]
            kwargs = {k: data[k] for k in data.files if k != "__meta__"}
        return World(
            n_buildings=int(meta[0]),
            n_rooms=int(meta[1]),
            n_output_areas=int(meta[2]),
            max_household_size=int(meta[3]) if len(meta) > 3 else 0,
            **kwargs,
        )

    def validate(self) -> None:
        n = self.n_citizens
        for name in self.CORE_LANES:
            if getattr(self, name).shape[-1] != n:
                raise ValueError(f"lane {name} does not have {n} citizens")
        checks = (
            ("home_building", 0, self.n_buildings - 1),
            ("work_building", 0, self.n_buildings - 1),
            ("room", 0, self.n_rooms),
            ("home_oa", 0, self.n_output_areas - 1),
            ("work_oa", 0, self.n_output_areas - 1),
        )
        for name, lo, hi in checks:
            lane = getattr(self, name)  # numpy, or a tensor on any device
            if n and (int(lane.min()) < lo or int(lane.max()) > hi):
                raise ValueError(f"lane {name} outside [{lo}, {hi}]")

    def build_index_tables(self) -> "World":
        """Static range and permutation tables; citizens must be sorted by
        home_building (make_world canonicalises)."""
        hb = np.asarray(self.home_building, np.int64)
        wb = np.asarray(self.work_building, np.int64)
        rm = np.asarray(self.room, np.int64)
        n = len(hb)
        if (np.diff(hb) < 0).any():
            raise ValueError("citizens must be sorted by home_building")

        counts = np.bincount(hb, minlength=self.n_buildings)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        home_lo = starts[hb]
        home_hi = home_lo + counts[hb]

        pair0 = wb * (self.n_rooms + 2) + rm
        work_perm = np.argsort(pair0, kind="stable")
        wb_sorted = wb[work_perm]
        wcounts = np.bincount(wb_sorted, minlength=self.n_buildings)
        wstarts = np.concatenate([[0], np.cumsum(wcounts)[:-1]])
        wb_lo = wstarts[wb]
        wb_hi = wb_lo + wcounts[wb]

        pair = pair0[work_perm]
        boundary = np.empty(n, np.bool_)
        if n:
            boundary[0] = True
            boundary[1:] = pair[1:] != pair[:-1]
        idx = np.arange(n, dtype=np.int64)
        seg_start = np.maximum.accumulate(np.where(boundary, idx, 0))
        run_id = np.cumsum(boundary) - 1
        run_len = np.bincount(run_id)
        room_lo = np.empty(n, np.int64)
        room_hi = np.empty(n, np.int64)
        room_lo[work_perm] = seg_start
        room_hi[work_perm] = seg_start + run_len[run_id]

        ut = np.asarray(self.uses_transport)
        riders = np.flatnonzero(ut)
        route_key = (
            np.asarray(self.home_oa, np.int64)[riders] * self.n_output_areas
            + np.asarray(self.work_oa, np.int64)[riders]
        )
        order = np.argsort(route_key, kind="stable")
        rider_perm = riders[order]
        rk_sorted = route_key[order]
        if len(rk_sorted):
            rb = np.empty(len(rk_sorted), np.bool_)
            rb[0] = True
            np.not_equal(rk_sorted[1:], rk_sorted[:-1], out=rb[1:])
            rider_route = np.cumsum(rb) - 1
        else:
            rider_route = np.zeros(0, np.int64)
        rider_mask_compliant = np.asarray(self.mask_compliant)[rider_perm]

        r = len(rider_perm)
        rpos = np.empty(n, np.int64)
        rpos[rider_perm] = np.arange(r)
        non_rider = np.ones(n, np.bool_)
        non_rider[rider_perm] = False
        rpos[non_rider] = r + np.arange(n - r)

        i32 = lambda x: x.astype(np.int32)
        out = dataclasses.replace(
            self,
            home_lo=i32(home_lo), home_hi=i32(home_hi),
            work_perm=i32(work_perm), wb_lo=i32(wb_lo), wb_hi=i32(wb_hi),
            room_lo=i32(room_lo), room_hi=i32(room_hi),
            rider_perm=i32(rider_perm), rider_route=i32(rider_route),
            rider_mask_compliant=rider_mask_compliant, rpos=i32(rpos),
        )
        return out.build_fast_tables()

    def build_fast_tables(self) -> "World":
        """Run masks, work-order copies of static lanes and per-OA ranges."""
        n = self.n_citizens
        hb = np.asarray(self.home_building, np.int64)
        wp = np.asarray(self.work_perm, np.int64)
        wb_ws = np.asarray(self.work_building, np.int64)[wp]
        rm_ws = np.asarray(self.room, np.int64)[wp]

        wpos = np.empty(n, np.int64)
        wpos[wp] = np.arange(n)

        def run_masks(keys):
            start = np.empty(len(keys), np.bool_)
            end = np.empty(len(keys), np.bool_)
            if len(keys):
                start[0] = True
                start[1:] = keys[1:] != keys[:-1]
                end[-1] = True
                end[:-1] = keys[1:] != keys[:-1]
            return start, end

        h_s, h_e = run_masks(hb)
        wb_s, wb_e = run_masks(wb_ws)
        rm_s, rm_e = run_masks(wb_ws * (self.n_rooms + 2) + rm_ws)

        ho = np.asarray(self.home_oa, np.int64)
        wo_ws = np.asarray(self.work_oa, np.int64)[wp]

        def oa_ranges(oas):
            counts = np.bincount(oas, minlength=self.n_output_areas)
            hi = np.cumsum(counts)
            if not (np.diff(oas) >= 0).all():
                return None, None
            return hi - counts, hi

        oa_lo, oa_hi = oa_ranges(ho)
        ws_oa_lo, ws_oa_hi = oa_ranges(wo_ws)
        if oa_lo is None or ws_oa_lo is None:
            empty = np.zeros(0, np.int64)
            oa_lo = oa_hi = ws_oa_lo = ws_oa_hi = empty

        home_lo = np.asarray(self.home_lo, np.int64)
        home_hi = np.asarray(self.home_hi, np.int64)
        hh_pos = np.arange(n) - home_lo
        hh_size = home_hi - home_lo
        max_hh = int(hh_size.max()) if n else 0

        i32 = lambda x: x.astype(np.int32)
        return dataclasses.replace(
            self,
            hh_pos=hh_pos.astype(np.int16),
            hh_size=hh_size.astype(np.int16),
            max_household_size=max_hh,
            wpos=i32(wpos),
            home_start_mask=h_s, home_end_mask=h_e,
            ws_wb_start_mask=wb_s, ws_wb_end_mask=wb_e,
            ws_room_start_mask=rm_s, ws_room_end_mask=rm_e,
            ws_home_oa=np.asarray(self.home_oa)[wp],
            ws_work_oa=np.asarray(self.work_oa)[wp],
            ws_mask_compliant=np.asarray(self.mask_compliant)[wp],
            ws_is_school=np.asarray(self.is_school_work)[wp],
            ws_work_neq_home=(
                np.asarray(self.work_building) != np.asarray(self.home_building)
            )[wp],
            ws_uses_transport=np.asarray(self.uses_transport)[wp],
            ws_work_start=np.asarray(self.work_start)[wp],
            ws_work_end=np.asarray(self.work_end)[wp],
            oa_lo=i32(oa_lo), oa_hi=i32(oa_hi),
            ws_oa_lo=i32(ws_oa_lo), ws_oa_hi=i32(ws_oa_hi),
        )


def make_world(
    *,
    age, occupation, home_building, work_building, home_oa, work_oa, room,
    is_school_work, uses_transport, mask_compliant,
    n_buildings: int, n_rooms: int, n_output_areas: int,
    work_start=9, work_end=17,
) -> World:
    """A validated ``World`` from host arrays, in canonical order."""
    n = len(age)

    def lane(x, dtype):
        if np.isscalar(x):
            x = np.full(n, x)
        return np.ascontiguousarray(x).astype(dtype)

    # OA-major building numbering keeps OA runs contiguous in both orders.
    hb0 = np.asarray(home_building, np.int32)
    wb0 = np.asarray(work_building, np.int32)
    if n:
        b_oa = np.zeros(int(n_buildings), np.int32)
        b_oa[wb0] = np.asarray(work_oa, np.int32)
        b_oa[hb0] = np.asarray(home_oa, np.int32)
        order_b = np.argsort(b_oa, kind="stable")
        new_id = np.empty(int(n_buildings), np.int32)
        new_id[order_b] = np.arange(int(n_buildings), dtype=np.int32)
        home_building = new_id[hb0]
        work_building = new_id[wb0]

    hb = np.asarray(home_building)
    if n and (np.diff(hb) < 0).any():
        order = np.argsort(hb, kind="stable")
        (age, occupation, home_building, work_building, home_oa, work_oa,
         room, is_school_work, uses_transport, mask_compliant) = (
            np.asarray(x)[order]
            for x in (age, occupation, home_building, work_building, home_oa,
                      work_oa, room, is_school_work, uses_transport,
                      mask_compliant)
        )
        if not np.isscalar(work_start):
            work_start = np.asarray(work_start)[order]
        if not np.isscalar(work_end):
            work_end = np.asarray(work_end)[order]

    world = World(
        age=lane(age, np.int16),
        occupation=lane(occupation, np.int8),
        home_building=lane(home_building, np.int32),
        work_building=lane(work_building, np.int32),
        home_oa=lane(home_oa, np.int32),
        work_oa=lane(work_oa, np.int32),
        room=lane(room, np.int32),
        is_school_work=lane(is_school_work, np.bool_),
        uses_transport=lane(uses_transport, np.bool_),
        mask_compliant=lane(mask_compliant, np.bool_),
        work_start=lane(work_start, np.int8),
        work_end=lane(work_end, np.int8),
        n_buildings=int(n_buildings),
        n_rooms=int(n_rooms),
        n_output_areas=int(n_output_areas),
    )
    world.validate()
    return world.build_index_tables()

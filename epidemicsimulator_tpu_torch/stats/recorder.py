"""Statistics recording and the four JSON artifacts.

Reproduces the on-disk contract of the reference's ``StatisticsRecorder``
(statistics.rs:98-204):

* ``global_stats.json`` — list of ``{time_step, susceptible, exposed,
  infected, recovered, vaccinated}`` entries, 1-based time steps, plus the
  trailing all-zero entry the reference appends when ``dump_to_file`` calls
  ``next()`` one final time (statistics.rs:113-116) — shipped runs therefore
  have steps+1 entries (e.g. 5001 in statistics_results/v1.7.1).
* ``exposures.json`` — ``{"All": {...}, "OutputArea": {code: [per-step
  counts]}, "PublicTransport": {}}``.  The reference's "All" entry is
  overwritten per drain iteration and lands on an arbitrary place's series
  (statistics.rs:119-136); we write the meaningful total-exposures series
  instead and document the divergence here.  PublicTransport entries are
  commented out in the reference dump; we keep the empty object.
* ``timings.json`` — list of per-step ``{phase: seconds}`` maps.  Our step is
  one fused kernel, so each entry carries ``{"Step": t, "total": t}`` with t
  the per-step average of the enclosing chunk's wall time.
* ``memory.json`` — list of per-step memory usage strings ("X.XX GB").

A copy of ``epidemicsimulator_tpu/stats/recorder.py``: given the same
chunk outputs, ``global_stats.json`` and ``exposures.json`` are
byte-identical to the JAX package's; ``timings.json`` and ``memory.json``
hold this run's clock and memory readings.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _memory_usage_string(device=None) -> str:
    """Memory in use: the tensors allocated on ``device`` when it is a
    CUDA device, else this process's virtual size (``/proc/self/statm``)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return f"{torch.cuda.memory_allocated(dev) / 1024**3:.2f} GB"
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[0])
        return f"{pages * os.sysconf('SC_PAGE_SIZE') / 1024**3:.2f} GB"
    except (OSError, ValueError):
        return "0.00 GB"


@dataclass
class StatisticsRecorder:
    """Accumulates chunk outputs on the host and writes the JSON artifacts."""

    oa_codes: list[str] | None = None
    #: the run's device, whose memory ``memory.json`` records
    device: object = None
    seirv: list[np.ndarray] = field(default_factory=list)
    exposures_per_oa: list[np.ndarray] = field(default_factory=list)
    n_exposures: list[np.ndarray] = field(default_factory=list)
    chunk_times: list[tuple[int, float]] = field(default_factory=list)
    memory_entries: list[tuple[int, str]] = field(default_factory=list)
    _chunk_started: float = field(default_factory=time.perf_counter)

    def start_chunk(self) -> None:
        self._chunk_started = time.perf_counter()

    def record_chunk(self, outputs) -> None:
        """outputs: a StepOutput of numpy arrays for one chunk."""
        elapsed = time.perf_counter() - self._chunk_started
        n_steps = outputs.seirv.shape[0]
        self.seirv.append(np.asarray(outputs.seirv))
        self.n_exposures.append(np.asarray(outputs.n_exposures))
        if outputs.exposures_per_oa.size:
            self.exposures_per_oa.append(np.asarray(outputs.exposures_per_oa))
        self.chunk_times.append((n_steps, elapsed))
        self.memory_entries.append((n_steps, _memory_usage_string(self.device)))
        self._chunk_started = time.perf_counter()

    # -- views -----------------------------------------------------------
    @property
    def global_stats(self) -> np.ndarray:
        if not self.seirv:
            return np.zeros((0, 5), np.int64)
        return np.concatenate(self.seirv, axis=0)

    def truncate(self, n_steps: int) -> None:
        g = self.global_stats[:n_steps]
        self.seirv = [g]
        if self.exposures_per_oa:
            e = np.concatenate(self.exposures_per_oa, axis=0)[:n_steps]
            self.exposures_per_oa = [e]
        if self.n_exposures:
            ne = np.concatenate(self.n_exposures, axis=0)[:n_steps]
            self.n_exposures = [ne]

    def dump_to_file(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        g = self.global_stats
        steps = g.shape[0]

        entries = [
            {
                "time_step": int(i + 1),
                "susceptible": int(row[0]),
                "exposed": int(row[1]),
                "infected": int(row[2]),
                "recovered": int(row[3]),
                "vaccinated": int(row[4]),
            }
            for i, row in enumerate(g)
        ]
        # Trailing zero entry appended by the reference's final next().
        entries.append(
            {
                "time_step": steps + 1,
                "susceptible": 0,
                "exposed": 0,
                "infected": 0,
                "recovered": 0,
                "vaccinated": 0,
            }
        )
        with open(os.path.join(directory, "global_stats.json"), "w") as f:
            json.dump(entries, f)

        exposures: dict = {"All": {}, "OutputArea": {}, "PublicTransport": {}}
        if self.n_exposures:
            total = np.concatenate(self.n_exposures, axis=0)
            exposures["All"]["All"] = [int(x) for x in total]
        if self.exposures_per_oa:
            per_oa = np.concatenate(self.exposures_per_oa, axis=0)  # (T, n_oa)
            n_oa = per_oa.shape[1]
            codes = self.oa_codes or [f"OA{i:08d}" for i in range(n_oa)]
            nonzero = np.flatnonzero(per_oa.sum(axis=0))
            # Column-major copy once, then C-speed tolist per series (a
            # Python int() loop here cost ~10s at Y&H scale).
            cols = np.asarray(per_oa[:, nonzero], order="F")
            for j, oa in enumerate(nonzero):
                exposures["OutputArea"][codes[oa]] = cols[:, j].tolist()
        with open(os.path.join(directory, "exposures.json"), "w") as f:
            json.dump(exposures, f)

        timings = []
        for n_steps, elapsed in self.chunk_times:
            per_step = elapsed / max(n_steps, 1)
            timings.extend(
                {"Step": per_step, "total": per_step} for _ in range(n_steps)
            )
        with open(os.path.join(directory, "timings.json"), "w") as f:
            json.dump(timings[:steps], f)

        memory = []
        for n_steps, mem in self.memory_entries:
            memory.extend(mem for _ in range(n_steps))
        with open(os.path.join(directory, "memory.json"), "w") as f:
            json.dump(memory[:steps], f)

"""User-facing Simulator: the analog of ``sim/src/simulator.rs``'s Simulator.

The port's copy of ``epidemicsimulator_tpu/engine/simulator.py`` for one
device.  It owns a :class:`World` on the run's device, the parameters and
the state, and runs the chunked fused step with host-side statistics
recording, intervention-transition lines, checkpoints and progress
printing (simulator.rs:108-127).

Two behaviours of the JAX package's single-device Simulator are kept as
they are: a run resumed from a checkpoint steps another ``max_steps``
hours (the chunk loop counts from 0 whatever the state's hour), and its
recorder starts empty (the checkpoint's ``__seirv__`` rows are not
read back).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import Params, SimConfig
from ..runtime import resolve_device
from ..stats.recorder import StatisticsRecorder, _memory_usage_string
from ..world.schema import World
from .checkpoint import load_state, save_state
from .fastpath import wants_fixed_priority_vax
from .scan import run
from .state import SimState, init_state

_MASK_NAMES = {0: "None", 1: "Only Public Transport", 2: "Everywhere"}


class Simulator:
    def __init__(
        self,
        world: World,
        params: Params | None = None,
        cfg: SimConfig | None = None,
        *,
        seed: int = 0,
        oa_codes: list[str] | None = None,
        verbose: bool = True,
        profile_dir: str | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every_chunks: int = 0,
        devices: int | None = None,
        device="cuda",
    ):
        """``profile_dir``: write a torch.profiler Chrome trace of the
        third chunk there.  ``checkpoint_path``: snapshot the state every
        ``checkpoint_every_chunks`` chunks, and resume from an existing
        snapshot.  ``devices`` (the JAX package's population-sharded
        engine) is not ported yet.  ``device``: the run's device; the
        card unless the caller passes ``"cpu"``."""
        if devices is not None:
            raise NotImplementedError(
                "the population-sharded engine (devices=...) is not ported "
                "yet (ROADMAP.md Queue 1 item 8)")
        self.device = resolve_device(device)
        self.params = params or Params.covid()
        self.cfg = cfg or SimConfig()
        self.seed = seed
        self.verbose = verbose
        self.recorder = StatisticsRecorder(oa_codes=oa_codes, device=self.device)
        self.profile_dir = profile_dir
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every_chunks = checkpoint_every_chunks
        self._profiler = None
        self.world = world.to(self.device)
        self.state: SimState = init_state(
            self.world, seed=seed, starting_infected=self.cfg.starting_infected,
            fixed_priority_vax=wants_fixed_priority_vax(self.world, self.cfg),
            device=self.device,
        )
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            self.state, _ = load_state(checkpoint_path, device=self.device)
            if verbose:
                print(f"resumed from {checkpoint_path} at hour {self.state.hour}")

    def simulate(self, output_dir: str | None = None) -> np.ndarray:
        """Run to completion; optionally dump the four JSON artifacts.

        Returns the (T, 5) SEIRV series.
        """
        t0 = time.perf_counter()
        last_print = [t0]

        chunk_counter = [0]
        prev_flags = [False, 0]  # lockdown, mask_status

        def _log_interventions(steps_done, out):
            # Transition logging, matching the reference's info! lines
            # (simulator.rs:462-521, interventions.rs:145-175).
            lock = np.asarray(out.lockdown)
            mask = np.asarray(out.mask_status)
            base = steps_done - len(lock)
            for i in range(len(lock)):
                if bool(lock[i]) != prev_flags[0]:
                    print(
                        f"Lockdown is {'enabled' if lock[i] else 'lifted'} "
                        f"at hour {base + i + 1}"
                    )
                    prev_flags[0] = bool(lock[i])
                if int(mask[i]) != prev_flags[1]:
                    print(
                        f"Mask wearing status has changed: "
                        f"{_MASK_NAMES[int(mask[i])]} at hour {base + i + 1}"
                    )
                    prev_flags[1] = int(mask[i])

        def callback(steps_done, out, state):
            self.recorder.record_chunk(out)
            if self.verbose:
                _log_interventions(steps_done, out)
            chunk_counter[0] += 1
            if self.profile_dir and chunk_counter[0] == 2:
                self._start_profile()
            elif self.profile_dir and chunk_counter[0] == 3:
                self._stop_profile()
            if (
                self.checkpoint_path
                and self.checkpoint_every_chunks
                and chunk_counter[0] % self.checkpoint_every_chunks == 0
            ):
                save_state(self.checkpoint_path, state,
                           self.recorder.global_stats)
            if self.verbose:
                row = out.seirv[-1]
                now = time.perf_counter()
                print(
                    f"Completed {steps_done:>5} time steps, in: "
                    f"{now - last_print[0]:6.2f} seconds  "
                    f"S: {row[0]:,} E: {row[1]:,} I: {row[2]:,} "
                    f"R: {row[3]:,} V: {row[4]:,},   "
                    f"Memory usage: {_memory_usage_string(self.device)}"
                )
                last_print[0] = now

        self.recorder.start_chunk()
        timing: dict = {}
        self.last_timing = timing  # exposed for callers (cli_phases.json)
        try:
            self.state, outputs = run(
                self.world, self.params, self.cfg, self.state,
                callback=callback, timing=timing,
            )
        finally:
            self._stop_profile()
        seirv = np.asarray(outputs.seirv)
        self.recorder.truncate(seirv.shape[0])
        if self.verbose:
            print(f"Finished in {time.perf_counter() - t0:.2f}s")
            print(
                "  loop breakdown: "
                + ", ".join(f"{k} {v:.2f}s" for k, v in timing.items())
            )
        if output_dir is not None:
            t1 = time.perf_counter()
            self.recorder.dump_to_file(output_dir)
            if self.verbose:
                print(f"  artifact dump: {time.perf_counter() - t1:.2f}s")
        return seirv

    def _start_profile(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self) -> None:
        """Stop a running trace and write it as ``chunk_trace.json``."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir, "chunk_trace.json"))

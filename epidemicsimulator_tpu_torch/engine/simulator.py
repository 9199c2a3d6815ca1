"""User-facing Simulator: the analog of ``sim/src/simulator.rs``'s Simulator.

The port's copy of ``epidemicsimulator_tpu/engine/simulator.py``.  It
owns a :class:`World` on the run's device, the parameters and the state,
and runs the chunked fused step with host-side statistics recording,
intervention-transition lines, checkpoints and progress printing
(simulator.rs:108-127).  With ``devices=N`` it runs the
population-sharded engine over N ranks (``parallel/fastmesh.py``): this
process is rank 0 and keeps the recorder, the checkpoints and the
artifacts, and the state is held in the padded shard layout of the
partition (``parallel/partition.py``), as the JAX package holds it.

Behaviours of the JAX package's Simulator kept as they are: a
single-device run resumed from a checkpoint steps another ``max_steps``
hours (the chunk loop counts from 0 whatever the state's hour), a
sharded one steps up to hour ``max_steps`` (its loop counts from the
state's hour), and either's recorder starts empty (the checkpoint's
``__seirv__`` rows are not read back).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import Params, SimConfig, require_fast_path
from ..runtime import resolve_device
from ..stats.recorder import StatisticsRecorder, _memory_usage_string
from ..world.schema import World
from .checkpoint import load_state, save_state
from .fastpath import wants_fixed_priority_vax
from .scan import run
from .state import SimState, init_state

_MASK_NAMES = {0: "None", 1: "Only Public Transport", 2: "Everywhere"}


def _visible_cards(device) -> int:
    """``devices=0``: one rank per card this process sees."""
    if device.type != "cuda":
        raise ValueError("devices=0 means one rank per visible card; on the "
                         "CPU pass the number of ranks")
    return torch.cuda.device_count()


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
        snapshot.  ``devices``: run the population-sharded engine over
        that many ranks (0: one per visible card); None: the one-device
        fast path.  ``device``: the run's device, the card unless the
        caller passes ``"cpu"`` (then the ranks are gloo processes on the
        CPU)."""
        self.device = resolve_device(device)
        self.devices = devices
        self.params = params or Params.covid()
        self.cfg = cfg or SimConfig()
        self.seed = seed
        self.verbose = verbose
        self.recorder = StatisticsRecorder(oa_codes=oa_codes, device=self.device)
        self.profile_dir = profile_dir
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every_chunks = checkpoint_every_chunks
        self._profiler = None
        if devices is not None:
            from ..parallel.fastmesh import init_sharded_state

            require_fast_path(self.cfg, "fast sharded engine")
            from ..parallel.partition import partition_world

            n_ranks = devices if devices > 0 else _visible_cards(self.device)
            if verbose:
                print(f"population-sharded engine over {n_ranks} rank(s)")
            self.world = world  # partitioned on the host; ranks hold shards
            self.sw = partition_world(world, n_ranks)
            self.state: SimState = init_sharded_state(
                world, self.sw, seed=seed,
                starting_infected=self.cfg.starting_infected)
        else:
            self.world = world.to(self.device)
            self.state = init_state(
                self.world, seed=seed,
                starting_infected=self.cfg.starting_infected,
                fixed_priority_vax=wants_fixed_priority_vax(self.world,
                                                            self.cfg),
                device=self.device,
            )
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            self.state, _ = load_state(
                checkpoint_path,
                device="cpu" if devices is not None else self.device)
            if devices is not None and (self.state.status.shape[0]
                                        != self.sw.n_dev * self.sw.shard_size):
                raise ValueError(
                    f"{checkpoint_path} does not hold this partition's "
                    f"{self.sw.n_dev} x {self.sw.shard_size} lanes")
            if verbose:
                print(f"resumed from {checkpoint_path} at hour {self.state.hour}")

    def _run_sharded(self, callback, timing: dict):
        """The sharded chunk loop on every rank (``fastmesh.run_rank``),
        this process as rank 0 running ``callback``; the state is gathered
        for the callback on the chunks that checkpoint."""
        from ..parallel.fastmesh import rank_args, run_rank
        from ..parallel.launch import launch

        every = self.checkpoint_every_chunks if self.checkpoint_path else 0
        return launch(
            run_rank, self.sw.n_dev, device=self.device,
            args=(self.params, self.cfg, int(self.state.hour), every),
            rank_args=rank_args(self.sw, self.state),
            rank0_kwargs=dict(callback=callback, timing=timing))

    def simulate(self, output_dir: str | None = None) -> np.ndarray:
        """Run to completion; optionally dump the four JSON artifacts.

        Returns the (T, 5) SEIRV series (None on a rank other than 0 of a
        sharded run under ``torchrun``, which records nothing).
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
                           self.recorder.global_stats,
                           ws_lanes=self.devices is None)
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
            if self.devices is not None:
                result = self._run_sharded(callback, timing)
                if result is None:
                    return None  # a rank other than 0, under torchrun
                self.state, outputs = result
            else:
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

"""Multi-step runs: chunks of steps with a host check for the end of the
epidemic between chunks (the JAX package's ``engine/scan.py``).

The reference loop (simulator.rs:108-127) stops once no citizen is
exposed, infected or susceptible.  A chunk runner steps ``chunk_size``
hours eagerly and stacks the observables on the device; :func:`run`
reads each chunk's SEIRV on the host and stops after the chunk in which
the epidemic ended, keeping the step that reported it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .fastpath import make_step_tables
from .step import StepOutput, step, uses_fast_step


def make_chunk_runner(world, cfg):
    """``chunk(params, state) -> (state, StepOutput[chunk_size])`` for a
    world whose lanes are on the run's device, stepping with the step
    :func:`.step.step` picks (the fast step's tables are built here, once).
    The per-OA series is int16, saturating at 32767, as the JAX package
    ships it."""
    tables = make_step_tables(world) if uses_fast_step(world, cfg) else None

    def chunk(params, state):
        outs = []
        for _ in range(cfg.chunk_size):
            state, out = step(world, params, cfg, state, tables=tables)
            outs.append(out)
        dev = state.status.device
        stack = lambda name: torch.stack([getattr(o, name) for o in outs])
        host = lambda name, dtype: torch.tensor(
            [getattr(o, name) for o in outs], dtype=dtype, device=dev)
        return state, StepOutput(
            seirv=stack("seirv"),
            exposures_per_oa=torch.clamp(stack("exposures_per_oa"),
                                         max=32767).to(torch.int16),
            n_bus_exposures=stack("n_bus_exposures"),
            n_exposures=stack("n_exposures"),
            lockdown=host("lockdown", torch.bool),
            mask_status=host("mask_status", torch.int8),
            n_vaccinated_now=stack("n_vaccinated_now"),
        )

    return chunk


def run(world, params, cfg, state, *, callback=None, timing=None):
    """Run until the epidemic ends or ``cfg.max_steps`` steps have run.

    Returns ``(final_state, outputs)``: outputs is a StepOutput of stacked
    numpy arrays, cut after the first step at which no citizen was
    exposed, infected or susceptible.

    ``callback(steps_done, out, state)``, if given, is called after each
    chunk with the number of steps run so far in this call, that chunk's
    outputs as numpy arrays and the state after it.  ``timing``, if
    given, accumulates wall-clock seconds by category: ``dispatch`` (the
    chunk's steps), ``sync`` (its outputs' copy to the host) and
    ``callback``.

    The loop is synchronous: no chunk runs before the previous one has
    been read and handed to the callback, so the final state is the state
    after the chunk in which the epidemic ended (or the last chunk), the
    state the JAX package's ``run(..., overlap=False)`` returns.
    """
    tm = timing if timing is not None else {}
    for name in ("dispatch", "sync", "callback"):
        tm.setdefault(name, 0.0)
    chunk = make_chunk_runner(world, cfg)
    chunks = []
    steps = 0
    while steps < cfg.max_steps:
        t0 = time.perf_counter()
        state, out = chunk(params, state)
        t1 = time.perf_counter()
        out = StepOutput(*(x.cpu().numpy() for x in out))
        t2 = time.perf_counter()
        tm["dispatch"] += t1 - t0
        tm["sync"] += t2 - t1
        chunks.append(out)
        steps += out.seirv.shape[0]
        if callback is not None:
            callback(steps, out, state)
            tm["callback"] += time.perf_counter() - t2
        if out.seirv[-1, :3].sum() == 0:
            break
    outputs = StepOutput(*(
        np.concatenate(xs, axis=0)[: cfg.max_steps] for xs in zip(*chunks)
    ))
    alive = outputs.seirv[:, :3].sum(axis=1) > 0
    if not alive.all():
        end = int(np.argmin(alive)) + 1
        outputs = StepOutput(*(x[:end] for x in outputs))
    return state, outputs

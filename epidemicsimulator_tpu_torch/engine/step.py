"""One hour of the simulation: ``step`` and its per-step observables.

The port runs one formulation of the JAX package's ``engine/step.py``:
the fast step of ``engine/fastpath.py`` with the fused citizen kernel and
the scan kernels, which the JAX package selects on an accelerator.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StepOutput(NamedTuple):
    """Per-step observables (statistics.rs:208).  From :func:`step` the
    counts are 0-d device tensors and the interventions host values; from
    a chunk runner every field gains a leading step axis."""

    seirv: torch.Tensor             # (5,) int32 after exposures, pre-vaccination
    exposures_per_oa: torch.Tensor  # (n_oa,) int32, or (0,) if not recorded
    n_bus_exposures: torch.Tensor
    n_exposures: torch.Tensor
    lockdown: object                # bool, post-update
    mask_status: object             # int MASK_*, post-update
    n_vaccinated_now: torch.Tensor


def step(world, params, cfg, state, tables=None):
    """Advance one hour; returns ``(new_state, StepOutput)``.  ``tables``
    are the world's prebuilt :func:`~.fastpath.make_step_tables`."""
    from .fastpath import fast_step

    return fast_step(world, params, cfg, state, tables=tables)

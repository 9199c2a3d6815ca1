"""The float32 probability formulas of the step.

Both are written out as the JAX package writes them, in the same order of
operations.  torch's and XLA's ``exp``/``log``/``expm1``/``log1p`` are each
within a few ulp of the true value but not always equal to each other, so
a probability may differ from the JAX package's in its last bits; the
tests state that bound.
"""

from __future__ import annotations

import torch


def binomial_at_least_one(p, n):
    """1 - (1-p)^n as ``-expm1(n * log1p(-p))`` in float32 (the
    reference's ``binomial``, citizen.rs:47-49)."""
    return -torch.expm1(n.to(torch.float32) * torch.log1p(-p))


def home_probability(p, n):
    """1 - (1-p)^n as ``1 - exp(n * log(1 - p))`` in float32: the form of
    the fused citizen kernel (pallas_citizen.py:274)."""
    return 1.0 - torch.exp(n.to(torch.float32) * torch.log(1.0 - p))


def truncate_u8(n):
    """The reference's ``exposure_total as u8`` (citizen.rs:239)."""
    return n & 0xFF

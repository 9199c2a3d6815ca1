"""Exact k-th smallest hash score over the vaccination-eligible pool.

The JAX package's :func:`kth_threshold` (ops/select.py:215) samples a band
around the answer on populations of 2**22 and more and falls back to the
32-pass bisection; both return the same exact threshold, so the port
computes it by the bisection alone.
"""

from __future__ import annotations

import torch

from .hashrng import hash_bits

U32_MAX = 0xFFFFFFFF


def bisect_threshold(scores, eligible, k):
    """Smallest u32 t with |{eligible & score <= t}| >= k: 32 masked
    compare-and-count passes.  ``scores`` holds u32 values in int64; ``k``
    is an int or a 0-d tensor.  Returns a 0-d int64 tensor (0 for k <= 0,
    U32_MAX when fewer than k citizens are eligible).  No host sync."""
    device = scores.device
    lo = torch.zeros((), dtype=torch.int64, device=device)
    hi = torch.full((), U32_MAX, dtype=torch.int64, device=device)
    k = torch.as_tensor(k, dtype=torch.int64, device=device)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        cnt = (eligible & (scores <= mid)).sum()
        hit = cnt >= k
        lo = torch.where(hit, lo, mid + 1)
        hi = torch.where(hit, mid, hi)
    return lo


def kth_threshold(seed_u32, eligible, k, n_eligible=None):
    """Exact k-th smallest of ``hash_bits(seed, arange(n))`` over the
    ``eligible`` pool.  ``n_eligible`` is accepted for the JAX signature
    and not needed."""
    idx = torch.arange(eligible.shape[0], dtype=torch.int64,
                       device=eligible.device)
    return bisect_threshold(hash_bits(seed_u32, idx), eligible, k)

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


def kth_threshold(seed_u32, eligible, k, n_eligible=None):
    """Exact k-th smallest of ``hash_bits(seed, arange(n))`` over the
    ``eligible`` pool.  ``n_eligible`` is accepted for the JAX signature
    and not needed."""
    idx = torch.arange(eligible.shape[0], dtype=torch.int64,
                       device=eligible.device)
    k = torch.as_tensor(k, dtype=torch.int64, device=eligible.device)
    return bisect_threshold_rows(hash_bits(seed_u32, idx)[None],
                                 eligible[None], k.view(1))[0]


def bisect_threshold_rows(scores, eligible, k):
    """For each row of (R, M) ``scores`` (u32 values in int64) and
    ``eligible``, the smallest u32 t with |{eligible & score <= t}| >= k
    of that row (``k`` an (R,) tensor): one 32-pass masked
    compare-and-count bisection over all rows at once, with a lo and hi
    per row.  Returns an (R,) int64 tensor (0 where k <= 0, U32_MAX where
    fewer than k are eligible).  No host sync.  One world is the row
    view (1, M)."""
    rows = scores.shape[0]
    device = scores.device
    lo = torch.zeros(rows, dtype=torch.int64, device=device)
    hi = torch.full((rows,), U32_MAX, dtype=torch.int64, device=device)
    k = k.to(torch.int64)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        cnt = (eligible & (scores <= mid[:, None])).sum(1)
        hit = cnt >= k
        lo = torch.where(hit, lo, mid + 1)
        hi = torch.where(hit, mid, hi)
    return lo

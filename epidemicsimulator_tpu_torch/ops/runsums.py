"""Totals over contiguous runs and [lo, hi) ranges, as plain torch.

For a lane of nonnegative values whose groups form contiguous runs
(static boundary masks): with ``cs`` the inclusive cumsum and ``cse = cs -
v``, a run's total at element i is ``cs`` at the run's end minus ``cse`` at
its start; a masked cummax finds the start and a reverse cummin the end.
"""

from __future__ import annotations

import torch

I32_MAX = 2**31 - 1


def run_totals(values, start_mask, end_mask):
    """Per-element total of the element's run, int32."""
    v = values.to(torch.int32)
    return run_totals_from_cumsum(torch.cumsum(v, 0, dtype=torch.int32), v,
                                  start_mask, end_mask)


def run_totals_from_cumsum(cs, v, start_mask, end_mask):
    cse = cs - v
    start_prefix = torch.cummax(
        torch.where(start_mask, cse, torch.full_like(cse, -1)), 0
    ).values
    end_prefix = torch.flip(torch.cummin(torch.flip(
        torch.where(end_mask, cs, torch.full_like(cs, I32_MAX)), (0,)
    ), 0).values, (0,))
    return end_prefix - start_prefix


def range_totals(values, lo, hi):
    """Totals of the ranges [lo, hi): one cumsum and two small gathers."""
    cs = torch.cumsum(values.to(torch.int32), 0, dtype=torch.int32)
    cs0 = torch.cat([cs.new_zeros(1), cs])
    return cs0[hi.long()] - cs0[lo.long()]


def permute_by_sort(static_rank, payload, bits=8):
    """Position r receives the payload of the element of rank r, masked to
    its low ``bits`` bits, as int8: ``out[static_rank[i]] = payload[i]``.
    The JAX package sorts packed keys for this; the values are those of
    one scatter by the static rank.  ``static_rank`` is a permutation."""
    out = torch.empty_like(payload, dtype=torch.int8)
    out[static_rank.long()] = (payload.to(torch.int32) & ((1 << bits) - 1)).to(
        torch.int8)
    return out

"""Positions of the set bits of a mask, K at a time, and scatters of a few
bits: the plain torch counterparts of ``epidemicsimulator_tpu/ops/sparse.py``.

The JAX package finds the (offset+j+1)-th set bit with a two-level block
search because its device has no fast compaction; here ``torch.nonzero``
does it, and the hierarchy is kept only as the shared per-lane summary
(block tiles, their counts, the total) so callers keep the same
interface.  Results equal the JAX functions' for every block size.
"""

from __future__ import annotations

import torch


def block_hierarchy(mask, *, block: int = 1024):
    """(tiles (nb, block) int8, per-block counts (nb,) int32, total)."""
    n = mask.shape[0]
    nb = -(-n // block)
    m = torch.zeros(nb * block, dtype=torch.int8, device=mask.device)
    m[:n] = mask.to(torch.int8)
    m2 = m.view(nb, block)
    bs = m2.sum(1, dtype=torch.int32)
    return m2, bs, bs.sum(dtype=torch.int32)


def compact_from_hierarchy(h, k_slots: int, offset=0, *, n: int, sb=256):
    """``(pos, live, total)``: ``pos[j]`` is the index of the
    (offset+j+1)-th set bit, or ``n`` where ``live[j]`` is false (there
    are fewer set bits).  ``sb`` only shapes the JAX package's search."""
    m2, _, total = h
    k_slots = min(k_slots, n)
    device = m2.device
    set_pos = torch.nonzero(m2.reshape(-1)[:n]).flatten()
    set_pos = torch.cat([set_pos, torch.full((1,), n, device=device)])
    tgt = torch.as_tensor(offset, dtype=torch.int64, device=device) + \
        torch.arange(1, k_slots + 1, dtype=torch.int64, device=device)
    live = tgt <= total
    pos = set_pos[torch.clamp(tgt - 1, max=set_pos.shape[0] - 1)]
    pos = torch.where(live, pos, torch.full_like(pos, n))
    return pos.to(torch.int32), live, total


def compact_positions(mask, k_slots: int, *, block: int = 1024, offset=0):
    """Positions of the first ``k_slots`` set bits after ``offset``."""
    return compact_from_hierarchy(
        block_hierarchy(mask, block=block), k_slots, offset, n=mask.shape[0]
    )


def scatter_bits(n_out: int, dest_idx, live):
    """(n_out,) bool lane with ``dest_idx[live]`` set; indices outside
    [0, n_out) are dropped.  No host sync: the dropped ones are sent to a
    spare slot past the end."""
    idx = dest_idx.long()
    idx = torch.where(live & (idx >= 0) & (idx < n_out), idx, n_out)
    lane = torch.zeros(n_out + 1, dtype=torch.bool, device=idx.device)
    lane[idx] = True
    return lane[:n_out]

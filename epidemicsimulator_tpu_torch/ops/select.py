"""Exact k-th smallest hash score over the vaccination-eligible pool.

The JAX package's :func:`kth_threshold` (ops/select.py:215) samples a band
around the answer on populations of 2**22 and more and falls back to the
32-pass bisection; both return the same exact threshold, so the port
computes it by the bisection alone on one card.

Over ranks (the population-sharded engine, parallel/fastmesh.py) the
threshold is global: :func:`bisect_threshold_rows` with ``reduce`` the
group's ``psum`` sums each pass's count over the ranks (32 rounds of one
all_reduce), and
:func:`kth_threshold_sharded` bounds the answer by a gathered sample and
reads it off the gathered in-band scores in 3 collective rounds, with the
bisection as its exact fallback.  Both return the same threshold.
"""

from __future__ import annotations

import torch

from .hashrng import hash_bits

U32_MAX = 0xFFFFFFFF

#: shards smaller than this run the bisection (``select.py:38``): the
#: sampled band needs a meaningful stride to pay off
MIN_SAMPLED_N = 1 << 22


def kth_threshold(seed_u32, eligible, k, n_eligible=None):
    """Exact k-th smallest of ``hash_bits(seed, arange(n))`` over the
    ``eligible`` pool.  ``n_eligible`` is accepted for the JAX signature
    and not needed."""
    idx = torch.arange(eligible.shape[0], dtype=torch.int64,
                       device=eligible.device)
    k = torch.as_tensor(k, dtype=torch.int64, device=eligible.device)
    return bisect_threshold_rows(hash_bits(seed_u32, idx)[None],
                                 eligible[None], k.view(1))[0]


def bisect_threshold_rows(scores, eligible, k, reduce=None):
    """For each row of (R, M) ``scores`` (u32 values in int64) and
    ``eligible``, the smallest u32 t with |{eligible & score <= t}| >= k
    of that row (``k`` an (R,) tensor): one 32-pass masked
    compare-and-count bisection over all rows at once, with a lo and hi
    per row.  Returns an (R,) int64 tensor (0 where k <= 0, U32_MAX where
    fewer than k are eligible).  No host sync.  One world is the row
    view (1, M).  ``reduce``: applied to each pass's (R,) counts, e.g. a
    rank group's ``psum``, so that every rank of a sharded row resolves
    the same global threshold (``k`` then the global k)."""
    rows = scores.shape[0]
    device = scores.device
    lo = torch.zeros(rows, dtype=torch.int64, device=device)
    hi = torch.full((rows,), U32_MAX, dtype=torch.int64, device=device)
    k = k.to(torch.int64)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        cnt = (eligible & (scores <= mid[:, None])).sum(1)
        if reduce is not None:
            cnt = reduce(cnt)
        hit = cnt >= k
        lo = torch.where(hit, lo, mid + 1)
        hi = torch.where(hit, mid, hi)
    return lo


def kth_threshold_sharded(scores, eligible, k, n_eligible, group, *,
                          force_sampled=None, sample_log2: int = 17,
                          band_slots: int = 4096):
    """The exact global k-th smallest eligible score over the ranks of
    ``group``: ``kth_threshold_sharded`` of the JAX package's
    ``ops/select.py:119``.  Each rank gathers every rank's strided sample
    of its scores (one all_gather), bounds the k-th score between two
    order statistics of the sorted sample, counts its scores below the
    band and compacts those in it, sums (count below, band count,
    overflow) over the ranks (one all_reduce) and gathers the bands (one
    all_gather); the answer is read off the sorted bands.  Where the band
    misses (overflow, or k outside it) every rank falls back to the
    bisection with its counts summed over the ranks: the decision is a replicated value read
    on the host (``group.host_flag``).  Auto (``force_sampled`` None):
    sampled for shards of at least MIN_SAMPLED_N with a stride of 4 or
    more.  ``k`` and ``n_eligible`` are 0-d tensors, the same on every
    rank."""
    from .sparse import compact_positions

    n = scores.shape[0]

    def bisect():
        return bisect_threshold_rows(scores[None], eligible[None], k.view(1),
                                     reduce=group.psum)[0]

    m_loc = 1 << sample_log2
    stride = n // m_loc
    sampled = ((stride >= 4 and n >= MIN_SAMPLED_N) if force_sampled is None
               else force_sampled)
    if not sampled or stride < 1:
        return bisect()
    device = scores.device
    f32, i32 = torch.float32, torch.int32
    end = m_loc * stride
    masked = torch.where(eligible[:end:stride], scores[:end:stride], U32_MAX)
    allsamp = group.all_gather(masked).reshape(-1)
    ssorted = torch.sort(allsamp).values
    m_elig = (allsamp != U32_MAX).sum(dtype=i32)
    m = ssorted.shape[0]
    n_el = torch.clamp(n_eligible.to(i32), min=1)
    k = k.to(i32)
    r = torch.floor(k.to(f32) * (m_elig.to(f32) / n_el.to(f32))).to(i32)
    marg = (8.0 * torch.sqrt(torch.clamp(r.to(f32), min=1.0)) + 32.0).to(i32)
    lo_i = torch.clamp(r - marg, 0, m - 1).long()
    hi_i = torch.clamp(r + marg, 0, m - 1).long()
    a = torch.where(lo_i > 0, ssorted[lo_i], 0)
    b = ssorted[hi_i]
    below_a = eligible & (scores < a)
    in_band = eligible & (scores >= a) & (scores <= b)
    pos, live, cnt = compact_positions(in_band, band_slots)
    band = torch.where(live, scores[torch.clamp(pos.long(), max=n - 1)],
                       U32_MAX)
    c_below, band_cnt, overflow = group.psum(torch.stack([
        below_a.sum(dtype=i32), torch.clamp(cnt, max=band_slots),
        (cnt > band_slots).to(i32)]))
    band_sorted = torch.sort(group.all_gather(band).reshape(-1)).values
    j = k - c_below  # the 1-based global rank inside the band
    tau = band_sorted[torch.clamp(j - 1, 0, band_sorted.shape[0] - 1).long()]
    ok = (overflow == 0) & (j >= 1) & (j <= band_cnt)
    if group.host_flag(~ok):
        return bisect()
    return tau

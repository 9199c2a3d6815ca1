"""Counter-based hash streams: murmur3 fmix32 over a golden-ratio counter.

A copy of ``epidemicsimulator_tpu/ops/hashrng.py``.  The u32 arithmetic
runs on int64 tensors masked to 32 bits, so the bits are the JAX
package's on every device.  ``seed`` is a Python int (or an int64 tensor)
holding a u32; ``idx`` is an int64 tensor of u32 counters.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(x, c: int):
    """(x * c) mod 2**32 for x < 2**32 held in int64, without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def hash_bits(seed, idx):
    """u32 stream fmix32(idx * golden + seed), as int64 values."""
    x = (mul32(idx, 0x9E3779B9) + seed) & M32
    x = mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_uniform(seed, idx):
    """float32 uniforms in [0, 1): the top 24 hash bits times 2**-24."""
    return (hash_bits(seed, idx) >> 8).to(torch.float32) * (1.0 / (1 << 24))

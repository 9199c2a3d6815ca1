"""Threefry-2x32 streams, bit-identical to ``jax.random`` (jax 0.9.0,
``jax_threefry_partitionable=True``, the default threefry2x32 impl).

The per-step seeds and the bus shuffle and bus draw of the simulator are
threefry streams, so the port computes them itself instead of using
``torch.Generator``.  Every function works on Python ints (the scalar key
chain, evaluated on the host) and on int64 tensors holding u32 values
(the per-rider streams, evaluated on the device).  Keys are (k0, k1)
pairs of Python ints.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0, x1):
    """The 20-round threefry2x32 block function on (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` for a seed that fits int32."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError("seed must fit int32")
    return (0, seed & M32)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    return threefry2x32(k[0], k[1], 0, data & M32)


def split(k: tuple[int, int], num: int) -> list[tuple[int, int]]:
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def bits(k: tuple[int, int], n: int | None = None, device=None):
    """``jax.random.bits(k, shape, uint32)``: an int for ``n=None`` (shape
    ()), else an int64 tensor of shape (n,) holding u32 values."""
    if n is None:
        b0, b1 = threefry2x32(k[0], k[1], 0, 0)
    else:
        counts = torch.arange(n, dtype=torch.int64, device=device)
        b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(counts), counts)
    return b0 ^ b1


def uniform(k: tuple[int, int], n: int, device=None):
    """``jax.random.uniform(k, (n,))`` in float32: 23 random mantissa bits,
    so every value is an exact multiple of 2**-23 in [0, 1)."""
    return (bits(k, n, device) >> 9).to(torch.float32) * (1.0 / (1 << 23))

"""Kernel B5: replay of a static permutation through a Beneš network,
with its host router and its plain torch version.

Replaces ``attic/benes.py`` (``_benes_permute``, its router
``route_permutation`` and ``benes_distances``) with the same contract, so
one routed table drives both packages: ``n`` elements are padded to
``2**k`` with ``k = max(10, ceil(log2 n))`` and an identity tail, and the
control table is ``((2k-1+7)//8, 2**k)`` uint8 with stage j's bit in bit
``j % 8`` of row ``j // 8``.  The router is host C++
(``csrc/benes_route.cpp``), the replay CUDA kernels (``csrc/benes.cu``:
a few passes, each running every stage that one tile layout holds).
Off the fused step: ``tools/probe_torch_benes.py`` replays the world's
work-order permutation with it beside the gather the step uses.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import runtime


def benes_distances(k: int) -> tuple[int, ...]:
    """XOR distances of the 2k-1 stages, outermost first."""
    return tuple([1 << (k - 1 - j) for j in range(k)]
                 + [1 << (j + 1) for j in range(k - 1)])


def route_permutation(src) -> tuple[torch.Tensor, int]:
    """Route the gather permutation ``src`` (``out[o] = in[src[o]]``, a
    bijection on [0, n)) through the network.  Returns ``(ctrl, k)``:
    the packed control table as a uint8 CPU tensor, and k.  Raises
    ValueError if ``src`` is not a bijection."""
    src = np.asarray(src.cpu() if isinstance(src, torch.Tensor) else src)
    n = int(src.shape[0])
    k = max(10, max(n - 1, 1).bit_length())
    n2 = 1 << k
    if src.ndim != 1 or (n and (src.min() < 0 or src.max() >= n)):
        raise ValueError("not a bijection")
    full = np.arange(n2, dtype=np.int32)
    full[:n] = src
    ctrl = np.zeros(((2 * k - 1 + 7) // 8, n2), np.uint8)
    rc = runtime.host_library().es_benes_route(
        full.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), k,
        ctrl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError("not a bijection")
    return torch.from_numpy(ctrl), k


def _check(payload, ctrl, k, n_out):
    if payload.dtype == torch.bool:
        payload = payload.view(torch.int8)
    if payload.dtype != torch.int8 or payload.dim() != 1:
        raise ValueError("benes_permute takes an (N,) int8 or bool payload")
    n2 = 1 << k
    if ctrl.dtype != torch.uint8 or ctrl.shape != ((2 * k - 1 + 7) // 8, n2):
        raise ValueError("benes_permute: ctrl must be ((2k-1+7)//8, 2**k) uint8")
    if ctrl.device != payload.device:
        raise ValueError("benes_permute: ctrl must be on the payload's device")
    n_out = payload.shape[0] if n_out is None else int(n_out)
    if payload.shape[0] > n2 or not 0 <= n_out <= n2:
        raise ValueError("benes_permute: payload and n_out must fit 2**k")
    return payload, n_out


def _padded(payload, n2):
    x = torch.zeros(n2, dtype=torch.int8, device=payload.device)
    x[:payload.shape[0]] = payload
    return x


def benes_permute_plain(payload, ctrl, k, *, reverse=False, n_out=None):
    payload, n_out = _check(payload, ctrl, k, n_out)
    x = _padded(payload, 1 << k)
    ds = benes_distances(k)
    for j in (reversed(range(len(ds))) if reverse else range(len(ds))):
        d = ds[j]
        take = ((ctrl[j // 8] >> (j % 8)) & 1).bool()
        partner = x.view(-1, 2, d).flip(1).reshape(-1)  # x[i ^ d]
        x = torch.where(take, partner, x)
    return x[:n_out]


def benes_permute(payload, ctrl, k, *, reverse=False, n_out=None):
    """Apply the routed permutation to an (N,) int8 ``payload`` (N <=
    2**k): ``out[o] = payload[src[o]]`` for the ``src`` given to
    :func:`route_permutation`, or ``payload[inverse(src)[o]]`` with
    ``reverse=True``.  Returns the first ``n_out`` (default N) elements.
    ``ctrl`` must be on the payload's device."""
    if payload.device.type == "cpu":
        return benes_permute_plain(payload, ctrl, k, reverse=reverse,
                                   n_out=n_out)
    payload, n_out = _check(payload.contiguous(), ctrl, k, n_out)
    out = torch.empty(1 << k, dtype=torch.int8, device=payload.device)
    # the kernel reads the payload as 0 past its end: no padded copy
    err = runtime.library().es_benes_permute(
        payload.data_ptr(), payload.shape[0], out.data_ptr(),
        ctrl.contiguous().data_ptr(), k, int(bool(reverse)),
        runtime.stream_handle())
    runtime.check(err, "benes_permute")
    runtime.launches["benes_permute"] += 1
    return out[:n_out]

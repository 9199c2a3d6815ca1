"""Kernel B5 of the port (``ops/benes.py``) against the JAX package's
Beneš replay, on the CPU.

The JAX replay lives in ``attic/benes.py``, which is not part of the
package: it is loaded here by file path and run in interpret mode.  Its
router's C++ is kept only as ``attic/benes_route.cc.txt``; the tests
compile a copy of it into a temporary directory (the file itself is only
read) and hold the port's router against it byte for byte.  On the CPU
``benes_permute`` runs its plain replay; test_torch_gpu.py holds the
CUDA kernel against that replay on a card.
"""

import ctypes
import importlib.util
import subprocess
from pathlib import Path

import jax  # noqa: F401  (the attic module needs JAX set up for the CPU)
import numpy as np
import pytest
import torch

import epidemicsimulator_tpu_torch as et
from epidemicsimulator_tpu_torch.ops import benes

ROOT = Path(__file__).resolve().parent.parent
ATTIC = ROOT / "attic"


@pytest.fixture(scope="module")
def attic_benes():
    spec = importlib.util.spec_from_file_location(
        "attic_benes", ATTIC / "benes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def attic_route(tmp_path_factory):
    """The attic's router, compiled from a copy of its source."""
    tmp = tmp_path_factory.mktemp("attic_route")
    src = tmp / "benes_route.cc"
    src.write_text("#include <cstdint>\n#include <vector>\n"
                   + (ATTIC / "benes_route.cc.txt").read_text())
    lib_path = tmp / "libattic_route.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.esucd_benes_route
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                   ctypes.POINTER(ctypes.c_uint8)]

    def route(src):
        """(ctrl, k) as attic/benes.py's route_permutation computes it."""
        n = src.shape[0]
        k = max(10, int(np.ceil(np.log2(max(n, 2)))))
        full = np.arange(1 << k, dtype=np.int32)
        full[:n] = src
        ctrl = np.zeros(((2 * k - 1 + 7) // 8, 1 << k), np.uint8)
        rc = fn(full.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), k,
                ctrl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        assert rc == 0
        return ctrl, k

    return route


def _inverse(src):
    inv = np.empty_like(src)
    inv[src] = np.arange(src.shape[0], dtype=src.dtype)
    return inv


def test_distances_match_attic(attic_benes):
    assert benes.benes_distances(3) == (4, 2, 1, 2, 4)
    assert len(benes.benes_distances(22)) == 43
    for k in range(1, 27):
        assert benes.benes_distances(k) == attic_benes.benes_distances(k)


@pytest.mark.parametrize("n", [1, 2, 5, 1000, 1024, 1025, 20_000, 100_003])
def test_router_matches_attic_cpp(attic_route, n):
    src = np.random.default_rng(n).permutation(n).astype(np.int32)
    want, k_want = attic_route(src)
    got, k = benes.route_permutation(src)
    assert k == k_want
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_router_matches_attic_cpp_on_world(attic_route):
    """The port's own world: its work-order permutation and inverse."""
    w = et.generate_synthetic_world(3000, n_output_areas=6, seed=4)
    for src in (np.asarray(w.work_perm), np.asarray(w.wpos)):
        got, k = benes.route_permutation(torch.from_numpy(src))
        want, k_want = attic_route(src.astype(np.int32))
        assert k == k_want
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [2, 1000, 20_000])
def test_replay_matches_attic(attic_benes, n):
    """Forward and reverse, bitwise, on one routed table; both equal the
    gathers by src and by its inverse."""
    rng = np.random.default_rng(n + 1)
    src = rng.permutation(n).astype(np.int32)
    payload = rng.integers(-128, 128, n).astype(np.int8)
    ctrl, k = benes.route_permutation(src)
    for reverse, idx in ((False, src), (True, _inverse(src))):
        want = np.asarray(attic_benes.benes_permute(
            payload, ctrl.numpy(), k, reverse=reverse, interpret=True))
        got = benes.benes_permute(torch.from_numpy(payload), ctrl, k,
                                  reverse=reverse)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, payload[idx])


def test_random_ctrl_matches_attic(attic_benes):
    """Control bytes that no router made (pair members disagree): every
    element reads its own bit, every stage reads pre-stage values."""
    k = 10
    rng = np.random.default_rng(77)
    ctrl = rng.integers(0, 256, ((2 * k - 1 + 7) // 8, 1 << k)).astype(np.uint8)
    payload = rng.integers(-128, 128, 1000).astype(np.int8)
    for reverse in (False, True):
        for n_out in (1000, 1 << k, 17):
            want = np.asarray(attic_benes.benes_permute(
                payload, ctrl, k, reverse=reverse, n_out=n_out,
                interpret=True))
            got = benes.benes_permute(torch.from_numpy(payload),
                                      torch.from_numpy(ctrl), k,
                                      reverse=reverse, n_out=n_out)
            np.testing.assert_array_equal(got.numpy(), want)


def test_world_orders_by_replay():
    """The step's work-order move as a replay: forward by work_perm is
    the gather x[work_perm], reverse is x[wpos]; a bool lane too."""
    w = et.generate_synthetic_world(3000, n_output_areas=6, seed=4).to("cpu")
    ctrl, k = benes.route_permutation(w.work_perm)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 32, w.n_citizens).astype(np.int8))
    assert torch.equal(benes.benes_permute(x, ctrl, k), x[w.work_perm.long()])
    assert torch.equal(benes.benes_permute(x, ctrl, k, reverse=True),
                       x[w.wpos.long()])
    b = x > 15
    assert torch.equal(benes.benes_permute(b, ctrl, k),
                       b[w.work_perm.long()].view(torch.int8))


@pytest.mark.parametrize("src", [
    [0, 0, 1], [0, 1, 3], [-1, 0, 1], [1, 2, 1024],
])
def test_router_refuses_non_bijection(src):
    with pytest.raises(ValueError):
        benes.route_permutation(np.asarray(src, np.int32))


def test_replay_refuses_bad_tables():
    ctrl, k = benes.route_permutation(np.arange(10, dtype=np.int32))
    x = torch.zeros(10, dtype=torch.int8)
    with pytest.raises(ValueError):
        benes.benes_permute(x, ctrl[:-1], k)
    with pytest.raises(ValueError):
        benes.benes_permute(x, ctrl.to(torch.int8), k)
    with pytest.raises(ValueError):
        benes.benes_permute(x.int(), ctrl, k)
    with pytest.raises(ValueError):
        benes.benes_permute(x, ctrl, k, n_out=(1 << k) + 1)
    with pytest.raises(ValueError):
        benes.benes_permute_plain(x, ctrl.to("meta"), k)

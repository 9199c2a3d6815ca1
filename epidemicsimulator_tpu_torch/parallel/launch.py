"""Run a function on a group of ranks: the port's counterpart of building
the JAX package's ``Mesh`` and entering ``shard_map``.

:func:`launch` runs ``fn(group, *args, *rank_args[r])`` on ranks 0 ..
size-1 and returns rank 0's result.  The calling process is rank 0 (and
also gets ``rank0_kwargs``, which need not be picklable, such as a
callback); ranks 1 .. size-1 are processes started with
``torch.multiprocessing`` in its ``forkserver`` context, which import
``fn`` by name, so ``fn`` is a module-level function of the package.
The fork server is a fresh process that imports torch and ``fn``'s
module once and never touches CUDA; each rank is forked from it, so a
launch after a process's first starts its ranks in well under a second
instead of each importing torch anew (about 2.6 s on 8 CPU cores), and a
rank can take a card as a spawned process would.  Under
``torchrun`` (the environment names ``RANK`` and ``WORLD_SIZE``) nothing is
started: this process runs its own rank.

* The ranks meet through a ``file://`` store in a temporary directory.
  The process group has a timeout, so a rank left waiting on a
  collective fails the run instead of hanging it.
* The placement (:func:`.comm.placement`) is decided before anything
  starts and printed as one JSON line, ``{"launch": {"comm": ...,
  "ranks": ..., "devices": [...]}}``.
* On a card the kernels are built once, here, before any rank starts:
  ranks never race to build into one directory.
* Each started rank runs torch on one CPU thread.
* ``args`` and each rank's ``rank_args`` reach the started ranks through
  pickles in the temporary directory (a rank reads only its own shard),
  not through the pipe that starts each one: a payload larger than the
  pipe's buffer would hold the launcher until that rank had imported
  the launching script, one rank after the other.
* Each rank counts its own kernel launches (``runtime.launches``); when
  ``fn`` returns, rank 0 adds the other ranks' launches of the run to
  its own counts, so the caller reads the whole run's launches there.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist

from .comm import LOCAL, Placement, RankGroup, placement

#: seconds a rank waits on a collective (or on the others to start)
#: before the run fails
DEFAULT_TIMEOUT_S = 180


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _join(rank, size, place: Placement, init_method, timeout_s):
    dev = place.devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        place.backend, init_method=init_method, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return RankGroup(rank, size, place)


def _merge_launches(group, before):
    """Add every other rank's launches since ``before`` to rank 0's
    counts (a collective)."""
    from .. import runtime

    names = sorted(runtime.launches)
    delta = torch.tensor([runtime.launches[k] - before[k] for k in names],
                         dtype=torch.int64, device=group.device)
    every = group.all_gather(delta).cpu()
    if group.rank == 0:
        for k, n in zip(names, every[1:].sum(0).tolist()):
            runtime.launches[k] += n


def _run(fn, group, args, rank_args, kwargs):
    from .. import runtime

    before = dict(runtime.launches)
    try:
        result = fn(group, *args, *rank_args, **kwargs)
        if group.size > 1:
            _merge_launches(group, before)
        return result
    finally:
        if group.size > 1:
            dist.destroy_process_group()


def _child(i, fn, size, place, tmp, timeout_s):
    rank = i + 1
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
        rank_args = pickle.load(f)
    group = _join(rank, size, place, "file://" + os.path.join(tmp, "store"),
                  timeout_s)
    _run(fn, group, args, rank_args, {})


def launch(fn, size: int, *, device="cuda", args=(), rank_args=None,
           rank0_kwargs=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``fn`` on ``size`` ranks placed on ``device`` ("cpu" or
    "cuda"); returns rank 0's result (under ``torchrun``, this rank's).
    ``rank_args`` is a list of one argument tuple per rank."""
    rank_args = list(rank_args) if rank_args is not None else [()] * size
    if len(rank_args) != size:
        raise ValueError(f"rank_args has {len(rank_args)} entries for "
                         f"{size} ranks")
    rank0_kwargs = rank0_kwargs or {}
    place = placement(size, device)
    if _under_torchrun():
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != size:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} "
                             f"ranks for a run of {size}")
        if rank == 0:
            print(json.dumps({"launch": place.describe(size)}), flush=True)
        group = (_join(rank, size, place, "env://", timeout_s) if size > 1
                 else RankGroup(0, 1, place))
        return _run(fn, group, args, rank_args[rank],
                    rank0_kwargs if rank == 0 else {})
    print(json.dumps({"launch": place.describe(size)}), flush=True)
    if place.comm == LOCAL:
        return fn(RankGroup(0, 1, place), *args, *rank_args[0], **rank0_kwargs)
    if dist.is_initialized():
        raise RuntimeError("launch: this process already belongs to a "
                           "process group")
    if place.devices[0].type == "cuda":
        from .. import runtime

        runtime.library()  # the one build, before any rank starts
    tmp = tempfile.mkdtemp(prefix="esim_ranks_")
    try:
        for name, obj in [("args", tuple(args))] + [
                (f"rank{r}", tuple(rank_args[r])) for r in range(1, size)]:
            with open(os.path.join(tmp, f"{name}.pkl"), "wb") as f:
                pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        multiprocessing.set_forkserver_preload(["torch", fn.__module__])
        ctx = torch.multiprocessing.start_processes(
            _child, args=(fn, size, place, tmp, timeout_s),
            nprocs=size - 1, join=False, start_method="forkserver")
        try:
            group = _join(0, size, place,
                          "file://" + os.path.join(tmp, "store"), timeout_s)
            result = _run(fn, group, args, rank_args[0], rank0_kwargs)
        except BaseException as exc:
            try:
                # a started rank's own error, where one failed first
                ctx.join(timeout=15)
            except Exception as other:
                exc.add_note(f"a started rank failed too: {other}")
            finally:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.terminate()
            raise
        while not ctx.join():
            pass
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

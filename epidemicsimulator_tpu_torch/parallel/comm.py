"""A group of ranks and its collectives: the port's counterpart of the JAX
package's one-axis ``Mesh`` (``parallel/mesh.py::make_mesh``, ``AXIS``).

Each rank is a process; ``shard_map``'s collectives become
``torch.distributed`` calls on the group:

* ``psum`` -> :meth:`RankGroup.psum` (``all_reduce`` SUM, exact in the
  integer dtypes the sharded step sums in);
* ``all_gather`` -> :meth:`RankGroup.all_gather`;
* ``all_to_all`` -> :meth:`RankGroup.all_to_all` (``all_to_all_single``,
  dimension 0 split into ``size`` equal parts);
* ``axis_index`` -> :attr:`RankGroup.rank`.

Where the JAX step branches with ``lax.cond`` on a psum'd predicate, a
rank reads the replicated value on the host (:meth:`RankGroup.host_flag`),
so every rank takes the same branch and enters the same collectives in
the same order.

The backend follows from the placement (:func:`placement`) and never
changes because a call fails:

* ranks on the CPU: gloo;
* each rank on a card of its own: NCCL, rank r on ``cuda:r``;
* ranks sharing a card: gloo, each operand copied to host memory for the
  call and the result copied back (``"gloo-host-staged"``).  This is the
  one place that staging happens.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

#: the backends' names as the run's output prints them
GLOO, NCCL, STAGED, LOCAL = "gloo", "nccl", "gloo-host-staged", "local"


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where each rank runs and how the ranks talk."""

    comm: str             # GLOO, NCCL, STAGED or LOCAL (one rank)
    devices: tuple        # torch.device of each rank

    @property
    def backend(self) -> str:
        return NCCL if self.comm == NCCL else GLOO

    def describe(self, size: int) -> dict:
        return {"comm": self.comm, "ranks": size,
                "devices": [str(d) for d in self.devices]}


def placement(size: int, device="cuda") -> Placement:
    """The placement of ``size`` ranks on ``device`` ("cpu" or "cuda"):
    decided before anything runs, from the device and the cards this
    process sees."""
    dev = torch.device(device)
    if size < 1:
        raise ValueError(f"a group needs at least one rank, got {size}")
    if dev.type == "cpu":
        return Placement(LOCAL if size == 1 else GLOO,
                         (torch.device("cpu"),) * size)
    if dev.type != "cuda":
        raise ValueError(f"ranks run on 'cpu' or 'cuda', not {device!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError(
            "a CUDA device was asked for and none is available; "
            "pass device='cpu' to run the ranks on the CPU")
    if size == 1:
        first = dev if dev.index is not None else torch.device("cuda", 0)
        return Placement(LOCAL, (first,))
    if cards >= size:
        return Placement(NCCL, tuple(torch.device("cuda", r)
                                     for r in range(size)))
    return Placement(STAGED, tuple(torch.device("cuda", r % cards)
                                   for r in range(size)))


class RankGroup:
    """This process's rank in a group of ``size`` ranks.  One rank alone
    (``comm == LOCAL``) needs no process group: every collective is then
    the identity."""

    def __init__(self, rank: int, size: int, place: Placement):
        self.rank = rank
        self.size = size
        self.place = place
        self.device = place.devices[rank]
        self._staged = place.comm == STAGED

    @property
    def comm(self) -> str:
        return self.place.comm

    def _to_comm(self, t):
        return t.cpu() if self._staged else t.contiguous().clone()

    def _back(self, t):
        return t.to(self.device) if self._staged else t

    def psum(self, t):
        """The sum of ``t`` over the ranks (an integer tensor)."""
        if self.size == 1:
            return t
        buf = self._to_comm(t)
        dist.all_reduce(buf)
        return self._back(buf)

    def all_gather(self, t):
        """Every rank's ``t``, stacked: shape (size, *t.shape)."""
        if self.size == 1:
            return t[None]
        buf = self._to_comm(t)
        if self.place.comm == NCCL:
            out = torch.empty((self.size, *buf.shape), dtype=buf.dtype,
                              device=buf.device)
            dist.all_gather_into_tensor(out, buf)
        else:
            parts = [torch.empty_like(buf) for _ in range(self.size)]
            dist.all_gather(parts, buf)
            out = torch.stack(parts)
        return self._back(out)

    def all_to_all(self, t):
        """Part r of ``t``'s dimension 0 (split into ``size`` equal parts)
        goes to rank r; part r of the result came from rank r."""
        if self.size == 1:
            return t
        if t.shape[0] % self.size:
            raise ValueError("all_to_all: dimension 0 must split into "
                             f"{self.size} equal parts")
        buf = self._to_comm(t)
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf)
        return self._back(out)

    def host_flag(self, pred) -> bool:
        """Whether ``pred`` (a bool or 0-d tensor) holds on any rank, read
        on the host once: every rank gets the same answer."""
        flag = torch.as_tensor(pred, device=self.device).to(torch.int32)
        return bool(self.psum(flag.reshape(1)).item() > 0)

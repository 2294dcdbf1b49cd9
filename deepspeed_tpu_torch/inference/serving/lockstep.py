"""One decider a serving mesh.

The port serves a mesh beyond 1 x 1 with one process per rank, and every
rank runs its own scheduler over the same submissions.  That stays
correct only while each host-side decision is a pure function of what
every rank shares.  A decision that reads a clock, a thread or an I/O
outcome is not: a deadline that falls between two ranks' sweeps, the
front end's TTFT-at-risk boost, the fleet's backoff timers and health
checks, a threaded replica's inbox drain and the placements beside it
would part the ranks, and the next dispatch's collectives would
mismatch or hang.

:class:`Lockstep` keeps the ranks together.  At each iteration boundary
the mesh's rank 0 takes every such decision (:meth:`Lockstep.decide`:
the proposal runs there alone) and broadcasts it as one small object
over the mesh's own process group; every rank then applies the same
decisions in the same order.  An I/O outcome that each rank meets for
itself (a host-tier spill, promote, publish or claim of its own kv-head
slice) is agreed instead (:meth:`Lockstep.agree`): the MIN over the mesh
of every rank's outcome, so a block counts as spilled, or as landed,
only where every rank's slice did, and the allocators' registrations
stay identical.  At mesh 1 x 1 nothing crosses: ``decide`` returns None
and ``agree`` the outcome as given, and every caller keeps its
one-process path.

A request is named in an engine's decision by its index in the
scheduler's :meth:`~.scheduler.ContinuousBatchingScheduler.live` list at
the iteration boundary, which every rank holds in the same order; a
fleet request by its fleet request id.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ... import comm
from ...parallel.topology import AXIS_ORDER


class Lockstep:
    """The decider of one engine (or one fleet router) on ``mesh``: a
    :class:`~...parallel.topology.ProcessMesh` beyond one rank gets its
    own process groups (``ProcessMesh.private``), so that two engines
    over the same ranks never share a group; None or a one-rank mesh
    makes every call local."""

    def __init__(self, mesh=None):
        self.mesh = (mesh.private() if mesh is not None
                     and mesh.world_size > 1 else None)
        #: objects broadcast by ``decide`` and outcomes agreed by
        #: ``agree`` (each one collective over the mesh)
        self.broadcasts = 0
        self.agreements = 0

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def is_root(self) -> bool:
        """True on the rank that takes the decisions (every rank of a
        one-rank mesh)."""
        return self.mesh is None or self.mesh.axis_index(AXIS_ORDER) == 0

    def decide(self, propose: Callable[[], Any]) -> Optional[Any]:
        """``propose()`` on rank 0, its picklable result on every rank;
        None (and ``propose`` not called) at mesh 1 x 1."""
        if self.mesh is None:
            return None
        with comm.use_mesh(self.mesh):
            obj = comm.broadcast_object(
                propose() if self.is_root else None, 0, AXIS_ORDER)
        self.broadcasts += 1
        return obj

    def agree(self, outcome: int) -> int:
        """The least of every rank's ``outcome`` (an int; a success flag
        is 1 for success), on every rank; ``outcome`` itself at mesh
        1 x 1."""
        if self.mesh is None:
            return int(outcome)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if comm.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.tensor([int(outcome)], dtype=torch.int64, device=dev)
        with comm.use_mesh(self.mesh):
            comm.all_reduce(t, comm.ReduceOp.MIN, AXIS_ORDER)
        self.agreements += 1
        return int(t.item())

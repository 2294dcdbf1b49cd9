"""Collective communication layer.

Counterpart of ``deepspeed_tpu/comm/comm.py``.  The JAX functions are
traced into XLA programs under a named mesh axis; the port runs them
eagerly on ``torch.distributed``, one process per rank, and each
function still takes a mesh axis name (or several, jointly), which the
current :class:`~deepspeed_tpu_torch.parallel.topology.ProcessMesh`
(``set_mesh``; by default every rank on ``data``) maps to that axis's
process group.  An axis of size 1 outside ``torch.distributed`` is an
identity.

Backends: ``nccl`` (tensors stay on the card) and ``gloo``.  ``gloo``
takes few collectives on CUDA tensors, so under ``gloo`` a CUDA tensor
goes through a pinned host buffer, explicitly: copied down (a host
sync), reduced or gathered on the host, copied back.  That sync is the
one exception to the step's rule of no host sync, and exists only for
ranks that share a card (NCCL takes one card a rank).  ``nccl`` with
more ranks than visible cards on a node raises, naming ``gloo``; the
backend is never switched silently.

Every op records its payload bytes and its time in the comms logger
(``comms_logging.py``) when that is enabled.

Point to point, for the pipeline: ``ppermute`` (and its ring shifts
``send_recv_next`` / ``send_recv_prev``) moves each member's tensor to
the member the permutation names, as ``jax.lax.ppermute`` does, and
``send`` / ``recv`` move one tensor between two members of an axis.  A
send is posted without waiting (``isend``) and completes in the
background; ``wait_sends`` waits for every send still in flight.  So
two neighbouring stages that both send in one step, each then waiting
in its receive, cannot deadlock: each one's receive is posted before
the paired send completes.  Shapes are the caller's (the pipeline knows
them from its config): no shape handshake crosses the wire.

Host objects: ``broadcast_object`` hands one picklable object from one
member of an axis to every member (``broadcast_object_list``), the
serving mesh's per-iteration decisions (``inference/serving/
lockstep.py``).  ``use_mesh`` makes a mesh current for the calling
thread alone, so an engine that owns its process groups (a serving
replica stepping on its own thread) resolves axis names to them while
another thread's collectives go on over its own.
"""
from __future__ import annotations

import contextlib
import datetime
import ipaddress
import os
import socket
import threading
from enum import Enum
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import logger
from .comms_logging import get_comms_logger


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.PRODUCT: "PRODUCT",
              ReduceOp.MIN: "MIN", ReduceOp.MAX: "MAX",
              ReduceOp.AVG: "SUM"}   # AVG = SUM, then / n (gloo has no AVG)

# the flat-buffer collectives under their current names (newer torch
# renamed them; the older names remain as deprecated aliases)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

#: backends the port drives
SUPPORTED_DIST_BACKENDS = ("nccl", "gloo")


class _World:
    """What this process knows of its world: the backend it initialized
    and the mesh the collectives resolve axis names against
    (``torch.distributed`` itself is process-global state)."""
    backend: Optional[str] = None
    local_rank: int = 0
    mesh = None


_world = _World()
#: a mesh made current for one thread (``use_mesh``), over ``_world.mesh``
_local = threading.local()


def _is_loopback(host: str) -> bool:
    try:
        return ipaddress.ip_address(socket.gethostbyname(host)).is_loopback
    except (OSError, ValueError):
        return False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(dist_backend: str = "nccl",
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     local_world_size: Optional[int] = None,
                     timeout: Optional[float] = None, **_ignored) -> None:
    """Initialize ``torch.distributed`` (the reference's
    ``comm/comm.py:599``).  Each argument left None is read from
    torchrun's environment contract: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``init_method`` then ``env://``); a world of one
    with no address gets a free port on localhost.  ``timeout`` (seconds)
    bounds every collective.  A second call is a no-op.

    ``dist_backend`` is ``nccl`` or ``gloo``; any other value raises
    ``ValueError``, as the JAX function does for its own list.  ``nccl``
    raises when this node would run more ranks than it has visible
    cards."""
    if dist_backend is None or \
            str(dist_backend).lower() not in SUPPORTED_DIST_BACKENDS:
        raise ValueError(
            f"unknown dist_backend {dist_backend!r}: the PyTorch port "
            f"drives its collectives through torch.distributed — "
            f"supported values: {', '.join(SUPPORTED_DIST_BACKENDS)}")
    backend = str(dist_backend).lower()
    if dist.is_initialized():
        return
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else int(local_rank))
    if init_method is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://127.0.0.1:{_free_port()}"
        else:
            raise ValueError(
                "init_distributed: a world of several ranks needs "
                "MASTER_ADDR and MASTER_PORT, or init_method")
    if local_world_size is None:
        if "LOCAL_WORLD_SIZE" in env:
            local_world_size = int(env["LOCAL_WORLD_SIZE"])
        else:
            host = (env.get("MASTER_ADDR") if init_method == "env://"
                    else init_method.split("://", 1)[-1].rsplit(":", 1)[0])
            # every rank behind a loopback address runs on this node
            if host and init_method.startswith(("env://", "tcp://")) \
                    and _is_loopback(host):
                local_world_size = world_size
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if local_rank >= cards or (local_world_size or 0) > cards:
            raise ValueError(
                f"dist_backend 'nccl' takes one CUDA card a rank: this "
                f"node runs {local_world_size or local_rank + 1} ranks "
                f"and sees {cards} card(s). Ranks that share a card run "
                f"on 'gloo' (dist_backend='gloo', device='cuda:0')")
        torch.cuda.set_device(local_rank)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    _world.backend = backend
    _world.local_rank = local_rank
    _world.mesh = None
    logger.info(f"torch.distributed initialized: rank {rank}/{world_size} "
                f"({backend})")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def destroy_process_group() -> None:
    """Tear down ``torch.distributed`` and forget the mesh."""
    if is_initialized():
        dist.destroy_process_group()
    _world.backend = None
    _world.mesh = None


def get_backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def get_local_rank() -> int:
    if is_initialized():
        return _world.local_rank
    return int(os.environ.get("LOCAL_RANK", 0))


def barrier(group=None) -> None:
    """Rendezvous every rank of ``group`` (all ranks by default)."""
    if is_initialized():
        if get_backend() == "nccl":
            dist.barrier(group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group)


def set_mesh(mesh) -> None:
    """The ``ProcessMesh`` that axis names resolve against."""
    _world.mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh of the calling thread for the
    block (other threads keep theirs); None leaves things as they
    are."""
    if mesh is None:
        yield
        return
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield
    finally:
        _local.mesh = prev


def get_mesh():
    """The current mesh: this thread's (``use_mesh``), else the
    process's; by default every rank on ``data``."""
    mine = getattr(_local, "mesh", None)
    if mine is not None:
        return mine
    if _world.mesh is None:
        from ..parallel.topology import build_mesh
        _world.mesh = build_mesh()
    return _world.mesh


def _axis(axis_name):
    mesh = get_mesh()
    return mesh.axis_size(axis_name), mesh.group(axis_name)


def _staged(t: torch.Tensor) -> bool:
    """Under gloo a CUDA tensor crosses through a pinned host buffer."""
    return t.is_cuda and get_backend() == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)          # waits for the card: gloo reads the buffer next
    return h


@contextlib.contextmanager
def _logged(op_name: str, tensor: torch.Tensor, axis_name, n: int):
    cl = get_comms_logger()
    if cl is None or not cl.wants(op_name):
        yield
        return
    timer = cl.start(tensor.device)
    yield
    timer.stop()
    cl.record(op_name, tensor.numel() * tensor.element_size(),
              str(axis_name), n=n, timer=timer)


def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
               axis_name="data") -> torch.Tensor:
    """Reduce ``tensor`` over ``axis_name`` in place; returns it."""
    n, group = _axis(axis_name)
    if group is None:
        return tensor
    with _logged("all_reduce", tensor, axis_name, n):
        top = getattr(dist.ReduceOp, _TORCH_OPS[op])
        if _staged(tensor):
            h = _to_host(tensor)
            dist.all_reduce(h, op=top, group=group)
            tensor.copy_(h, non_blocking=True)
        else:
            dist.all_reduce(tensor, op=top, group=group)
        if op == ReduceOp.AVG:
            tensor.div_(n)
    return tensor


def all_gather(tensor: torch.Tensor, axis_name="data", axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every member's ``tensor`` along ``axis``: concatenated
    (``tiled``) or stacked in a new dim at ``axis`` (the reference's
    ``all_gather_into_tensor``, ``comm/comm.py:310``).  A new tensor."""
    n, group = _axis(axis_name)
    axis = axis % max(tensor.dim(), 1) if tiled else axis
    if group is None:
        return tensor.clone() if tiled else tensor.unsqueeze(axis)
    src = tensor.contiguous()
    with _logged("all_gather", src, axis_name, n):
        staged = _staged(src)
        x = _to_host(src) if staged else src
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        _ALL_GATHER(out.view(-1), x.view(-1), group=group)
        if staged:
            out = out.to(tensor.device, non_blocking=True)
    if not tiled:
        return out.movedim(0, axis).contiguous()
    if axis == 0:
        return out.reshape((n * src.shape[0],) + tuple(src.shape[1:]))
    shape = list(src.shape)
    shape[axis] *= n
    return out.movedim(0, axis).reshape(shape)


def reduce_scatter(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                   axis_name="data", scatter_dimension: int = 0
                   ) -> torch.Tensor:
    """Reduce over ``axis_name``, then keep this member's 1/n slice along
    ``scatter_dimension`` (the reference's ``reduce_scatter_tensor``,
    ``comm/comm.py:505``).  A new contiguous tensor; a slice along a dim
    other than 0 is staged as contiguous chunks, never a strided view."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError("reduce_scatter supports SUM/AVG")
    n, group = _axis(axis_name)
    d = scatter_dimension % tensor.dim()
    if tensor.shape[d] % n:
        raise ValueError(f"reduce_scatter: dim {d} of {tuple(tensor.shape)}"
                         f" is not divisible by the axis size {n}")
    if group is None:
        return tensor.clone()
    chunks = tensor.chunk(n, d)
    src = tensor.contiguous() if d == 0 else torch.stack(chunks)
    with _logged("reduce_scatter", src, axis_name, n):
        staged = _staged(src)
        x = _to_host(src) if staged else src
        out = torch.empty(chunks[0].shape, dtype=x.dtype, device=x.device)
        _REDUCE_SCATTER(out.view(-1), x.view(-1), op=dist.ReduceOp.SUM,
                        group=group)
        if staged:
            out = out.to(tensor.device, non_blocking=True)
        if op == ReduceOp.AVG:
            out.div_(n)
    return out


def all_to_all_single(tensor: torch.Tensor, axis_name="expert",
                      split_axis: int = 0, concat_axis: int = 0,
                      input_split_sizes=None, output_split_sizes=None
                      ) -> torch.Tensor:
    """Split ``tensor`` along ``split_axis`` into n chunks, send chunk j
    to member j, and concatenate what arrives along ``concat_axis`` in
    the senders' order (the MoE dispatch collective, reference
    ``comm/comm.py:361``).  With ``input_split_sizes`` (the rows this
    member sends to each member, along dim 0) and ``output_split_sizes``
    (the rows it receives from each) the chunks are uneven: the caller
    knows both lists, no count crosses the wire.  A new tensor."""
    n, group = _axis(axis_name)
    uneven = input_split_sizes is not None
    if uneven and (split_axis or concat_axis):
        raise ValueError("all_to_all_single: uneven splits run along dim 0")
    if group is None:
        return tensor.clone()
    x = tensor.movedim(split_axis, 0).contiguous()
    if not uneven and x.shape[0] % n:
        raise ValueError(f"all_to_all_single: dim {split_axis} of "
                         f"{tuple(tensor.shape)} is not divisible by {n}")
    with _logged("all_to_all", x, axis_name, n):
        staged = _staged(x)
        h = _to_host(x) if staged else x
        if uneven:
            out = torch.empty((sum(output_split_sizes),) + tuple(h.shape[1:]),
                              dtype=h.dtype, device=h.device)
            dist.all_to_all_single(out, h, list(output_split_sizes),
                                   list(input_split_sizes), group=group)
        else:
            out = torch.empty_like(h)
            dist.all_to_all_single(out, h, group=group)
        if staged:
            out = out.to(tensor.device, non_blocking=True)
    if uneven:
        return out
    parts = [c.movedim(0, split_axis) for c in out.chunk(n, 0)]
    return torch.cat(parts, dim=concat_axis)


def broadcast(tensor: torch.Tensor, src: int = 0,
              axis_name="data") -> torch.Tensor:
    """Member ``src`` (its index on ``axis_name``) to every member, in
    place; returns ``tensor``."""
    n, group = _axis(axis_name)
    if group is None:
        return tensor
    root = get_mesh().axis_ranks(axis_name)[src]
    with _logged("broadcast", tensor, axis_name, n):
        if _staged(tensor):
            h = _to_host(tensor)
            dist.broadcast(h, root, group=group)
            tensor.copy_(h, non_blocking=True)
        else:
            dist.broadcast(tensor, root, group=group)
    return tensor


def broadcast_object(obj, src: int = 0, axis_name="data"):
    """Member ``src`` of ``axis_name``'s picklable ``obj`` on every
    member (the others' ``obj`` is ignored); returns it.  The identity
    outside ``torch.distributed`` or on an axis of size 1."""
    n, group = _axis(axis_name)
    if group is None or n == 1:
        return obj
    root = get_mesh().axis_ranks(axis_name)[src]
    box = [obj]
    dist.broadcast_object_list(box, src=root, group=group)
    return box[0]


# -- point to point -----------------------------------------------------------
class _Send:
    """A posted send: the work and the buffer it reads, kept alive until
    the work completes."""

    __slots__ = ("work", "buf")

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        if self.work is not None:
            self.work.wait()
            self.work = self.buf = None


#: sends posted and not yet waited for, oldest first
_SENDS: list = []


def _reap() -> None:
    """Drop the sends that have completed (their buffers are free)."""
    _SENDS[:] = [s for s in _SENDS if s.work is not None
                 and not s.work.is_completed()]


def _member(axis_name, index: int) -> int:
    """The global rank of member ``index`` of this rank's ``axis_name``
    group."""
    return get_mesh().axis_ranks(axis_name)[index]


def _post(tensor: torch.Tensor, dst: int, axis_name, group) -> _Send:
    _reap()
    buf = tensor.contiguous()
    if _staged(buf):
        buf = _to_host(buf)
    s = _Send(dist.isend(buf, _member(axis_name, dst), group=group), buf)
    _SENDS.append(s)
    return s


def _take(tensor: torch.Tensor, src: int, axis_name, group) -> torch.Tensor:
    staged = _staged(tensor)
    buf = (torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
           if staged else tensor if tensor.is_contiguous()
           else torch.empty_like(tensor,
                                 memory_format=torch.contiguous_format))
    dist.recv(buf, _member(axis_name, src), group=group)
    if buf is not tensor:
        tensor.copy_(buf, non_blocking=staged)
    return tensor


def send(tensor: torch.Tensor, dst: int, axis_name="pipe") -> _Send:
    """Post ``tensor`` to member ``dst`` of ``axis_name`` (its index on
    the axis) and return at once; under gloo a CUDA tensor is first
    copied into a pinned host buffer (a host sync).  The send completes
    in the background (``wait_sends``)."""
    n, group = _axis(axis_name)
    if group is None:
        raise ValueError(f"send over axis {axis_name!r} of size {n}")
    with _logged("send", tensor, axis_name, n):
        return _post(tensor, dst, axis_name, group)


def recv(tensor: torch.Tensor, src: int, axis_name="pipe") -> torch.Tensor:
    """Receive into ``tensor`` (its shape and dtype are what member
    ``src`` of ``axis_name`` sends) and return it; waits for the data."""
    n, group = _axis(axis_name)
    if group is None:
        raise ValueError(f"recv over axis {axis_name!r} of size {n}")
    with _logged("recv", tensor, axis_name, n):
        return _take(tensor, src, axis_name, group)


def wait_sends() -> None:
    """Wait for every send still in flight."""
    while _SENDS:
        _SENDS.pop(0).wait()


def ppermute(tensor: torch.Tensor, perm, axis_name="pipe") -> torch.Tensor:
    """``jax.lax.ppermute``: member ``s`` of ``axis_name`` sends its
    ``tensor`` to member ``d`` for each ``(s, d)`` of ``perm``; returns
    what this member receives, zeros where no member sends to it.  A new
    tensor."""
    perm = [(int(s), int(d)) for s, d in perm]
    if len({s for s, _ in perm}) != len(perm) or \
            len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a permutation")
    n, group = _axis(axis_name)
    me = get_mesh().axis_index(axis_name) if group is not None else 0
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    out = torch.zeros_like(tensor)
    if group is None:
        return tensor.clone() if srcs else out
    with _logged("ppermute", tensor, axis_name, n):
        sent = _post(tensor, dsts[0], axis_name, group) if dsts else None
        if srcs:
            _take(out, srcs[0], axis_name, group)
        if sent is not None:
            sent.wait()
    return out


def send_recv_next(tensor: torch.Tensor, n: Optional[int] = None,
                   axis_name="pipe") -> torch.Tensor:
    """Each member's ``tensor`` to the next member of the ring (i → i +
    1): returns the previous member's."""
    n = axis_size(axis_name) if n is None else n
    return ppermute(tensor, [(i, (i + 1) % n) for i in range(n)], axis_name)


def send_recv_prev(tensor: torch.Tensor, n: Optional[int] = None,
                   axis_name="pipe") -> torch.Tensor:
    """Each member's ``tensor`` to the previous member (i → i - 1)."""
    n = axis_size(axis_name) if n is None else n
    return ppermute(tensor, [(i, (i - 1) % n) for i in range(n)], axis_name)


def axis_index(axis_name) -> int:
    return get_mesh().axis_index(axis_name)


def axis_size(axis_name) -> int:
    return get_mesh().axis_size(axis_name)


def log_summary() -> str:
    cl = get_comms_logger()
    return cl.log_summary() if cl else ""


def configure(config=None, verbose: Optional[bool] = None, **kw):
    """Enable comms logging (reference ``comm/comm.py:83``); returns the
    ``CommsLogger``."""
    from .comms_logging import configure as _cfg
    return _cfg(config=config, verbose=verbose, **kw)

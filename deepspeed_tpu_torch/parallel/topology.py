"""Process mesh and topology.

Counterpart of ``deepspeed_tpu/parallel/topology.py``.  The JAX package
builds one ``jax.sharding.Mesh`` of devices with named axes and lets XLA
emit the collectives; the port runs one process per rank on
``torch.distributed`` (PyTorch's idiom, and the reference DeepSpeed's)
and builds, in place of that mesh, a :class:`ProcessMesh`: the ranks
laid out row-major in ``AXIS_ORDER``, as ``build_mesh`` lays out
devices, one process group for each axis above 1 (and one for the
data-parallel product ``(dcn_data, data)`` when both are above 1), and
each rank's coordinates.  So rank r of a ``data`` mesh holds what device
r of the JAX mesh holds.

Axis names (canonical order, outermost → innermost):
    dcn_data — replicas across hosts
    pipe     — pipeline stages
    data     — data parallel / ZeRO sharding axis
    expert   — MoE expert parallel
    sequence — context parallelism
    model    — tensor parallel
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

AXIS_ORDER = ("dcn_data", "pipe", "data", "expert", "sequence", "model")

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
SEQUENCE_AXIS = "sequence"
DCN_DATA_AXIS = "dcn_data"

#: the data-parallel product ZeRO partitions over
DATA_AXES = (DCN_DATA_AXIS, DATA_AXIS)

AxisName = Union[str, Sequence[str]]


@dataclass(frozen=True)
class MeshSpec:
    """Resolved axis sizes. Product must equal the world size."""
    dcn_data: int = 1
    pipe: int = 1
    data: int = 1
    expert: int = 1
    sequence: int = 1
    model: int = 1

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    @property
    def world_size(self) -> int:
        return int(np.prod(self.sizes))


def resolve_mesh_spec(mesh_config, n_devices: int) -> MeshSpec:
    """Resolve -1 ("absorb remaining devices") axis sizes against n_devices."""
    sizes = {a: getattr(mesh_config, a, 1) for a in AXIS_ORDER}
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {wild}")
    fixed = int(np.prod([s for s in sizes.values() if s != -1]))
    if wild:
        if n_devices % fixed != 0:
            raise ValueError(
                f"Device count {n_devices} not divisible by fixed axes {fixed}")
        sizes[wild[0]] = n_devices // fixed
    spec = MeshSpec(**sizes)
    if spec.world_size != n_devices:
        raise ValueError(
            f"Mesh {sizes} covers {spec.world_size} devices, have {n_devices}")
    return spec


class ProcessMesh:
    """Ranks on named axes.  ``shape`` maps every axis of ``AXIS_ORDER``
    to its size (as ``jax.sharding.Mesh.shape``), ``coords`` this rank's
    coordinate on each.  Process groups are built at construction (every
    rank must construct the mesh, in the same order, as
    ``torch.distributed.new_group`` requires) for each axis above 1 and
    for the data-parallel product; an axis that spans the whole world
    uses the default group.  A mesh of one rank needs no
    ``torch.distributed``; a larger one needs it initialized."""

    def __init__(self, spec: MeshSpec, rank: int = 0):
        if not 0 <= rank < spec.world_size:
            raise ValueError(f"rank {rank} outside a mesh of "
                             f"{spec.world_size}")
        self.spec = spec
        self.shape: Dict[str, int] = dict(zip(AXIS_ORDER, spec.sizes))
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(
            AXIS_ORDER, (int(c) for c in np.unravel_index(rank,
                                                          spec.sizes))))
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        initialized = dist.is_available() and dist.is_initialized()
        if spec.world_size > 1 and not initialized:
            raise RuntimeError(
                f"a mesh of {spec.world_size} ranks needs "
                f"torch.distributed: call deepspeed_tpu_torch."
                f"init_distributed() first")
        if initialized and dist.get_world_size() != spec.world_size:
            raise ValueError(
                f"mesh {self.shape} covers {spec.world_size} ranks, "
                f"the process group has {dist.get_world_size()}")
        keys = [(a,) for a in AXIS_ORDER if self.shape[a] > 1]
        joint = self.key(DATA_AXES)
        if len(joint) > 1:
            keys.append(joint)
        for key in keys:
            self._build(key)
        if initialized and spec.world_size == 1:
            # a world of one still runs its collectives through the
            # backend (each an identity), so they are exercised
            self._groups[()] = (dist.group.WORLD, [0])

    @property
    def world_size(self) -> int:
        return self.spec.world_size

    def key(self, axes: AxisName) -> Tuple[str, ...]:
        """``axes`` (one name or several) as the tuple of its axes above
        1, in ``AXIS_ORDER``."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(names) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"have {AXIS_ORDER}")
        return tuple(a for a in AXIS_ORDER
                     if a in names and self.shape[a] > 1)

    def axis_size(self, axes: AxisName) -> int:
        return int(np.prod([self.shape[a] for a in self.key(axes)]))

    def axis_index(self, axes: AxisName) -> int:
        """This rank's joint coordinate on ``axes`` (row-major)."""
        idx = 0
        for a in self.key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _ranks_of(self, key: Tuple[str, ...], coords: Dict[str, int]
                  ) -> List[int]:
        free = [range(self.shape[a]) if a in key else [coords[a]]
                for a in AXIS_ORDER]
        return [int(np.ravel_multi_index(c, self.spec.sizes))
                for c in itertools.product(*free)]

    def _build(self, key: Tuple[str, ...]) -> None:
        if self.axis_size(key) == self.world_size:
            self._groups[key] = (dist.group.WORLD,
                                 list(range(self.world_size)))
            return
        others = [a for a in AXIS_ORDER if a not in key]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            ranks = self._ranks_of(key, dict(zip(others, fixed)))
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (group, ranks)
        self._groups[key] = mine

    def group(self, axes: AxisName):
        """The process group of this rank along ``axes``; None for an
        axis of size 1 when ``torch.distributed`` is not running."""
        entry = self._groups.get(self.key(axes))
        return None if entry is None else entry[0]

    def axis_ranks(self, axes: AxisName) -> List[int]:
        """The global ranks of this rank's group along ``axes``, in the
        order of their joint coordinate."""
        key = self.key(axes)
        if key in self._groups:
            return list(self._groups[key][1])
        return self._ranks_of(key, self.coords)

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, rank={self.rank})"


def build_mesh(mesh_config=None, world_size: Optional[int] = None,
               rank: Optional[int] = None) -> ProcessMesh:
    """The process mesh of this rank: ``mesh_config`` (a ``MeshConfig``;
    None = every rank on ``data``) resolved against the world size
    (``torch.distributed``'s, or 1 when it is not initialized)."""
    initialized = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    spec = (MeshSpec(data=world_size) if mesh_config is None
            else resolve_mesh_spec(mesh_config, world_size))
    return ProcessMesh(spec, rank)


class ProcessTopology:
    """Rank <-> named-coordinate map over any axes (the JAX package's
    ``ProcessTopology``, the reference's ``runtime/pipe/topology.py:9``):
    ranks enumerate row-major in the order of ``axes``; coordinates,
    filters and the rank lists along one axis are pure bookkeeping (the
    checkpoint reshape and the pipeline grid read them; at run time the
    :class:`ProcessMesh` owns the process groups)."""

    def __init__(self, axes: List[str], dims: List[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must have the same length")
        self.axes = list(axes)
        self.dims = list(dims)
        self._coord_to_rank: Dict[Tuple[int, ...], int] = {
            coord: rank for rank, coord in enumerate(
                itertools.product(*(range(d) for d in dims)))}
        self._rank_to_coord = {r: c for c, r in self._coord_to_rank.items()}

    @property
    def world_size(self) -> int:
        return int(np.prod(self.dims))

    def get_rank(self, **coords) -> int:
        self._check_axes(coords)
        return self._coord_to_rank[tuple(coords[a] for a in self.axes)]

    def get_coord(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axes, self._rank_to_coord[rank]))

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)]

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        """Every rank whose coordinate on ``axis`` is ``idx``."""
        ai = self.axes.index(axis)
        return sorted(r for c, r in self._coord_to_rank.items()
                      if c[ai] == idx)

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """The groups of ranks that differ only along ``axis``."""
        ai = self.axes.index(axis)
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for coord, rank in sorted(self._coord_to_rank.items(),
                                  key=lambda kv: kv[1]):
            groups.setdefault(coord[:ai] + coord[ai + 1:], []).append(rank)
        return [sorted(g) for g in groups.values()]

    def filter_match(self, **filter_kwargs) -> List[int]:
        self._check_axes(filter_kwargs)
        return sorted(r for c, r in self._coord_to_rank.items()
                      if all(dict(zip(self.axes, c))[k] == v
                             for k, v in filter_kwargs.items()))

    def _check_axes(self, coords) -> None:
        unknown = set(coords) - set(self.axes)
        if unknown:
            raise ValueError(f"Unknown axes {unknown}; have {self.axes}")

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeModelDataParallelTopology(ProcessTopology):
    """The (pipe, data, model) topology (the reference's
    ``topology.py:243``)."""

    def __init__(self, num_pp: int, num_dp: int, num_mp: int):
        super().__init__(axes=["pipe", "data", "model"],
                         dims=[num_pp, num_dp, num_mp])


def dp_world_size(mesh) -> int:
    return (mesh.shape.get(DATA_AXIS, 1) * mesh.shape.get(DCN_DATA_AXIS, 1)
            * mesh.shape.get(EXPERT_AXIS, 1))


def mp_world_size(mesh) -> int:
    return mesh.shape.get(MODEL_AXIS, 1)


def pp_world_size(mesh) -> int:
    return mesh.shape.get(PIPE_AXIS, 1)

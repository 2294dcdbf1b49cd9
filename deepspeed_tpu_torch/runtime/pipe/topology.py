"""Pipeline-parallel grid: rank bookkeeping over the 3D topology.

Counterpart of ``deepspeed_tpu/runtime/pipe/topology.py`` (the
reference's ``PipelineParallelGrid``, ``runtime/pipe/topology.py:249``):
given the (pipe, data, model) topology, which stage, data replica and
model shard rank r is, and which ranks form each group.  It reads the
axis sizes of a :class:`~deepspeed_tpu_torch.parallel.topology.
ProcessMesh` (which owns the process groups) or takes a topology, and
never builds groups itself.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ...parallel.topology import (DATA_AXIS, DCN_DATA_AXIS, EXPERT_AXIS,
                                  MODEL_AXIS, PIPE_AXIS,
                                  PipeModelDataParallelTopology,
                                  ProcessTopology)


def grid_sizes_from_mesh(mesh) -> Tuple[int, int, int]:
    """(pipe, data, model) axis sizes of a mesh (anything with a
    ``shape`` mapping); the data leg is the whole data-parallel product
    (dcn_data x data x expert)."""
    ms = dict(mesh.shape)
    dp = (ms.get(DCN_DATA_AXIS, 1) * ms.get(DATA_AXIS, 1)
          * ms.get(EXPERT_AXIS, 1))
    return ms.get(PIPE_AXIS, 1), dp, ms.get(MODEL_AXIS, 1)


class PipelineParallelGrid:
    """Stage / replica / shard coordinates over a (pipe, data, model)
    grid.  Ranks enumerate row-major, as ``ProcessMesh`` lays them out,
    so rank r here is rank r of the mesh whose sizes built this grid."""

    def __init__(self, topology: Optional[ProcessTopology] = None,
                 mesh=None):
        if topology is None:
            if mesh is None:
                raise ValueError(
                    "PipelineParallelGrid needs a topology or a mesh")
            pp, dp, mp = grid_sizes_from_mesh(mesh)
            topology = PipeModelDataParallelTopology(pp, dp, mp)
        self._topo = topology
        self.pipe_parallel_size = topology.get_dim("pipe") \
            if "pipe" in topology.axes else 1
        self.data_parallel_size = topology.get_dim("data") \
            if "data" in topology.axes else 1
        self.model_parallel_size = topology.get_dim("model") \
            if "model" in topology.axes else 1

    @property
    def topology(self) -> ProcessTopology:
        return self._topo

    @property
    def world_size(self) -> int:
        return self._topo.world_size

    def _coord(self, rank: int) -> Dict[str, int]:
        return self._topo.get_coord(rank)

    def get_stage_id(self, rank: int) -> int:
        return self._coord(rank).get("pipe", 0)

    def get_data_parallel_id(self, rank: int) -> int:
        return self._coord(rank).get("data", 0)

    def get_model_parallel_id(self, rank: int) -> int:
        return self._coord(rank).get("model", 0)

    def is_first_stage(self, rank: int) -> bool:
        return self.get_stage_id(rank) == 0

    def is_last_stage(self, rank: int) -> bool:
        return self.get_stage_id(rank) == self.pipe_parallel_size - 1

    def pipe_groups(self) -> List[List[int]]:
        """The rank groups that differ only along ``pipe``: each is one
        pipeline."""
        return self._topo.get_axis_comm_lists("pipe")

    def data_groups(self) -> List[List[int]]:
        return self._topo.get_axis_comm_lists("data")

    def model_groups(self) -> List[List[int]]:
        return self._topo.get_axis_comm_lists("model")

    def stage_to_ranks(self, stage: int) -> List[int]:
        """Every rank holding pipeline stage ``stage``."""
        return self._topo.get_axis_list("pipe", stage)

    def ppermute_ring(self, shift: int = 1) -> List[Tuple[int, int]]:
        """(src_stage, dst_stage) pairs of the activation ring: the
        permutation ``comm.ppermute`` takes on the ``pipe`` axis."""
        s = self.pipe_parallel_size
        return [(i, (i + shift) % s) for i in range(s)]

    def stage_neighbors(self, stage: int) -> Tuple[Optional[int],
                                                   Optional[int]]:
        """(prev, next) stage ids along the dataflow; None past the
        ends."""
        prev = stage - 1 if stage > 0 else None
        nxt = stage + 1 if stage < self.pipe_parallel_size - 1 else None
        return prev, nxt

    def __str__(self):
        return (f"PipelineParallelGrid(pipe={self.pipe_parallel_size}, "
                f"data={self.data_parallel_size}, "
                f"model={self.model_parallel_size})")

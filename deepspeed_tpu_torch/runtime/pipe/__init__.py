"""Pipeline parallelism.

Exports the bookkeeping surface: the stage / replica / shard grid and
the schedule instruction set.  ``PipelineEngine`` stays a deep import
(``runtime.pipe.engine``): ``deepspeed_tpu_torch.initialize`` builds it
whenever the mesh's ``pipe`` axis is 2 or more.
"""
from . import schedule  # noqa: F401
from .topology import (PipelineParallelGrid,  # noqa: F401
                       grid_sizes_from_mesh)

__all__ = ["PipelineParallelGrid", "grid_sizes_from_mesh", "schedule"]

"""Process mesh (``topology.py``) and the data-parallel gradient
reduction (``collectives.py``).  The JAX package's
``parallel/shard_map_compat.py`` is a shim over JAX versions and has no
PyTorch counterpart."""
from .topology import (AXIS_ORDER, DATA_AXES, DATA_AXIS, DCN_DATA_AXIS,
                       EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQUENCE_AXIS,
                       MeshSpec, ProcessMesh, build_mesh, dp_world_size,
                       mp_world_size, pp_world_size, resolve_mesh_spec)

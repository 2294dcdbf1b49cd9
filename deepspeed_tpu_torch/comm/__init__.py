"""Collectives over ``torch.distributed`` by mesh axis name
(``comm.py``), their logging (``comms_logging.py``), a bandwidth sweep
(``benchmarks.py``) and a torchrun-style launcher of local ranks
(``local_ranks.py``)."""
from .comm import (ReduceOp, SUPPORTED_DIST_BACKENDS, all_gather,
                   all_reduce, all_to_all_single, axis_index, axis_size,
                   barrier, broadcast, configure, destroy_process_group,
                   get_backend, get_local_rank, get_mesh, get_rank,
                   get_world_size, init_distributed, is_initialized,
                   log_summary, reduce_scatter, set_mesh)
from .comms_logging import CommsLogger, calc_bw_factor, get_comms_logger

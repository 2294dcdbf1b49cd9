"""Continuous-batching serving (paged KV pool, iteration-level
scheduler, mixed decode + chunked-prefill step with the speculative
lane), the multi-tenant front end and its token streaming, the tiered
host prefix cache (``host_cache``) and the replica fleet (``fleet``:
router, replicas, autoscaler)."""
from ...observability.slo import SloAlert, SloMonitor
from ...runtime.resilience.errors import ServingError
from .block_allocator import (NULL_BLOCK, BlockPoolError, PagedBlockAllocator,
                              blocks_for_budget, kv_block_bytes)
from .engine import ServingEngine
from .fleet import (FleetAutoscaler, FleetRequest, FleetRouter,
                    ReplicaHandle, ReplicaState, placement_score)
from .frontend import (ServingFrontend, StreamCollector, StreamDeduper,
                       TenantRegistry, TenantSpec, TokenEvent)
from .host_cache import (BlockCodec, HostTierCache, host_block_bytes,
                         tiered_blocks_for_budget)
from .scheduler import (ContinuousBatchingScheduler, Request, RequestState,
                        RequestStatus)

__all__ = ["BlockCodec", "BlockPoolError", "ContinuousBatchingScheduler",
           "FleetAutoscaler", "FleetRequest", "FleetRouter", "HostTierCache",
           "NULL_BLOCK", "PagedBlockAllocator", "ReplicaHandle",
           "ReplicaState", "Request", "RequestState", "RequestStatus",
           "ServingEngine", "ServingError", "ServingFrontend", "SloAlert",
           "SloMonitor", "StreamCollector", "StreamDeduper", "TenantRegistry",
           "TenantSpec", "TokenEvent", "blocks_for_budget", "host_block_bytes",
           "kv_block_bytes", "placement_score", "tiered_blocks_for_budget"]

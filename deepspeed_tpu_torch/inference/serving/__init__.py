"""Continuous-batching serving (paged KV pool, iteration-level
scheduler, mixed decode + chunked-prefill step with the speculative
lane), the multi-tenant front end and its token streaming.  The JAX
package's fleet and tiered host cache come with ROADMAP.md queue A item
4, second part."""
from ...observability.slo import SloAlert, SloMonitor
from ...runtime.resilience.errors import ServingError
from .block_allocator import (NULL_BLOCK, BlockPoolError, PagedBlockAllocator,
                              blocks_for_budget, kv_block_bytes)
from .engine import ServingEngine
from .frontend import (ServingFrontend, StreamCollector, StreamDeduper,
                       TenantRegistry, TenantSpec, TokenEvent)
from .scheduler import (ContinuousBatchingScheduler, Request, RequestState,
                        RequestStatus)

__all__ = ["BlockPoolError", "ContinuousBatchingScheduler", "NULL_BLOCK",
           "PagedBlockAllocator", "Request", "RequestState", "RequestStatus",
           "ServingEngine", "ServingError", "ServingFrontend", "SloAlert",
           "SloMonitor", "StreamCollector", "StreamDeduper", "TenantRegistry",
           "TenantSpec", "TokenEvent", "blocks_for_budget", "kv_block_bytes"]

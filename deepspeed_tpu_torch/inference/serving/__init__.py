"""Continuous-batching serving (paged KV pool, iteration-level
scheduler, mixed decode + chunked-prefill step)."""
from .block_allocator import BlockPoolError, PagedBlockAllocator
from .engine import ServingEngine
from .scheduler import (ContinuousBatchingScheduler, Request, RequestState,
                        RequestStatus)

__all__ = ["BlockPoolError", "ContinuousBatchingScheduler",
           "PagedBlockAllocator", "Request", "RequestState", "RequestStatus",
           "ServingEngine"]

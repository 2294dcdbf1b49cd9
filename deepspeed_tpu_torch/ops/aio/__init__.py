"""Async host file IO for the NVMe tier (``csrc/aio.cpp``)."""
from .aio_handle import (ALIGN, AsyncIOHandle, PinnedBuffer, aio_available,
                         odirect_fallbacks, round_up)

__all__ = ["ALIGN", "AsyncIOHandle", "PinnedBuffer", "aio_available",
           "odirect_fallbacks", "round_up"]

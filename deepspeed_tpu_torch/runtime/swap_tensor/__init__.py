"""Swap-tensor tier: the slot stores under the host tiers (DRAM, and NVMe
through ``ops/aio``).  The JAX package's pipelined optimizer swapper
(``partitioned_optimizer_swapper.py``) comes with the optimizer offload,
ROADMAP.md queue A item 8."""
from .slot_store import (DramSlotStore, NvmeSlotStore, SlotStore,
                         make_slot_store)

__all__ = ["DramSlotStore", "NvmeSlotStore", "SlotStore", "make_slot_store"]

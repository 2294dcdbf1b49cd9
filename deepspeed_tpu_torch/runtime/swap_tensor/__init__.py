"""Swap-tensor tier: the slot stores under the host tiers (DRAM, and NVMe
through ``ops/aio``) and the slot-partitioned optimizer of ZeRO-Infinity
(``partitioned_optimizer_swapper.py``)."""
from .partitioned_optimizer_swapper import SlotOptimizer
from .slot_store import (DramSlotStore, NvmeSlotStore, SlotStore,
                         make_slot_store)

__all__ = ["DramSlotStore", "NvmeSlotStore", "SlotOptimizer", "SlotStore",
           "make_slot_store"]

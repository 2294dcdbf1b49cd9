"""Fixed-stride slot stores: the storage layer of the host tiers.

Copy of ``deepspeed_tpu/runtime/swap_tensor/slot_store.py`` for the
PyTorch port.  The unit is a *slot*: one fixed-size byte record (one
encoded KV block of the serving engine's host cache, or one layer's
parameter or optimizer vector of ZeRO-Infinity), so ``offset = slot *
stride`` and every transfer is one large aligned IO.

Two backends with one API:
  - ``DramSlotStore`` — a single host allocation; acquire() is a view.
  - ``NvmeSlotStore`` — one file on the NVMe path; a ring of pinned
    4096-aligned buffers over the native aio handle (``csrc/aio.cpp``)
    hides read/write latency.

Access contract: ``prefetch(slot)`` → ``acquire(slot)`` → mutate →
``release(slot, dirty=)``.  ``page_lock()`` registers the store's host
memory with CUDA (the DRAM tier's allocation, the NVMe tier's ring), so a
``non_blocking`` host-to-device copy from a slot runs asynchronously;
``close()`` unregisters it.  A buffer is recycled only after its
writeback completes, so a ring of K buffers tolerates a reuse distance of
K-1.  ``write_slot``/``read_slot`` copy in and out synchronously: a byte
array ``read_slot`` returns belongs to the caller, never to the ring.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ...observability import get_registry, trace_span
from ...ops.aio import AsyncIOHandle, PinnedBuffer, round_up
from ...utils.logging import logger
from ..resilience import get_fault_injector, retry_call


def cuda_host_register(arr: np.ndarray) -> None:
    """Page-lock ``arr``'s memory for the card's DMA engines."""
    import torch
    rc = torch.cuda.cudart().cudaHostRegister(arr.ctypes.data, arr.nbytes,
                                              0)
    if int(rc) != 0:
        raise RuntimeError(f"cudaHostRegister of {arr.nbytes} bytes failed "
                           f"(CUDA error {int(rc)})")


def cuda_host_unregister(arr: np.ndarray) -> None:
    import torch
    torch.cuda.cudart().cudaHostUnregister(arr.ctypes.data)


class SlotStore:
    """Abstract fixed-stride slot store."""

    #: host arrays registered by page_lock(), unregistered by close()
    _locked: List[np.ndarray] = []

    #: optional RetryPolicy for transient-I/O retries on the file-backed
    #: tiers (None = runtime/resilience DEFAULT_IO_POLICY), set by the
    #: owner.
    io_policy = None

    def __init__(self, n_slots: int, slot_nbytes: int):
        self.n_slots = int(n_slots)
        self.slot_nbytes = int(slot_nbytes)

    def prefetch(self, slot: int) -> None:
        raise NotImplementedError

    def acquire(self, slot: int) -> np.ndarray:
        """uint8[slot_nbytes] view of the slot's bytes, host-resident."""
        raise NotImplementedError

    def release(self, slot: int, dirty: bool = False) -> None:
        raise NotImplementedError

    def write_slot(self, slot: int, data: np.ndarray) -> None:
        """Synchronous populate (init / checkpoint-load path)."""
        buf = self.acquire(slot)
        view = data.reshape(-1).view(np.uint8)
        buf[:view.nbytes] = view
        self.release(slot, dirty=True)

    def read_slot(self, slot: int, nbytes: Optional[int] = None) -> np.ndarray:
        """Synchronous copy-out (checkpoint-save path)."""
        buf = self.acquire(slot)
        out = buf[:nbytes if nbytes else self.slot_nbytes].copy()
        self.release(slot, dirty=False)
        return out

    def flush(self) -> None:
        pass

    def prefault(self) -> None:
        """Fault the store's host memory in now (no-op but for DRAM)."""

    def _host_arrays(self) -> List[np.ndarray]:
        return []

    def page_lock(self) -> None:
        """Register the store's host memory with CUDA (once)."""
        if self._locked:
            return
        arrays = self._host_arrays()
        for a in arrays:
            cuda_host_register(a)
        self._locked = arrays

    def _unlock(self) -> None:
        for a in self._locked:
            cuda_host_unregister(a)
        self._locked = []

    def close(self) -> None:
        self._unlock()

    @property
    def host_bytes(self) -> int:
        return 0

    @property
    def disk_bytes(self) -> int:
        return 0


class DramSlotStore(SlotStore):
    """All slots in one host allocation (the DRAM/'cpu' offload tier)."""

    def __init__(self, n_slots: int, slot_nbytes: int):
        super().__init__(n_slots, slot_nbytes)
        self._data = np.zeros((n_slots, slot_nbytes), np.uint8)

    def prefetch(self, slot: int) -> None:
        pass

    def acquire(self, slot: int) -> np.ndarray:
        return self._data[slot]

    def release(self, slot: int, dirty: bool = False) -> None:
        pass

    def prefault(self) -> None:
        """Fault every page in now, from several threads: a large store's
        first writes otherwise pay the page faults one page at a time on
        the writing thread."""
        from ...ops.adam.cpu_adam import prefault
        prefault(self._data)

    def _host_arrays(self) -> List[np.ndarray]:
        return [self._data]

    @property
    def host_bytes(self) -> int:
        return self._data.nbytes


class NvmeSlotStore(SlotStore):
    """Slots in a single file on the NVMe path, accessed through a pinned
    buffer ring over the native aio handle (reference
    `partitioned_param_swapper.py` swap_in/swap_out + inflight tracking)."""

    #: seconds _free_buf blocks for a concurrent release before declaring
    #: an acquire/release imbalance (instance-settable for tests)
    PIN_WAIT_TIMEOUT = 60.0

    #: seconds close() waits for outstanding pins to drain before the
    #: dangling-pin warning — sized to the transient window it guards
    #: (a peer parked in the I/O retry backoff, bounded by the retry
    #: budget: ~3s under the default policy), NOT the full acquire
    #: budget, so teardown during exception cleanup stays fast
    CLOSE_PIN_WAIT_TIMEOUT = 3.0

    #: optional callable the store invokes (lock held, re-entrant) when no
    #: buffer is free — lets the OWNER of outstanding pins release the ones
    #: whose async consumer (e.g. an H2D transfer) has finished. Without
    #: it, a thread that holds all pins itself would wait on its own
    #: release path and time out.
    reclaim = None

    def __init__(self, n_slots: int, slot_nbytes: int, path: str,
                 aio: Optional[AsyncIOHandle] = None, buffer_count: int = 4,
                 name: str = "slots"):
        super().__init__(n_slots, slot_nbytes)
        self.stride = round_up(slot_nbytes)
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        self.path = path
        self.aio = aio or AsyncIOHandle()
        self._own_aio = aio is None
        buffer_count = max(2, int(buffer_count))
        self._bufs = [PinnedBuffer(self.stride) for _ in range(buffer_count)]
        self._buf_op: List[Optional[int]] = [None] * buffer_count  # inflight
        self._buf_slot: List[Optional[int]] = [None] * buffer_count
        self._buf_pins: List[int] = [0] * buffer_count  # acquired, unreleased
        self._slot_buf: Dict[int, int] = {}   # slot currently materialized
        self._clock = 0
        # a store may be touched from more than one thread (a threaded
        # fleet replica beside the router's pump)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # preallocate the file so O_DIRECT offsets always exist
        total = self.stride * n_slots
        with open(path, "ab") as f:
            if f.tell() < total:
                f.truncate(total)
        logger.info(f"NvmeSlotStore[{name}]: {n_slots} x "
                    f"{slot_nbytes / 2**20:.1f} MiB at {path} "
                    f"({total / 2**30:.2f} GiB file, "
                    f"{buffer_count} pinned buffers)")

    def _host_arrays(self) -> List[np.ndarray]:
        return [b.array for b in self._bufs]

    # -- buffer ring ------------------------------------------------------
    def _wait_buf(self, b: int) -> None:
        if self._buf_op[b] is not None:
            with trace_span("swap/io_wait"):
                self.aio.wait_op(self._buf_op[b])
            self._buf_op[b] = None
            self._observe_depth()

    def _free_buf(self) -> int:
        """Next unpinned ring buffer, evicting its previous slot (after any
        pending IO on it has completed). When every buffer is pinned by
        other threads, block until a concurrent ``release`` frees one
        rather than aborting; only a full timeout — a genuine acquire/release
        imbalance — raises."""
        deadline = time.monotonic() + self.PIN_WAIT_TIMEOUT
        while True:
            for _ in range(len(self._bufs)):
                b = self._clock % len(self._bufs)
                self._clock += 1
                if self._buf_pins[b] > 0:
                    continue
                self._wait_buf(b)
                old = self._buf_slot[b]
                if old is not None and self._slot_buf.get(old) == b:
                    del self._slot_buf[old]
                self._buf_slot[b] = None
                return b
            if self.reclaim is not None:
                # release pins whose async consumer has completed — they
                # belong to THIS thread, so cond.wait could never see them
                self.reclaim()
                continue_scan = any(p == 0 for p in self._buf_pins)
                if continue_scan:
                    continue
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._cond.wait(min(remaining, 1.0)):
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"all {len(self._bufs)} pinned buffers stayed "
                        f"acquired for {self.PIN_WAIT_TIMEOUT:.0f}s — raise "
                        f"buffer_count (acquire/release imbalance otherwise)")

    def _backoff_sleep(self, delay: float) -> None:
        """Retry backoff for in-lock submissions: waiting on the store
        condition releases the RLock (all recursion levels) for the
        duration, so the concurrent stream/optimizer thread is not
        stalled for the whole retry budget. Spurious wakeups just retry
        the submission early — harmless."""
        self._cond.wait(delay)

    def _submit_with_retry(self, b: int, submit, what: str):
        """Run one aio submission under the retry budget. The buffer is
        PINNED across the attempts: the backoff sleep releases the lock,
        and an unpinned buffer would be up for grabs to a concurrent
        _free_buf the moment it does."""
        self._buf_pins[b] += 1
        try:
            return retry_call(submit, policy=self.io_policy, what=what,
                              sleep=self._backoff_sleep)
        finally:
            self._buf_pins[b] -= 1
            if self._buf_pins[b] == 0:
                self._cond.notify_all()

    def _observe_depth(self) -> None:
        """Swap-queue-depth gauge (lock held by every caller): in-flight
        aio ops across the buffer ring — the backpressure signal for
        sizing ``buffer_count``/``queue_depth``. Gated on the registry
        flag: this runs per aio op under the store lock, so the disabled
        path must stay one attribute check."""
        reg = get_registry()
        if not reg.enabled:
            return
        reg.gauge("dstpu_swap_queue_depth").set(
            float(sum(1 for op in self._buf_op if op is not None)))

    def _submit_read(self, b: int, slot: int):
        """pread submission through the shared retry policy + the
        ``slot_store.read`` fault site. Submission failures (bad fd,
        queue full → EAGAIN/EBUSY, injected faults) are the retriable
        surface; completion errors surface in wait_op."""
        def _do():
            get_fault_injector().check("slot_store.read", path=self.path)
            return self.aio.pread(self._bufs[b].array, self.path,
                                  slot * self.stride)
        with trace_span("swap/read_submit", slot=slot):
            return self._submit_with_retry(
                b, _do, f"nvme slot read [{self.path}:{slot}]")

    def _submit_write(self, b: int, slot: int):
        def _do():
            get_fault_injector().check("slot_store.write", path=self.path)
            return self.aio.pwrite(self._bufs[b].array, self.path,
                                   slot * self.stride)
        with trace_span("swap/write_submit", slot=slot):
            return self._submit_with_retry(
                b, _do, f"nvme slot write [{self.path}:{slot}]")

    # -- API --------------------------------------------------------------
    def prefetch(self, slot: int) -> None:
        with self._lock:
            if slot in self._slot_buf:
                return
            b = self._free_buf()
            if slot in self._slot_buf:
                # _free_buf's cond.wait releases the lock — another thread
                # may have mapped this slot meanwhile; keep its mapping
                # (buffer b stays unpinned/unmapped for the next scan)
                return
            op = self._submit_read(b, slot)
            if slot in self._slot_buf:
                # the retry backoff also releases the lock: a peer mapped
                # this slot while we were sleeping. Keep theirs; register
                # our duplicate read on b (so _free_buf drains it before
                # reuse) but leave b unmapped.
                self._buf_op[b] = op
                self._observe_depth()
                return
            self._buf_op[b] = op
            self._buf_slot[b] = slot
            self._slot_buf[slot] = b
            self._observe_depth()

    def acquire(self, slot: int) -> np.ndarray:
        with self._lock:
            if slot not in self._slot_buf:
                self.prefetch(slot)
            b = self._slot_buf[slot]
            self._buf_pins[b] += 1
            self._wait_buf(b)  # finish the read (or a previous writeback)
            return self._bufs[b].array[:self.slot_nbytes]

    def release(self, slot: int, dirty: bool = False) -> None:
        with self._lock:
            b = self._slot_buf.get(slot)
            if b is None:
                return
            if self._buf_pins[b] > 0:
                self._buf_pins[b] -= 1
                if self._buf_pins[b] == 0:
                    self._cond.notify_all()
            if dirty:
                self._buf_op[b] = self._submit_write(b, slot)
                self._observe_depth()
            # buffer stays mapped (clean cache) until the ring reclaims it

    def flush(self) -> None:
        # wait + clear under ONE critical section: with the wait outside
        # the lock, a concurrent release() could submit a writeback
        # between the wait and the clear — flush would then None out an
        # op id that was never waited on, and _free_buf could recycle
        # that buffer while its write is still in flight.  Ops already
        # submitted complete independently of this lock, so holding it
        # across the wait cannot deadlock.
        with self._lock:
            self.aio.wait()
            self._buf_op = [None] * len(self._bufs)

    def close(self) -> None:
        with self._lock:
            # Teardown is ONE critical section (the RLock lets flush()
            # nest inside it): a separately-locked flush would leave an
            # unlock window where a racing release() submits a fresh
            # writeback and b.free() hands the native IO thread freed
            # memory. Before draining, WAIT (bounded) for outstanding
            # pins: a peer parked in the retry backoff (cond.wait drops
            # the lock mid-submission) still owns its buffer and will
            # resubmit into it on wake — freeing under it would be a
            # use-after-free. Its release notifies the condition. A pin
            # that never drains is an acquire/release imbalance; close
            # stays a forgiving teardown API (it may run during
            # exception cleanup) and proceeds with a loud warning.
            deadline = time.monotonic() + self.CLOSE_PIN_WAIT_TIMEOUT
            while any(p > 0 for p in self._buf_pins):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    logger.warning(
                        f"NvmeSlotStore.close with "
                        f"{sum(1 for p in self._buf_pins if p > 0)} "
                        f"buffer(s) still acquired after "
                        f"{self.CLOSE_PIN_WAIT_TIMEOUT:.0f}s — "
                        f"acquire/release imbalance; outstanding views "
                        f"dangle after free")
                    break
                self._cond.wait(min(remaining, 1.0))
            self.flush()
            if self._own_aio:
                self.aio.close()
            self._unlock()
            for b in self._bufs:
                b.free()
            self._bufs = []

    @property
    def host_bytes(self) -> int:
        return sum(b.nbytes for b in self._bufs)

    @property
    def disk_bytes(self) -> int:
        return self.stride * self.n_slots


def make_slot_store(device: str, n_slots: int, slot_nbytes: int,
                    nvme_path: Optional[str] = None,
                    aio: Optional[AsyncIOHandle] = None,
                    buffer_count: int = 4, name: str = "slots",
                    io_policy=None) -> SlotStore:
    """Factory keyed on the offload device enum ('cpu' → DRAM tier,
    'nvme' → file tier).  ``io_policy`` overrides the store's transient
    retry schedule (None keeps the resilience DEFAULT_IO_POLICY)."""
    if device == "nvme":
        if not nvme_path:
            raise ValueError("offload device=nvme requires nvme_path")
        store: SlotStore = NvmeSlotStore(
            n_slots, slot_nbytes, os.path.join(nvme_path, f"{name}.swp"),
            aio=aio, buffer_count=buffer_count, name=name)
    else:
        store = DramSlotStore(n_slots, slot_nbytes)
    if io_policy is not None:
        store.io_policy = io_policy
    return store

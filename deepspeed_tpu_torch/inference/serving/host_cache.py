"""Host-tier prefix cache: evicted KV blocks spill to DRAM/NVMe slots.

Copy of ``deepspeed_tpu/inference/serving/host_cache.py`` for the PyTorch
port.  With the tier attached, the :mod:`block_allocator`'s LRU eviction
becomes a *demotion*: instead of forgetting a refcount-0 registered
block, the engine encodes it through the wire codec and parks the bytes
here, keyed by the SAME chained content digest that keys the radix
index.  A later prefix hit on a spilled chain finds the digest here and
promotes the block back into the pool — a host->device copy instead of a
prefill recompute.  The storage is the ``runtime/swap_tensor`` slot
stores (``DramSlotStore`` and the ``NvmeSlotStore`` aligned-buffer ring
over ``csrc/aio.cpp``, with retry and backoff).

Correctness: the lookup key IS the chain hash (blake2b-128 over the
block's tokens AND its prefix's digest), so a host hit is
content-verified against its chain parent by construction.  Invariants
(:meth:`HostTierCache.assert_consistent`): a digest is resident in AT
MOST one tier and never both host-side and in the device radix index;
every tier slot is free or owned by exactly one digest.

The disaggregated fleet reuses this cache as the **KV fabric**: a
prefill worker publishes a finished chain (same digests, same codec
bytes, plus a crc32 and a publisher id), a decode replica claims it
through the ordinary promote path; a published entry that fails its crc
on claim is dropped and reads as a cold miss, and entries a dead or
drained publisher left behind are swept by
:meth:`HostTierCache.reap_orphans`.

The wire codec is numpy on the host, as in the JAX package: a KV block
is encoded without a device program.  What the port adds is the way in
and out of torch: ``BlockCodec`` takes the gathered block as CPU tensors
(or numpy arrays) and gives the decoded block back as CPU tensors of the
pool's dtype.  bfloat16 has no numpy dtype, so at wire 0 its bytes cross
as 16-bit integers, and at wire 8/4 it is quantized from float32 (exact)
and dequantized to float32, then rounded to bfloat16 to nearest even by
torch — the rounding ml_dtypes applies in the JAX codec — so the payload
bytes and the decoded values equal the JAX codec's.

Pure host code: counters are plain ints the serving engine polls into
the metrics registry; the fabric endpoints carry the
``serving.fabric.claim`` / ``serving.fabric.publish`` fault sites.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ...runtime.resilience.errors import FatalIOError, TransientIOError
from ...runtime.resilience.fault_injection import get_fault_injector
from ...runtime.swap_tensor.slot_store import SlotStore, make_slot_store
from .block_allocator import blocks_for_budget, kv_block_bytes

__all__ = ["BlockCodec", "HostTierCache", "host_block_bytes",
           "tiered_blocks_for_budget"]


# -- capacity planning (second tier over blocks_for_budget) ----------------

def host_block_bytes(num_layers: int, block_size: int, kv_heads: int,
                     head_dim: int, kv_bits: int = 0, wire_bits: int = 8,
                     cache_itemsize: int = 2) -> int:
    """Encoded bytes ONE pool block costs in a host-tier slot: all
    layers, k AND v, scale planes included, UNSHARDED kv heads (the
    host entry is the gathered global block even when the device pool
    shards heads over the model axis).  A quantized pool (``kv_bits``
    8/4) spills its int8/int4 bytes verbatim — compressed at rest for
    free; an unquantized pool is encoded at ``wire_bits`` (0 = raw
    dtype bytes).  Per-layer cost delegates to :func:`kv_block_bytes`
    so both tiers stay pinned to one formula."""
    at_rest_bits = kv_bits if kv_bits else wire_bits
    return num_layers * kv_block_bytes(block_size, kv_heads, head_dim,
                                       at_rest_bits, cache_itemsize)


def tiered_blocks_for_budget(hbm_budget_bytes: int, dram_budget_bytes: int,
                             nvme_budget_bytes: int, num_layers: int,
                             block_size: int, kv_heads: int, head_dim: int,
                             kv_bits: int = 0, wire_bits: int = 8,
                             cache_itemsize: int = 2,
                             model_shards: int = 1
                             ) -> Tuple[int, int, int]:
    """Capacity planning over the full hierarchy: ``(hbm_blocks,
    dram_blocks, nvme_blocks)``.  The HBM count is per-chip (same
    contract as :func:`blocks_for_budget`, including the null block);
    the host counts are whole-block slots at the host encoding — a
    pool block and its host entry are different sizes whenever the
    wire codec compresses or the mesh shards heads."""
    hbm = blocks_for_budget(hbm_budget_bytes, block_size, kv_heads,
                            head_dim, kv_bits, cache_itemsize, model_shards)
    entry = host_block_bytes(num_layers, block_size, kv_heads, head_dim,
                             kv_bits, wire_bits, cache_itemsize)
    return hbm, dram_budget_bytes // entry, nvme_budget_bytes // entry


# -- wire codec (numpy mirror of ops/quantizer kv_quantize) ----------------

def _np_kv_quantize(x: np.ndarray, num_bits: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of the quantizer's ``kv_quantize`` over float32 rows
    (per-row per-head symmetric scales, FEATURE-SPLIT int4 packing), so
    the host tier never runs a device program just to encode bytes."""
    d = x.shape[-1]
    qmax = 2.0 ** (num_bits - 1) - 1
    xf = x.astype(np.float32)
    scale = np.maximum(np.max(np.abs(xf), axis=-1) / qmax, 1e-8)
    q = np.clip(np.rint(xf / scale[..., None]), -qmax - 1, qmax)
    q = q.astype(np.int32)
    if num_bits == 4:
        lo, hi = q[..., :d // 2], q[..., d // 2:]
        q = (lo & 0xF) | ((hi & 0xF) << 4)
    return q.astype(np.int8), scale.astype(np.float32)


def _np_kv_dequantize(q: np.ndarray, scale: np.ndarray,
                      num_bits: int) -> np.ndarray:
    """float32 rows back from :func:`_np_kv_quantize`'s bytes."""
    x = q.astype(np.int32)
    if num_bits == 4:
        lo = ((x & 0xF) ^ 8) - 8
        hi = x >> 4
        x = np.concatenate([lo, hi], axis=-1)
    return x.astype(np.float32) * scale[..., None]


#: the numpy dtype a pool dtype's bytes cross the host as (bfloat16, which
#: numpy lacks, as its 16-bit integer bits)
_NP_BITS = {torch.float32: np.float32, torch.float16: np.float16,
            torch.bfloat16: np.int16, torch.int8: np.int8}


def _bits(x, dtype: torch.dtype) -> np.ndarray:
    """``x`` (a tensor, or a numpy array of ``dtype``'s bits) as a
    contiguous numpy array of its bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.ascontiguousarray(x)


def _f32(x) -> np.ndarray:
    """``x``'s values widened to float32 on the host (exact from 16-bit
    floats)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x).astype(np.float32)


def _tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` over ``a``'s bits (no copy when ``a`` is
    writable)."""
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


class BlockCodec:
    """Encode/decode one pool block ``(k, v[, k_scale, v_scale])`` —
    shapes ``[L, block_size, kv_heads, d_eff]`` (+ ``[L, bs, kvh]``
    scales when the pool is quantized) — to/from one flat uint8 host
    payload, laid out ``k | v | k_scale | v_scale``.

    A quantized pool round-trips BYTE-EXACT (raw int8/int4 values + f32
    scale planes), which is what makes greedy streams token-identical
    across a spill/promote cycle at ``kv_cache_bits`` in (4, 8).  An
    unquantized pool (``dtype`` float32, bfloat16 or float16) is
    quantized on the way out at ``wire_bits`` (0 keeps the raw dtype
    bytes: lossless, 2-4x the host footprint).  :meth:`encode` takes CPU
    tensors (or numpy arrays of the dtype's bits); :meth:`decode` gives
    CPU tensors of the pool's dtypes."""

    def __init__(self, num_layers: int, block_size: int, kv_heads: int,
                 head_dim: int, kv_bits: int = 0, wire_bits: int = 8,
                 dtype: torch.dtype = torch.float32):
        if kv_bits not in (0, 4, 8):
            raise ValueError(f"kv_bits must be 0, 4 or 8, got {kv_bits}")
        if wire_bits not in (0, 4, 8):
            raise ValueError(f"wire_bits must be 0, 4 or 8, got {wire_bits}")
        if dtype not in _NP_BITS:
            raise ValueError(f"pool dtype {dtype} not in "
                             f"{sorted(map(str, _NP_BITS))}")
        self.num_layers = num_layers
        self.block_size = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.kv_bits = kv_bits
        self.wire_bits = wire_bits
        self.dtype = torch.int8 if kv_bits else dtype
        #: bits of the host representation: a quantized pool spills its
        #: own encoding verbatim; a raw pool encodes at wire_bits
        self.at_rest_bits = kv_bits if kv_bits else wire_bits
        if self.at_rest_bits == 4 and head_dim % 2:
            raise ValueError(f"packed int4 needs an even head_dim, "
                             f"got {head_dim}")
        rows = num_layers * block_size * kv_heads
        if self.at_rest_bits == 0:
            itemsize = torch.empty((), dtype=self.dtype).element_size()
            self._values_nbytes = rows * head_dim * itemsize
            self._scales_nbytes = 0
        else:
            d_eff = head_dim if self.at_rest_bits == 8 else head_dim // 2
            self._values_nbytes = rows * d_eff
            self._scales_nbytes = rows * 4
        self.nbytes = 2 * (self._values_nbytes + self._scales_nbytes)

    def _vshape(self) -> Tuple[int, int, int, int]:
        d_eff = (self.head_dim if self.at_rest_bits in (0, 8)
                 else self.head_dim // 2)
        return (self.num_layers, self.block_size, self.kv_heads, d_eff)

    def _sshape(self) -> Tuple[int, int, int]:
        return (self.num_layers, self.block_size, self.kv_heads)

    @staticmethod
    def _raw(a: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(a).view(np.uint8).ravel()

    def encode(self, k, v, k_scale=None, v_scale=None) -> np.ndarray:
        """``uint8[nbytes]`` payload, layout ``k | v | k_scale |
        v_scale``.  For a quantized pool k/v are the pool's int8 bytes
        and the scale planes are REQUIRED; for a raw pool they must be
        absent and are derived here when ``wire_bits`` compresses."""
        if self.kv_bits:
            if k_scale is None or v_scale is None:
                raise ValueError("quantized pool spill needs scale planes")
            qk, qv = _bits(k, torch.int8), _bits(v, torch.int8)
            sk, sv = _f32(k_scale), _f32(v_scale)
        elif self.wire_bits:
            qk, sk = _np_kv_quantize(_f32(k), self.wire_bits)
            qv, sv = _np_kv_quantize(_f32(v), self.wire_bits)
        else:
            out = np.concatenate([self._raw(_bits(k, self.dtype)),
                                  self._raw(_bits(v, self.dtype))])
            assert out.nbytes == self.nbytes
            return out
        out = np.concatenate([self._raw(qk), self._raw(qv),
                              self._raw(sk), self._raw(sv)])
        assert out.nbytes == self.nbytes
        return out

    def decode(self, payload: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Inverse of :meth:`encode`: ``(k, v, k_scale, v_scale)`` as CPU
        tensors in the POOL's representation — int8 values + f32 scales
        for a quantized pool (scatter them verbatim), pool-dtype floats
        (and ``None`` scales) for a raw pool."""
        buf = np.asarray(payload, np.uint8).ravel()[:self.nbytes]
        if buf.nbytes != self.nbytes:
            raise ValueError(f"host payload {buf.nbytes} B, codec "
                             f"expects {self.nbytes} B")
        vn, sn = self._values_nbytes, self._scales_nbytes
        if self.at_rest_bits == 0:
            bits = _NP_BITS[self.dtype]
            k = buf[:vn].view(bits).reshape(self._vshape())
            v = buf[vn:2 * vn].view(bits).reshape(self._vshape())
            return _tensor(k, self.dtype), _tensor(v, self.dtype), None, None
        qk = buf[:vn].view(np.int8).reshape(self._vshape())
        qv = buf[vn:2 * vn].view(np.int8).reshape(self._vshape())
        sk = buf[2 * vn:2 * vn + sn].view(np.float32).reshape(self._sshape())
        sv = buf[2 * vn + sn:].view(np.float32).reshape(self._sshape())
        if self.kv_bits:
            return (_tensor(qk, torch.int8), _tensor(qv, torch.int8),
                    _tensor(sk, torch.float32), _tensor(sv, torch.float32))
        # float32 values rounded to the pool's dtype to nearest even
        k = torch.from_numpy(_np_kv_dequantize(qk, sk, self.wire_bits))
        v = torch.from_numpy(_np_kv_dequantize(qv, sv, self.wire_bits))
        return k.to(self.dtype), v.to(self.dtype), None, None


# -- the tiered store ------------------------------------------------------

class _Tier:
    """One host tier: a slot store plus the digest->slot map in LRU
    order and the free-slot list (LIFO, same warm-page rationale as
    the allocator's free list)."""

    __slots__ = ("name", "store", "free_slots", "lru")

    def __init__(self, name: str, store: SlotStore, n_slots: int):
        self.name = name
        self.store = store
        self.free_slots: List[int] = list(range(n_slots - 1, -1, -1))
        self.lru: "OrderedDict[bytes, int]" = OrderedDict()


class HostTierCache:
    """Digest-keyed cache of encoded KV blocks over DRAM (+ optional
    NVMe behind it).  Fixed-size entries (``entry_nbytes`` from
    :class:`BlockCodec`), demand-paged hierarchy: spills land in DRAM;
    a full DRAM demotes ITS oldest entry to NVMe; a full NVMe drops
    its oldest — the cold tail ages out of the machine entirely.

    Ownership protocol: a hit calls :meth:`claim`, which REMOVES the
    entry and hands the payload to the caller — the digest is then "in
    flight" toward the device pool, resident in neither tier, which
    keeps the cross-tier disjointness invariant airtight at every op
    boundary.  A cancelled promotion gives the bytes back via
    :meth:`release_claim`."""

    def __init__(self, entry_nbytes: int, dram_slots: int,
                 nvme_slots: int = 0, nvme_path: Optional[str] = None,
                 io_policy=None, buffer_count: int = 4,
                 name: str = "kv_host_cache"):
        if entry_nbytes < 1:
            raise ValueError(f"entry_nbytes must be >= 1, got {entry_nbytes}")
        if dram_slots < 0 or nvme_slots < 0:
            raise ValueError("tier slot counts must be >= 0")
        if dram_slots == 0 and nvme_slots == 0:
            raise ValueError("host cache needs at least one tier slot")
        self.entry_nbytes = entry_nbytes
        self._tiers: List[_Tier] = []
        if dram_slots:
            self._tiers.append(_Tier(
                "dram", make_slot_store("cpu", dram_slots, entry_nbytes),
                dram_slots))
        if nvme_slots:
            self._tiers.append(_Tier(
                "nvme", make_slot_store("nvme", nvme_slots, entry_nbytes,
                                        nvme_path=nvme_path,
                                        buffer_count=buffer_count,
                                        io_policy=io_policy, name=name),
                nvme_slots))
        # fabric bookkeeping: digests pushed by a prefill publisher and
        # not yet claimed, with (publisher, crc32) for integrity + reaping
        self._published: Dict[bytes, Tuple[Optional[str], int]] = {}
        # cumulative stats, engine-polled (plain ints, no obs imports)
        self.spills_total = 0        # blocks demoted out of HBM into here
        self.demotions_total = 0     # dram -> nvme pressure moves
        self.evictions_total = 0     # aged out of the machine entirely
        self.published_total = 0     # fabric publishes (distinct inserts)
        self.orphans_reaped_total = 0    # published-never-claimed sweeps
        self.corrupt_dropped_total = 0   # crc mismatch on claim -> dropped
        self.claim_faults_total = 0      # injected/IO claim failures
        self.hits_total: Dict[str, int] = {t.name: 0 for t in self._tiers}

    # -- introspection ----------------------------------------------------
    @property
    def tier_names(self) -> List[str]:
        return [t.name for t in self._tiers]

    def resident_entries(self, tier: str) -> int:
        return len(self._tier(tier).lru)

    def resident_bytes(self, tier: str) -> int:
        return len(self._tier(tier).lru) * self.entry_nbytes

    def digests(self) -> Set[bytes]:
        out: Set[bytes] = set()
        for t in self._tiers:
            out |= set(t.lru)
        return out

    def contains(self, digest: bytes) -> bool:
        return any(digest in t.lru for t in self._tiers)

    def _tier(self, name: str) -> _Tier:
        for t in self._tiers:
            if t.name == name:
                return t
        raise KeyError(f"no host tier named {name!r}")

    # -- write path -------------------------------------------------------
    def put(self, digest: bytes, payload: np.ndarray) -> None:
        """Spill one encoded block.  Re-putting a resident digest just
        refreshes its LRU position (content-addressed: the bytes are
        identical by construction)."""
        for t in self._tiers:
            if digest in t.lru:
                t.lru.move_to_end(digest)
                return
        self.spills_total += 1
        self._insert(0, digest, payload)

    def publish(self, digest: bytes, payload: np.ndarray,
                publisher: Optional[str] = None) -> None:
        """Fabric write: a prefill worker pushes one finished chain
        block for a decode replica to claim.  Identical storage path to
        :meth:`put`, plus a crc32 fingerprint verified at claim time and
        a publisher id so :meth:`reap_orphans` can sweep what a dead
        worker left behind.  The ``serving.fabric.publish`` fault site
        fires BEFORE any state mutation — a faulted publish leaves the
        fabric exactly as it was and the caller degrades to decode-side
        recompute."""
        get_fault_injector().check("serving.fabric.publish")
        crc = zlib.crc32(np.asarray(payload, np.uint8).tobytes())
        for t in self._tiers:
            if digest in t.lru:              # refresh + re-mark published
                t.lru.move_to_end(digest)
                self._published[digest] = (publisher, crc)
                return
        self.published_total += 1
        self._published[digest] = (publisher, crc)
        self._insert(0, digest, payload)

    def release_claim(self, digest: bytes, payload: np.ndarray) -> None:
        """A claimed promotion was cancelled before landing (request
        freed / preempted mid-admission): give the bytes back so the
        prefix stays warm.  Not counted as a spill."""
        if self.contains(digest):            # re-spilled meanwhile
            return
        self._insert(0, digest, payload)

    def _insert(self, tier_idx: int, digest: bytes,
                payload: np.ndarray) -> None:
        """Insert into tier ``tier_idx``, rippling evictions down the
        hierarchy: a full tier demotes its LRU entry to the next tier;
        the last tier's LRU entry is dropped."""
        if tier_idx >= len(self._tiers):
            self.evictions_total += 1        # nowhere colder to go
            self._published.pop(digest, None)
            return
        t = self._tiers[tier_idx]
        if not t.free_slots:
            victim_digest, victim_slot = t.lru.popitem(last=False)
            victim_payload = t.store.read_slot(victim_slot,
                                               self.entry_nbytes)
            t.free_slots.append(victim_slot)
            if tier_idx + 1 < len(self._tiers):
                self.demotions_total += 1
            self._insert(tier_idx + 1, victim_digest, victim_payload)
        slot = t.free_slots.pop()
        t.store.write_slot(slot, np.asarray(payload, np.uint8))
        t.lru[digest] = slot

    # -- read path --------------------------------------------------------
    def claim(self, digest: bytes) -> Optional[np.ndarray]:
        """Remove ``digest``'s entry and return its payload (None on
        miss).  The caller owns the bytes until they land in the pool
        (then simply dropped) or the promotion is cancelled
        (:meth:`release_claim`).

        Failure semantics make every fabric fault indistinguishable
        from a cold miss: a transient fault on the
        ``serving.fabric.claim`` site returns None and leaves the entry
        resident (a later claim may succeed); a fatal fault discards
        the entry AND returns None, so a suspect payload is never
        served — the caller recomputes.  A published entry whose crc32
        no longer matches its payload is likewise dropped, counted, and
        reported as a miss."""
        try:
            get_fault_injector().check("serving.fabric.claim")
        except TransientIOError:
            self.claim_faults_total += 1
            return None
        except FatalIOError:
            self.claim_faults_total += 1
            self.discard(digest)
            return None
        for t in self._tiers:
            slot = t.lru.pop(digest, None)
            if slot is not None:
                payload = t.store.read_slot(slot, self.entry_nbytes)
                t.free_slots.append(slot)
                pub = self._published.pop(digest, None)
                if (pub is not None
                        and zlib.crc32(payload.tobytes()) != pub[1]):
                    self.corrupt_dropped_total += 1
                    return None              # already removed: cold miss
                self.hits_total[t.name] += 1
                return payload
        return None

    def discard(self, digest: bytes) -> bool:
        """Drop an entry without reading it — the device radix index
        re-registered this digest (a sibling recomputed the same
        content), so the host copy is redundant; dropping it keeps the
        device/host residency disjoint."""
        self._published.pop(digest, None)
        for t in self._tiers:
            slot = t.lru.pop(digest, None)
            if slot is not None:
                t.free_slots.append(slot)
                return True
        return False

    # -- fabric bookkeeping -----------------------------------------------
    def published_entries(self, publisher: Optional[str] = None) -> int:
        """Published-and-not-yet-claimed entry count (for one publisher,
        or fabric-wide) — nonzero after a drain means orphans leaked."""
        return sum(1 for p, _ in self._published.values()
                   if publisher is None or p == publisher)

    def reap_orphans(self, publisher: Optional[str] = None) -> int:
        """Sweep published entries nobody claimed — the debris a prefill
        worker leaves when it dies or drains mid-handoff.  Publishes are
        prefix-contiguous per chain, so an orphan is never a half-written
        claimable entry, just unreferenced bytes; reaping frees the
        slots and a decode replica that still wanted the chain sees a
        cold miss and recomputes."""
        victims = [d for d, (p, _) in self._published.items()
                   if publisher is None or p == publisher]
        reaped = 0
        for d in victims:
            if self.discard(d):
                reaped += 1
        self.orphans_reaped_total += reaped
        return reaped

    # -- invariants / teardown --------------------------------------------
    def assert_consistent(self,
                          device_digests: Optional[Set[bytes]] = None
                          ) -> None:
        """Slot accounting and cross-tier disjointness; with
        ``device_digests`` (the allocator's registered hashes) also the
        hierarchy-wide rule that a digest lives in at most one place.
        Published (fabric-transport) entries are exempt from the
        device/host cross-check: a publisher's copy intentionally
        coexists with device copies on OTHER replicas until claimed,
        and content addressing makes the bytes identical by
        construction — the spill/promote disjointness that guards
        single-replica bookkeeping still holds for every non-published
        entry."""
        seen: Dict[bytes, str] = {}
        for t in self._tiers:
            n_slots = t.store.n_slots
            used = list(t.lru.values())
            if len(set(used)) != len(used):
                raise AssertionError(f"{t.name}: duplicate slot ownership")
            if set(used) & set(t.free_slots):
                raise AssertionError(f"{t.name}: slot both free and owned")
            if len(used) + len(t.free_slots) != n_slots:
                raise AssertionError(
                    f"{t.name}: {len(used)} used + {len(t.free_slots)} "
                    f"free != {n_slots} slots")
            for d in t.lru:
                if d in seen:
                    raise AssertionError(
                        f"digest resident in both {seen[d]} and {t.name}")
                seen[d] = t.name
        dangling = set(self._published) - set(seen)
        if dangling:
            raise AssertionError(
                f"{len(dangling)} published digest(s) tracked but not "
                f"resident in any tier")
        if device_digests is not None:
            both = (set(seen) - set(self._published)) & device_digests
            if both:
                raise AssertionError(
                    f"{len(both)} digest(s) resident both host-side and "
                    f"in the device radix index")

    def close(self) -> None:
        for t in self._tiers:
            t.store.close()

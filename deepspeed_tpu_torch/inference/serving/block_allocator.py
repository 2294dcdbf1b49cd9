"""Paged KV-cache block allocator (host side) with prefix caching.

The bookkeeping half of PagedAttention (Kwon et al., SOSP '23): device
HBM holds one preallocated pool of fixed-size KV blocks
(``models/transformer.py init_paged_cache``); this allocator hands
block ids to sequences and keeps the pool leak-free.  Everything here is
pure Python over integers — no device code, so the policy is
unit-testable at property-test speed and the scheduler can ask "does
this admission fit" without touching the device.

Prefix caching (RadixAttention-style, SGLang / vLLM automatic prefix
caching): FULL blocks are content-addressed by a hash chained over the
block's token ids and its prefix's hash, so two sequences that share a
prefix (system prompts, few-shot templates, a preempted request
resubmitting its own history) resolve to the SAME pool blocks and skip
prefill for everything but their uncached tail.  A freed block whose
content is registered does not return to the raw free list — it parks
in an LRU of refcount-0 *cached* blocks that still serve hits until
capacity pressure evicts them (oldest first).  The chain property means
a hit walk stops at the first miss, so a stale child entry whose parent
was evicted is unreachable, never wrong.

Invariants (``assert_consistent`` checks them, tests fuzz them):

  * block 0 is RESERVED (the null block): padded block-table entries and
    inactive decode slots point at it so the kernel's index_map always
    lands on valid memory; it is never handed out and never freed.
  * every other block is, at all times, exactly one of: on the free
    list, parked in the cached-LRU (refcount 0, hash-registered), or
    referenced by >= 1 sequences (refcount > 1 through prefix-cache
    hits).
  * ``free``/``allocate`` raise :class:`BlockPoolError` on double-free,
    unknown sequence ids, and exhaustion — a serving scheduler bug
    surfaces as a loud error, not a silently corrupted cache.

Tiered host cache: with
:meth:`PagedBlockAllocator.attach_host_tier` wired, eviction becomes
*demotion* — the LRU walk in :meth:`_pop_block` hands the dying
block's bytes to the engine's spill callback (keyed by the same chain
digest) before unregistering it, and the :meth:`allocate` hit walk
extends past the device index into the host tier: a host hit claims a
pool block immediately, registers the digest, and queues a *promotion
job* (the encoded payload, engine-drained asynchronously during the
admission/prefill window).  Until the payload lands the block is
*pending*: refcounted and registered like any hit, but its pool bytes
are garbage — the scheduler must not prefill past it
(:meth:`seq_has_pending`), and a cancel (free/preempt before landing)
returns the bytes to the host tier, never the block to the cached LRU.

Copy of ``deepspeed_tpu/inference/serving/block_allocator.py`` for the
PyTorch port, without copy-on-write ``fork`` (no serving path of the
port forks a sequence); the capacity-planning helpers take one model
shard.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ...runtime.resilience.errors import ServingError
from ...runtime.resilience.fault_injection import get_fault_injector

NULL_BLOCK = 0

#: chain root: the "hash" of the empty prefix
ROOT_HASH = b""

#: bytes of each per-row per-head dequant scale (f32) stored alongside
#: a quantized pool block
_SCALE_BYTES = 4


def kv_block_bytes(block_size: int, kv_heads: int, head_dim: int,
                   kv_bits: int = 0, cache_itemsize: int = 2,
                   model_shards: int = 1) -> int:
    """Per-rank device bytes one pool block costs across k AND v,
    including the per-row per-head f32 scales a quantized pool stores
    alongside (``serving.kv_cache_bits``).  ``cache_itemsize`` is the
    unquantized pool's dtype width (2 = bf16).  ``model_shards`` is the
    serving mesh's model-axis size: each rank then holds ``kv_heads /
    model_shards`` of every block (scale planes included); the data axis
    replicates the pool and changes nothing here.  Pure ints: the
    capacity-planning mirror of ``TransformerLM.init_paged_cache``."""
    if kv_bits not in (0, 4, 8):
        raise ValueError(f"kv_bits must be 0, 4 or 8, got {kv_bits}")
    if model_shards < 1 or kv_heads % model_shards:
        raise ValueError(
            f"model_shards ({model_shards}) must be >= 1 and divide "
            f"kv_heads ({kv_heads})")
    kv_heads //= model_shards
    if kv_bits == 0:
        per_row = kv_heads * head_dim * cache_itemsize
    else:
        values = kv_heads * ((head_dim * kv_bits + 7) // 8)
        per_row = values + kv_heads * _SCALE_BYTES
    return 2 * block_size * per_row          # k + v


def blocks_for_budget(budget_bytes: int, block_size: int, kv_heads: int,
                      head_dim: int, kv_bits: int = 0,
                      cache_itemsize: int = 2,
                      model_shards: int = 1) -> int:
    """Pool blocks (INCLUDING the reserved null block 0) a per-rank
    device memory budget admits at the given KV width: the same budget
    holds ~2x the blocks at 8-bit and ~3.8x at packed 4-bit, and
    ``model_shards`` x the blocks on a model-sharded mesh."""
    return budget_bytes // kv_block_bytes(block_size, kv_heads, head_dim,
                                          kv_bits, cache_itemsize,
                                          model_shards)


class BlockPoolError(ServingError):
    """Allocator invariant violation (double free, exhaustion, unknown
    sequence) — scheduler bugs, never user input.  Part of the
    resilience layer's :class:`ServingError` branch."""


class PromoteJob:
    """One queued host->device block promotion: the claimed pool block,
    the chain digest that keyed the host hit, and the encoded payload
    the engine must decode + scatter into the pool."""

    __slots__ = ("digest", "block", "payload")

    def __init__(self, digest: bytes, block: int, payload):
        self.digest = digest
        self.block = block
        self.payload = payload


def _chain_hash(prev: bytes, token_ids: Tuple[int, ...]) -> bytes:
    """Content hash of one full block, chained on its prefix's hash —
    equal prefixes produce equal chains, the radix-tree property
    flattened into a dict.  blake2b (not Python's builtin ``hash``)
    because a hit is trusted WITHOUT comparing tokens: the builtin
    tuple hash is 64-bit and its collisions are offline-constructible,
    which would let one request's chain resolve to another prompt's KV
    blocks — served-wrong-tokens corruption, not a missed reuse.  A
    128-bit keyed-construction digest makes that a non-event."""
    h = hashlib.blake2b(prev, digest_size=16)
    for t in token_ids:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.digest()


class PagedBlockAllocator:
    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved null "
                f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        # LIFO free list: recently-freed blocks are re-handed first (their
        # pool pages are the likeliest still warm in any cache hierarchy)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = [0] * num_blocks
        self._tables: Dict[str, List[int]] = {}
        # prefix cache: chained content hash -> block id, and the reverse
        # map used to unregister on eviction/recycle
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_hash: List[Optional[bytes]] = [None] * num_blocks
        # per-sequence chain hashes of its full blocks, in order —
        # extended incrementally by allocate()'s hit walk and
        # commit_cached(), so neither ever rehashes from the root
        # (an O(len²) trap: the engine commits at EVERY block boundary)
        self._chain: Dict[str, List[bytes]] = {}
        # refcount-0 blocks whose content is still registered: insertion
        # order == least-recently-used first (move_to_end on every hit)
        self._cached_lru: "OrderedDict[int, None]" = OrderedDict()
        # tiered host cache (attach_host_tier): spilled-block store,
        # the engine's spill callback, and promotion bookkeeping —
        # blocks claimed by a host hit whose payload has not landed yet
        self._host = None
        self._spill_fn = None
        # prefill-class engines publish chains to the fabric but never
        # claim from it (claiming would steal entries the decode class
        # is about to promote); the engine flips this per role
        self.allow_claims = True
        self._pending_blocks: Dict[int, bytes] = {}
        self._promote_jobs: "OrderedDict[bytes, PromoteJob]" = OrderedDict()
        # cumulative stats the serving engine polls into the metrics
        # registry (counters there, plain ints here — no obs import)
        self.hit_tokens_total = 0
        self.evictions_total = 0
        self.host_hit_tokens_total = 0

    # -- capacity ----------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        """Pool capacity available to sequences (excludes the null block)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        """Blocks allocatable right now: the raw free list plus the
        refcount-0 cached blocks (a cached block is capacity first,
        cache second — allocation evicts it)."""
        return len(self._free) + len(self._cached_lru)

    @property
    def num_cached(self) -> int:
        """Refcount-0 blocks currently parked in the prefix-cache LRU."""
        return len(self._cached_lru)

    @property
    def num_used(self) -> int:
        """Blocks referenced by live sequences (cached-LRU blocks are
        reclaimable, so they do not count as used)."""
        return self.usable_blocks - self.num_free

    def blocks_for_tokens(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` cache rows (>= 1)."""
        return max(1, -(-tokens // self.block_size))

    def can_allocate(self, n_blocks: int) -> bool:
        return self.num_free >= n_blocks

    # -- host tier ---------------------------------------------------------
    def attach_host_tier(self, host_cache, spill_fn) -> None:
        """Wire the tiered host cache in (engine-owned: pools must
        exist before the spill/promote data paths do, so this is a
        post-construction attach).  ``spill_fn(block, digest)`` is
        called for every registered block the LRU evicts, BEFORE its
        registration drops; it must never raise — a failed spill
        degrades to a plain eviction inside the engine."""
        self._host = host_cache
        self._spill_fn = spill_fn

    def _claim_host_hit(self, h: bytes) -> Optional[int]:
        """Extend the hit walk into the host tier: claim the encoded
        payload out of the host cache, claim a pool block for it, and
        queue the promotion.  Returns the (pending) block id, or None
        on a genuine miss / no pool capacity (the entry then stays
        host-resident and warm — a miss, never an error)."""
        if not self.allow_claims:
            return None
        if self._host is None or not self._host.contains(h):
            return None
        if not (self._free or self._cached_lru):
            return None
        payload = self._host.claim(h)
        if payload is None:
            return None
        b = self._pop_block()
        self._ref[b] = 1
        self._block_hash[b] = h
        self._hash_to_block[h] = b
        self._pending_blocks[b] = h
        self._promote_jobs[h] = PromoteJob(h, b, payload)
        return b

    def _drop_host_duplicate(self, h: bytes) -> None:
        """A device hit on a digest the host tier also holds: the host
        copy is redundant (a prefill publisher may have republished
        content this replica never evicted) — drop it eagerly so the
        cross-tier disjointness self-heals instead of waiting for an
        orphan sweep."""
        if self._host is not None:
            self._host.discard(h)

    def seq_chain(self, seq_id: str) -> List[bytes]:
        """The chained content digests of ``seq_id``'s committed full
        blocks, in block order — the transport keys a prefill worker
        publishes to the KV fabric (digest i keys ``table[i]``)."""
        return list(self._chain.get(seq_id, ()))

    def pending_jobs(self) -> List[PromoteJob]:
        """Queued promotions, oldest first (the engine drains up to
        ``promote_parallelism`` per step)."""
        return list(self._promote_jobs.values())

    @property
    def num_pending(self) -> int:
        return len(self._promote_jobs)

    def seq_has_pending(self, seq_id: str) -> bool:
        """True while any block in ``seq_id``'s table awaits its
        promotion payload — the scheduler's PROMOTING predicate: the
        request must not prefill (its compiled gather would read
        garbage rows) until this turns False."""
        table = self._tables.get(seq_id)
        if table is None:
            return False
        return any(b in self._pending_blocks for b in table)

    def promotion_landed(self, digest: bytes) -> None:
        """The engine scattered the payload into the pool: the block
        graduates to a normal registered, refcounted block."""
        job = self._promote_jobs.pop(digest, None)
        if job is not None:
            self._pending_blocks.pop(job.block, None)

    def promotion_failed(self, digest: bytes) -> List[Tuple[str, int]]:
        """The payload could not be landed (fatal fault / exhausted
        retries): drop the job AND the registration — the block's pool
        bytes are garbage, so it must never serve a future hit — and
        report every ``(seq_id, block_index)`` holding it so the
        engine can roll those requests back to recompute.  The host
        entry stays dropped (it was claimed): never a wrong block,
        recompute rewrites identical content."""
        job = self._promote_jobs.pop(digest, None)
        if job is None:
            return []
        self._pending_blocks.pop(job.block, None)
        self._unregister(job.block)
        affected: List[Tuple[str, int]] = []
        for seq, table in self._tables.items():
            for i, b in enumerate(table):
                if b == job.block:
                    affected.append((seq, i))
        return affected

    def _cancel_pending(self, block: int) -> None:
        """A pending block's last reference dropped before its payload
        landed: unregister it, give the payload back to the host tier
        (the prefix stays warm), and return the block to the RAW free
        list — un-landed pool bytes must never park in the cached LRU
        where they could be spilled or hit."""
        h = self._pending_blocks.pop(block)
        job = self._promote_jobs.pop(h, None)
        self._unregister(block)
        if job is not None and self._host is not None:
            self._host.release_claim(h, job.payload)
        self._free.append(block)

    # -- internal: free-list / LRU plumbing --------------------------------
    def _pop_block(self) -> int:
        """Claim one block, always unregistered: the raw free list
        first (never holds registered blocks — `_release_block` parks
        those in the LRU), else evict the least-recently-used cached
        block, dropping its registration — the pool page is about to
        be overwritten."""
        if self._free:
            return self._free.pop()
        if self._cached_lru:
            b, _ = self._cached_lru.popitem(last=False)   # LRU end
            h = self._block_hash[b]
            if h is not None and self._spill_fn is not None:
                # demotion instead of amnesia: hand the block's bytes
                # to the engine's spill path (device gather -> wire
                # codec -> host tier) while the pool content is still
                # valid.  The callback handles its own faults — by
                # contract it never raises, so a failed spill degrades
                # to the plain eviction below.
                self._spill_fn(b, h)
            self._unregister(b)
            self.evictions_total += 1
            return b
        raise BlockPoolError("pool exhausted")

    def _unregister(self, block: int) -> None:
        h = self._block_hash[block]
        if h is not None:
            if self._hash_to_block.get(h) == block:
                del self._hash_to_block[h]
            self._block_hash[block] = None

    def _release_block(self, block: int) -> None:
        """Refcount hit zero: registered content parks in the cached
        LRU (most-recently-used end); unregistered blocks go straight
        back to the free list."""
        if self._block_hash[block] is not None:
            # fresh insertion lands at the MRU end (the block cannot
            # already be parked: it was refcounted until this call)
            self._cached_lru[block] = None
        else:
            self._free.append(block)

    def _claim_cached(self, block: int) -> None:
        """A cache hit revives a parked block: out of the LRU, refcount
        1, registration kept (it can be hit again while shared)."""
        del self._cached_lru[block]
        self._ref[block] = 1

    # -- alloc / grow / free ----------------------------------------------
    def allocate(self, seq_id: str, tokens: int,
                 token_ids: Optional[Sequence[int]] = None
                 ) -> Tuple[List[int], int]:
        """Claim blocks for ``tokens`` cache rows; returns
        ``(block_table, cached_tokens)``.

        With ``token_ids`` (the request's prefix) and prefix caching
        enabled, leading FULL blocks whose chained content hash is
        registered are shared by reference instead of allocated fresh —
        ``cached_tokens`` is the number of leading rows whose KV already
        sits in the pool, and the caller prefills only the tail.  At
        least one prefix token is always left to compute (the engine
        needs the last position's logits to sample), so
        ``cached_tokens < len(token_ids)`` whenever token_ids is given.
        """
        if seq_id in self._tables:
            raise BlockPoolError(f"sequence {seq_id!r} already has blocks")
        # injection site BEFORE any state mutation: a fault here leaves
        # the pool exactly as it was
        get_fault_injector().check("serving.allocate")
        need = self.blocks_for_tokens(tokens)
        # feasibility discounts hits on LIVE blocks (pure refcount
        # sharing, no free capacity consumed) — without this a shared
        # prefix larger than the free pool could never be re-allocated
        # even though allocation would barely touch the pool.  The
        # probe's hash walk only runs when the full demand does NOT
        # already fit (the unpressured common case skips it).
        fresh = need if self.can_allocate(need) else \
            self.probe_fresh_need(tokens, token_ids)
        if not self.can_allocate(fresh):
            raise BlockPoolError(
                f"pool exhausted: {seq_id!r} needs {need} blocks "
                f"({fresh} from free capacity), "
                f"{self.num_free} free of {self.usable_blocks}")
        blocks: List[int] = []
        cached_tokens = 0
        chain: List[bytes] = []
        if token_ids is not None and self.enable_prefix_cache:
            bs = self.block_size
            # only full blocks are content-addressed, and the LAST full
            # block is never taken from cache: its logits (or at least
            # one tail token's) must be computed
            max_hit_blocks = max(0, (len(token_ids) - 1) // bs)
            max_hit_blocks = min(max_hit_blocks, need)
            h = ROOT_HASH
            host_tokens = 0
            for i in range(max_hit_blocks):
                h = _chain_hash(h, tuple(token_ids[i * bs:(i + 1) * bs]))
                b = self._hash_to_block.get(h)
                if b is None:
                    # past the device index: the digest may live in the
                    # host tier — a hit there claims a pool block now
                    # and lands the bytes asynchronously (PromoteJob)
                    b = self._claim_host_hit(h)
                    if b is None:
                        break
                    host_tokens += bs
                elif self._ref[b] == 0:
                    self._claim_cached(b)
                    self._drop_host_duplicate(h)
                else:
                    self._ref[b] += 1
                    self._drop_host_duplicate(h)
                blocks.append(b)
                chain.append(h)
                cached_tokens += bs
            self.hit_tokens_total += cached_tokens - host_tokens
            self.host_hit_tokens_total += host_tokens
        while len(blocks) < need:
            b = self._pop_block()
            self._ref[b] = 1
            blocks.append(b)
        self._tables[seq_id] = blocks
        self._chain[seq_id] = chain
        return list(blocks), cached_tokens

    def probe_fresh_need(self, tokens: int,
                         token_ids: Optional[Sequence[int]] = None) -> int:
        """Free-capacity blocks :meth:`allocate` would actually consume
        for ``tokens`` rows — the admission-feasibility number.  Hits on
        LIVE blocks (refcount > 0) are pure sharing and consume nothing;
        hits on parked LRU blocks supply themselves (one unit of
        ``num_free`` each, same as a fresh block).  Without this the
        scheduler would demand free capacity for a whole shared prefix
        that allocation never takes from the pool, serializing admission
        in exactly the shared-prefix workload prefix caching targets."""
        need = self.blocks_for_tokens(tokens)
        if token_ids is None or not self.enable_prefix_cache:
            return need
        bs = self.block_size
        max_hit_blocks = min(max(0, (len(token_ids) - 1) // bs), need)
        h, live_hits = ROOT_HASH, 0
        for i in range(max_hit_blocks):
            h = _chain_hash(h, tuple(token_ids[i * bs:(i + 1) * bs]))
            b = self._hash_to_block.get(h)
            if b is None:
                break
            if self._ref[b] > 0:
                live_hits += 1
        return need - live_hits

    def probe_prefix_coverage(self, token_ids: Sequence[int],
                              split: bool = False):
        """READ-ONLY affinity probe for the fleet router: how many
        leading tokens of ``token_ids`` this pool (device radix index
        OR attached host tier) already covers, walking the same chained
        content digests :meth:`allocate`'s hit walk uses and stopping at
        the first miss.  Mutates nothing — no claims, no LRU touches,
        no promotions — so the fleet router may probe every replica per
        placement decision.

        With ``split=True`` returns ``(device_tokens, host_tokens)``
        instead of their sum, so the router can discount host-resident
        coverage by the promote cost: a block in the host tier saves
        the recompute but still pays a claim + host->device landing.
        Host residency only counts when this allocator may actually
        claim it (``allow_claims``)."""
        if not self.enable_prefix_cache or not token_ids:
            return (0, 0) if split else 0
        bs = self.block_size
        max_hit_blocks = max(0, (len(token_ids) - 1) // bs)
        h = ROOT_HASH
        dev_blocks = host_blocks = 0
        for i in range(max_hit_blocks):
            h = _chain_hash(h, tuple(token_ids[i * bs:(i + 1) * bs]))
            if h in self._hash_to_block:
                dev_blocks += 1
            elif (self.allow_claims and self._host is not None
                    and self._host.contains(h)):
                host_blocks += 1
            else:
                break
        if split:
            return dev_blocks * bs, host_blocks * bs
        return (dev_blocks + host_blocks) * bs

    def append_block(self, seq_id: str) -> int:
        """Grow a sequence by one block (decode crossed a block
        boundary); raises on exhaustion — the scheduler preempts and
        retries."""
        table = self._tables.get(seq_id)
        if table is None:
            raise BlockPoolError(f"unknown sequence {seq_id!r}")
        get_fault_injector().check("serving.append_block")
        if not self.can_allocate(1):
            raise BlockPoolError(
                f"pool exhausted growing {seq_id!r} "
                f"({len(table)} blocks held)")
        b = self._pop_block()
        self._ref[b] = 1
        table.append(b)
        return b

    def block_table(self, seq_id: str) -> List[int]:
        table = self._tables.get(seq_id)
        if table is None:
            raise BlockPoolError(f"unknown sequence {seq_id!r}")
        return list(table)

    def free(self, seq_id: str, discard: bool = False) -> None:
        """Release a sequence's blocks (finish or preemption). Shared
        blocks (fork / prefix hits) only leave the tables when the last
        reference drops; registered blocks park in the cached LRU
        instead of the free list so the prefix they hold stays hittable
        until capacity pressure evicts it.

        ``discard=True`` is the quarantine path: the sequence's KV
        content is SUSPECT (non-finite activations were detected), so
        every block it touched is unregistered from the prefix-cache
        index before release — refcount-0 blocks go straight to the raw
        free list, never to the cached LRU, and a live shared block
        (still refcounted by a sibling) keeps serving that sibling but
        can never be hit again."""
        table = self._tables.pop(seq_id, None)
        if table is None:
            raise BlockPoolError(
                f"free of unknown (or already-freed) sequence {seq_id!r}")
        self._chain.pop(seq_id, None)
        for b in table:
            if self._ref[b] <= 0:
                raise BlockPoolError(
                    f"double free of block {b} (sequence {seq_id!r})")
            if discard:
                self._unregister(b)
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if b in self._pending_blocks:
                    self._cancel_pending(b)
                else:
                    self._release_block(b)

    def commit_cached(self, seq_id: str, token_ids: Sequence[int],
                      upto_tokens: int) -> int:
        """Register the content of ``seq_id``'s FULL blocks whose rows
        are entirely below ``upto_tokens`` (rows the engine has actually
        written KV for).  ``token_ids`` are the tokens backing rows
        0..upto_tokens-1 (prompt + generated so far).  Idempotent; a
        hash already registered to another block keeps its first owner
        (byte-identical content, either block serves).  Returns the
        number of blocks newly registered."""
        if not self.enable_prefix_cache:
            return 0
        table = self._tables.get(seq_id)
        if table is None:
            raise BlockPoolError(f"unknown sequence {seq_id!r}")
        bs = self.block_size
        n_full = min(upto_tokens, len(token_ids)) // bs
        n_full = min(n_full, len(table))
        # resume from the sequence's recorded chain: blocks below
        # len(chain) were hashed by an earlier commit (or came in as
        # hits), so each commit call hashes only the NEWLY completed
        # blocks — O(tokens) per sequence overall, not O(tokens²)
        chain = self._chain.setdefault(seq_id, [])
        new = 0
        for i in range(len(chain), n_full):
            h = _chain_hash(chain[-1] if chain else ROOT_HASH,
                            tuple(token_ids[i * bs:(i + 1) * bs]))
            chain.append(h)
            b = table[i]
            if self._block_hash[b] == h:
                continue                       # already committed
            if h in self._hash_to_block:
                continue                       # duplicate content: first wins
            self._unregister(b)                # drop any stale hash
            self._block_hash[b] = h
            self._hash_to_block[h] = b
            if self._host is not None:
                # the digest just (re-)entered the device index — drop
                # any host copy so a digest is resident in exactly one
                # place in the whole hierarchy (same bytes either way:
                # content-addressed)
                self._host.discard(h)
            new += 1
        return new

    def is_cache_resident(self, seq_id: str, tokens: int) -> bool:
        """True when every FULL block of ``seq_id``'s first ``tokens``
        rows has its chain hash registered SOMEWHERE in the index —
        preempting this sequence costs only its tail recompute, because
        its prefix stays hittable (the scheduler's preferred-victim
        predicate).  Membership is by content, not by block: a sequence
        whose blocks duplicate an earlier owner's (first-owner-wins in
        :meth:`commit_cached`) is just as cheap to evict — its
        re-admission hits the owner's copy."""
        table = self._tables.get(seq_id)
        if table is None:
            raise BlockPoolError(f"unknown sequence {seq_id!r}")
        n_full = min(tokens // self.block_size, len(table))
        chain = self._chain.get(seq_id, [])
        if len(chain) < n_full:
            return False                       # uncommitted full blocks
        return all(chain[i] in self._hash_to_block for i in range(n_full))

    # -- leak check --------------------------------------------------------
    def assert_consistent(self) -> None:
        """Every usable block is exactly one of: free, cached-LRU-parked
        (refcount 0 + hash registered), or referenced; the null block is
        none of them; the hash index and its reverse map agree.  Raises
        BlockPoolError with the exact discrepancy — the tests' (and a
        draining server's) leak check."""
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise BlockPoolError("free list contains duplicates")
        if NULL_BLOCK in free_set:
            raise BlockPoolError("null block 0 leaked onto the free list")
        cached_set = set(self._cached_lru)
        if NULL_BLOCK in cached_set:
            raise BlockPoolError("null block 0 parked in the cached LRU")
        if free_set & cached_set:
            raise BlockPoolError(
                f"blocks {sorted(free_set & cached_set)} both free and "
                f"cached")
        held: Dict[int, int] = {}
        for seq, table in self._tables.items():
            for b in table:
                if b == NULL_BLOCK:
                    raise BlockPoolError(
                        f"null block 0 inside {seq!r}'s table")
                held[b] = held.get(b, 0) + 1
        for b in range(1, self.num_blocks):
            refs = self._ref[b]
            in_free = b in free_set
            in_cache = b in cached_set
            if (in_free or in_cache) and (refs or b in held):
                raise BlockPoolError(f"block {b} both free and referenced")
            if in_cache and self._block_hash[b] is None:
                raise BlockPoolError(
                    f"block {b} in the cached LRU without a hash")
            if not (in_free or in_cache) and refs != held.get(b, 0):
                raise BlockPoolError(
                    f"block {b} refcount {refs} != {held.get(b, 0)} "
                    f"table references")
            if not (in_free or in_cache) and refs == 0:
                raise BlockPoolError(f"block {b} leaked (no refs, not free)")
        for h, b in self._hash_to_block.items():
            if self._block_hash[b] != h:
                raise BlockPoolError(
                    f"hash index points at block {b} whose reverse entry "
                    f"disagrees")
            if b in free_set:
                raise BlockPoolError(
                    f"registered block {b} sits on the raw free list")
        # promotion bookkeeping: jobs and pending blocks are a
        # bijection; a pending block is always live (refcounted, never
        # free/cached — its pool bytes are garbage until landing) and,
        # when registered at all, registered to its own digest
        if len(self._promote_jobs) != len(self._pending_blocks):
            raise BlockPoolError(
                f"{len(self._promote_jobs)} promote jobs != "
                f"{len(self._pending_blocks)} pending blocks")
        for b, h in self._pending_blocks.items():
            job = self._promote_jobs.get(h)
            if job is None or job.block != b:
                raise BlockPoolError(
                    f"pending block {b} has no matching promote job")
            if self._ref[b] <= 0:
                raise BlockPoolError(f"pending block {b} unreferenced")
            if b in free_set or b in cached_set:
                raise BlockPoolError(
                    f"pending block {b} parked free/cached before its "
                    f"payload landed")
            if self._block_hash[b] not in (h, None):
                raise BlockPoolError(
                    f"pending block {b} registered under a foreign digest")
        # cross-tier disjointness: a digest lives in exactly one place —
        # the device radix index (landed or pending) xor one host tier
        if self._host is not None:
            in_flight = set(self._pending_blocks.values())
            try:
                self._host.assert_consistent(
                    set(self._hash_to_block) | in_flight)
            except AssertionError as e:
                raise BlockPoolError(f"host tier inconsistent: {e}")

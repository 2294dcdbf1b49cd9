"""Paged KV-cache block allocator (host side) with prefix caching.

The bookkeeping half of PagedAttention (Kwon et al., SOSP '23): device
HBM holds one preallocated pool of fixed-size KV blocks
(``models/transformer.py init_paged_cache``); this allocator hands
block ids to sequences and keeps the pool leak-free.  Everything here is
pure Python over integers — no device code, so the policy is unit-testable at
property-test speed and the scheduler can ask "does this admission fit"
without touching the device.

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

Copy of ``deepspeed_tpu/inference/serving/block_allocator.py`` for the
PyTorch port, without the tiered host cache (spill/promote), the
fault-injection sites, copy-on-write ``fork`` and the capacity-planning
helpers, which belong to later slices.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ...runtime.resilience.errors import ServingError

NULL_BLOCK = 0

#: chain root: the "hash" of the empty prefix
ROOT_HASH = b""

class BlockPoolError(ServingError):
    """Allocator invariant violation (double free, exhaustion, unknown
    sequence) — scheduler bugs, never user input.  Part of the
    resilience layer's :class:`ServingError` branch."""


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
        # cumulative stats the serving engine polls into the metrics
        # registry (counters there, plain ints here — no jax/obs import)
        self.hit_tokens_total = 0
        self.evictions_total = 0

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
            for i in range(max_hit_blocks):
                h = _chain_hash(h, tuple(token_ids[i * bs:(i + 1) * bs]))
                b = self._hash_to_block.get(h)
                if b is None:
                    break
                if self._ref[b] == 0:
                    self._claim_cached(b)
                else:
                    self._ref[b] += 1
                blocks.append(b)
                chain.append(h)
                cached_tokens += bs
            self.hit_tokens_total += cached_tokens
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

    def append_block(self, seq_id: str) -> int:
        """Grow a sequence by one block (decode crossed a block
        boundary); raises on exhaustion — the scheduler preempts and
        retries."""
        table = self._tables.get(seq_id)
        if table is None:
            raise BlockPoolError(f"unknown sequence {seq_id!r}")
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

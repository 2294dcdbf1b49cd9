"""Continuous-batching serving engine of the port: the device half.

Counterpart of ``deepspeed_tpu/inference/serving/engine.py``: ``submit()``
queues requests, every ``step()`` sweeps deadlines, grows block tables
(preempting under KV pressure), admits, and dispatches the mixed step:
one decode token for every live slot plus up to
``prefill_chunk_tokens`` of one prompt chunk, through the model's
``_apply_paged_mixed`` (kernels B6 and B7 over the paged pool, which
``serving.kv_cache_bits`` 8 or 4 stores as int8 or packed int4 with f32
scales beside it; with ``quant.enabled`` the step takes the engine's
int8 weights through ``_model_params``).  Sampling is per request and
per output index (``inference/sampling.py``), so a stream is
reproducible across batch composition and preemption and, greedy,
token-identical to ``generate()``.  A slot whose logits turn non-finite
is quarantined alone: it fails, its KV never reaches the prefix cache,
the batch continues.

**Speculative lane** (a draft model passed at construction, Leviathan
et al., ICML '23): a decoding slot that still wants two tokens, fits
``serving.spec_k + 1`` more positions and can grow its table without
preempting anyone (``scheduler.try_grow``) speculates.  The draft's own
paged pool (never quantized) shares the target's block tables and
lengths and moves in lockstep with it: the draft mirrors every prefill
chunk, its feed 0 writes the token of every decoding slot, plain or
speculating, and feeds 1..k run the speculating slots, proposal i drawn
with the key and output index the target uses there.  The target
verifies every row in the same ``_apply_paged_mixed`` (B6 once per spec
depth), samples each position with its own key, and accepts proposal i
while it equals the target's sample before it; only the target's
samples are emitted, so the streams equal the non-speculative engine's
token for token.  The KV rollback is the length vector alone.

**Streaming and observability**: tokens and terminal events are
buffered in an iteration and delivered at its boundary to
``token_hooks``, ``lifecycle_hooks`` (the multi-tenant front end's
taps, ``frontend/``) and each request's ``on_token``; a callback that
raises turns off only its own stream.  ``serving/*`` spans, the
``dstpu_serving_*`` metrics, the request tracer, the flight recorder
(dumped on ``ServingError``) and the overlap profiler hang off the
process-global ``observability`` package: each site costs one attribute
check when it is off.  The heartbeat beats at every iteration boundary
(``DSTPU_HEARTBEAT_FILE``), and the ``serving.dispatch`` fault site skips
an iteration on a transient fault and raises ``ServingError`` on a fatal
one.

**Tiered host cache** (``serving.host_cache``): a registered block the
pool's LRU evicts is demoted instead of forgotten — gathered to the host
(``pool[:, b]`` of every layer, scale planes too when quantized),
encoded by ``BlockCodec`` and parked in DRAM or NVMe slots
(``HostTierCache``) under its chain digest (``_spill_block``, the
``serving.spill`` site).  A prefix hit on a spilled chain claims a pool
block at admission and queues the payload; ``step()`` lands up to
``promote_parallelism`` of them a step (``_service_promotions``: decode,
then ``pool[:, b].copy_(...)`` on the current stream, ordered before the
next mixed step; the ``serving.promote`` site), and the scheduler holds
the request out of prefill until its blocks have landed, so B7 computes
only the tail past the promoted prefix.  A failed spill degrades to a
plain eviction, a fatal promote to recompute.

**The fleet's parts**: ``role`` ("prefill" runs prefill legs only and
publishes finished chains to the shared host tier, the KV fabric;
"decode" and "mixed" serve whole requests), ``publisher_id``,
``shared_host_cache`` (one host tier for every replica of a fleet) and
``submit(prefill_only=True)`` (publish the chain, finish OK, emit no
token) — ``fleet/`` builds the router over these.

Where the JAX engine compiles one program with fixed lane widths, this
one runs eagerly and passes only the lanes a dispatch has: a step
without a chunk runs no prefill lane, one with no plain-decoding slot
no decode lane, one with no speculating slot no spec lane and no draft
feed past the first; every dispatch still ends in one device-to-host
copy.

**The serving mesh** (``serving.mesh`` {data, model}, one process per
rank, the engine's mesh, over process groups of this engine's own):
every rank runs the same scheduler on the same submissions.  A host
decision that reads a clock, a thread or an I/O outcome is taken once,
by the mesh's rank 0, and broadcast at each iteration boundary before
the dispatch (``lockstep.py``: deadline expiries here, the front end's
at-risk boosts and firing alerts and a threaded fleet replica's inbox
drain and stop through ``lockstep_hooks``); an I/O
outcome each rank meets for its own slice (a spill, promote, publish or
claim) is agreed by a MIN over the mesh.  The model axis shards heads,
MLP columns, vocab and the pool (each rank's pools hold ``kv_heads /
model`` heads of every block, ``kv_pool_bytes`` is this rank's),
through the model's per-shard view; the data axis splits the decode
slots, rank d owning slots ``d * B / data ..``, while the prefill chunk
runs on every data rank.  The sampled tokens come from logits that are
bit-identical on every model rank (the vocab shards all-gathered in
vocab order), and one all-gather over ``data`` a dispatch hands every
rank every slot's results (the chunk's are data rank 0's).  The
speculative lane runs the same way: the draft and its pool are whole on
every rank, its view arms only ``data``, and its spec rows are this
rank's slots'.  The host tier stores each rank's kv-head slice of a
block (its slot counts from the whole block's entry, so spills, hits and
promotes are the one-rank engine's and its bytes 1/model of them), on
every data rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import comm
from ...models.convert import leaf_to_torch, tree_map
from ...parallel.topology import DATA_AXIS, MODEL_AXIS
from ...observability import (get_flight_recorder, get_overlap_profiler,
                              get_registry, get_request_tracer, trace_span)
from ...runtime.resilience.errors import (FatalIOError, ServingError,
                                          TransientIOError)
from ...runtime.resilience.fault_injection import get_fault_injector
from ...runtime.resilience.heartbeat import Heartbeat
from ...runtime.resilience.retry import retry_call
from ...utils.logging import logger
from ..sampling import sample_tokens
from .block_allocator import BlockPoolError, PagedBlockAllocator
from .frontend.streaming import TokenEvent
from .host_cache import BlockCodec, HostTierCache
from .lockstep import Lockstep
from .scheduler import (ContinuousBatchingScheduler, Request, RequestState,
                        RequestStatus, estimate_retry_after_s)


#: a promotion's outcome on one rank, worst first: the mesh agrees on the
#: least of every rank's
_FATAL, _TRANSIENT, _LANDED = 0, 1, 2


class ServingEngine:
    """Continuous-batching front end over an ``InferenceEngine``::

        eng = deepspeed_tpu_torch.init_inference(model, config={
            "serving": {"enabled": True, "kv_block_size": 16,
                        "num_kv_blocks": 512, "max_batch_slots": 8,
                        "prefill_chunk_tokens": 256}})
        srv = eng.serving_engine()            # or draft_model=... (spec)
        reqs = [srv.submit(p, max_new_tokens=64) for p in prompts]
        srv.run()                      # drain
        streams = [r.output for r in reqs]
    """

    def __init__(self, engine, seed: Optional[int] = None,
                 draft_model=None, draft_params=None,
                 shared_host_cache: Optional[HostTierCache] = None,
                 role: str = "mixed"):
        cfg = engine.config.serving
        # -- the (data, model) serving mesh: the engine's -----------------
        self.tp_data_size = engine.tp_data_size
        self.tp_model_size = engine.tp_model_size
        model = engine.module
        #: rank 0's decisions for every rank, over this engine's own
        #: process groups (inactive at mesh 1 x 1)
        self.lockstep = Lockstep(engine.mesh)
        #: name -> (propose(now) on rank 0, apply(decision, live) on every
        #: rank, ``live`` the scheduler's live requests the decision's
        #: indices name) of decisions beyond the deadline sweep (the
        #: front end's, a fleet replica's inbox drain)
        self.lockstep_hooks: Dict[str, Tuple[Callable, Callable]] = {}
        if self.tp_data_size * self.tp_model_size > 1:
            self._init_tp_mesh(engine)
            model = model.tp_serving_view(
                self.tp_model_size, MODEL_AXIS,
                DATA_AXIS if self.tp_data_size > 1 else None)
        # disaggregated fleet replica class: a "prefill" engine runs
        # chunked prefill only and publishes finished chains to the KV
        # fabric; "decode"/"mixed" engines serve full requests ("decode"
        # is a routing preference, not an engine-side restriction, so a
        # degraded fleet can still fall back to any replica)
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"serving role must be 'mixed', 'prefill' or 'decode', "
                f"got {role!r}")
        if role == "prefill" and not cfg.host_cache.enabled:
            raise ValueError(
                "role='prefill' requires serving.host_cache.enabled — "
                "the host tier IS the KV fabric prefill workers publish "
                "finished chains into")
        self.role = role
        #: fabric identity for published entries (orphan reaping is
        #: publisher-scoped); the fleet router sets it to the replica id
        self.publisher_id = f"engine-{id(self):x}"
        reason = model._paged_supported(cfg.kv_cache_bits)
        if reason is not None:
            raise NotImplementedError(
                f"continuous-batching serving cannot run this model: "
                f"{reason}")
        self.engine = engine
        self.model = model
        self.device = engine.device
        self.block_size = cfg.kv_block_size
        self.num_slots = cfg.max_batch_slots
        self.chunk_tokens = cfg.prefill_chunk_tokens
        self.max_pages = max(
            1, -(-engine.config.max_out_tokens // self.block_size))
        self.allocator = PagedBlockAllocator(
            cfg.num_kv_blocks, self.block_size,
            enable_prefix_cache=cfg.prefix_cache)
        # a prefill worker publishes to the fabric but never claims from
        # it: claiming would steal the very entries the decode class is
        # about to promote
        self.allocator.allow_claims = role != "prefill"
        if self.lockstep.active:
            # a host-tier claim is each rank's own I/O: agreed
            self.allocator.agree = self.lockstep.agree
        self.scheduler = ContinuousBatchingScheduler(
            self.num_slots, self.allocator, self.max_pages,
            max_queue_depth=cfg.max_queue_depth,
            max_preemptions=cfg.max_preemptions)
        self.scheduler.retry_after_hint = self._estimate_retry_after
        self.no_progress_steps = cfg.no_progress_steps
        self.default_deadline_s = cfg.default_deadline_s
        self._no_progress = 0
        # process-global recorders (observability/): every site below
        # guards on ``.enabled``, so the disabled default is one check
        self._rt = get_request_tracer()
        self._fr = get_flight_recorder()
        self._ovl = get_overlap_profiler()
        #: KV-cache width: 0 = engine dtype, 8 = int8, 4 = packed int4
        self.kv_bits = cfg.kv_cache_bits
        with trace_span("serving/kv_quantize", bits=self.kv_bits,
                        blocks=cfg.num_kv_blocks):
            pools = model.init_paged_cache(cfg.num_kv_blocks,
                                           self.block_size,
                                           dtype=engine.dtype,
                                           kv_bits=self.kv_bits,
                                           device=self.device)
        self._pool_k, self._pool_v = pools["k"], pools["v"]
        self._pool_ks = pools.get("k_scale")
        self._pool_vs = pools.get("v_scale")
        logger.info(
            f"serving: paged KV pool {cfg.num_kv_blocks} x "
            f"{self.block_size}-token blocks "
            f"({self.kv_pool_bytes / 2**20:.1f} MiB"
            f"{f', int{self.kv_bits} + f32 scales' if self.kv_bits else ''}"
            f"), {self.num_slots} decode slots, {self.max_pages} pages/seq, "
            f"prefill chunk {self.chunk_tokens} tokens, prefix cache "
            f"{'on' if cfg.prefix_cache else 'off'}")
        # -- tiered host prefix cache: LRU-evicted registered blocks
        # demote into host DRAM/NVMe through the wire codec; hits on
        # spilled chains promote back in the admission window ----------
        self.host_cache: Optional[HostTierCache] = None
        self._hc_codec: Optional[BlockCodec] = None
        self._promote_k = cfg.host_cache.promote_parallelism
        #: plain-int mirrors of the host-tier counters
        self.host_counts = {"promoted_blocks": 0, "promote_failures": 0,
                            "spill_failures": 0}
        #: KV-fabric mirrors (disaggregated fleet): chain blocks this
        #: engine published, publishes degraded to decode-side
        #: recompute, and prefill-only requests completed
        self.fabric_counts = {"published_blocks": 0,
                              "publish_failures": 0,
                              "prefill_only_completed": 0}
        #: wall seconds inside _service_promotions — with
        #: ``promoted_blocks * codec.nbytes`` the promote bandwidth
        self.promote_seconds = 0.0
        if cfg.host_cache.enabled:
            if not cfg.prefix_cache:
                raise ValueError(
                    "serving.host_cache.enabled requires "
                    "serving.prefix_cache — the host tier is keyed by "
                    "the radix index's content digests")
            # ``shared_host_cache`` is the fleet's cross-replica warm
            # tier: the store is content-addressed and device-agnostic,
            # so replicas sharing one instance hit prefixes their
            # siblings spilled, and a joining replica starts warm
            self._init_host_cache(cfg.host_cache, shared=shared_host_cache)
        self.temperature = engine.config.temperature
        self.top_k = engine.config.top_k
        self.top_p = engine.config.top_p
        #: sampling key of requests submitted without a seed — the same
        #: default ``generate()`` uses
        self._base_key = 0 if seed is None else int(seed)

        #: draft-model speculative decoding: ``serving.spec_k`` proposals
        #: per speculating slot per iteration
        self.spec_k = cfg.spec_k
        #: the draft as passed (``_draft_model`` may be its rebuild in the
        #: engine's dtype)
        self._draft_given = draft_model
        self._draft_model = None
        self._draft_params = None
        self._dpool_k = self._dpool_v = None
        if draft_model is not None:
            self._init_draft(draft_model, draft_params)

        # -- streaming: events buffer inside an iteration and flush at
        # its boundary; engine-level hooks are the front end's taps ----
        self.token_hooks: List[Callable] = []
        self.lifecycle_hooks: List[Callable] = []
        self._event_buf: List[TokenEvent] = []
        #: liveness beat at every iteration boundary (a no-op unless
        #: ``DSTPU_HEARTBEAT_FILE`` names a file)
        self.heartbeat = Heartbeat(interval_s=cfg.fleet.heartbeat_interval_s)
        self._drain_rate_ema: Optional[float] = None
        self._last_finish_t: Optional[float] = None
        #: extra histograms that mirror every TTFT/ITL observation: fleet
        #: replica handles register their per-replica series here
        #: (observability/fleet_metrics.py merges them bucket-wise)
        self.mirror_hists: Dict[str, List[Any]] = {}

        #: plain-int counters beside the metrics registry: tokens emitted,
        #: prompt tokens computed, preemptions, dispatches
        self.counts = {"tokens": 0, "prefill_tokens": 0, "preemptions": 0,
                       "dispatches": 0}
        self.lifecycle_counts = {"cancelled": 0, "timed_out": 0,
                                 "shed": 0, "failed": 0, "quarantined": 0}
        #: acceptance_rate = accepted / proposed
        self.spec_counts = {"proposed": 0, "accepted": 0}
        # per-token per-layer model-axis all-reduce payload (bytes): one
        # on attention + MLP for parallel-residual blocks, two for
        # serial and post-norm ones
        npsums = 1 if model.config.parallel_residual else 2
        self.tp_psum_bytes_per_token_layer = (
            0 if self.tp_model_size == 1 else model.config.d_model
            * torch.finfo(model.config.dtype).bits // 8 * npsums)
        self._register_metrics()
        # counter deltas are polled off the allocator's and the host
        # tier's cumulative ints
        self._hits_polled = 0
        self._evictions_polled = 0
        self._host_polled = {"spills": 0, "dram_hits": 0, "nvme_hits": 0,
                             "demotions": 0, "evictions": 0,
                             "hit_tokens": 0}

    def _init_tp_mesh(self, engine) -> None:
        """What a mesh beyond 1 x 1 needs beyond the engine's checks: the
        engine's weights in channel mode."""
        if self.tp_model_size > 1 and engine._quantized and \
                engine._qmode != "channel":
            raise NotImplementedError(
                "tensor-parallel serving over quantized weights needs "
                "per-output-channel scales (grouped scales cross shard "
                "boundaries) — the engine selects channel mode when "
                "serving.mesh.model > 1 at init_inference time; rebuild "
                "the engine with the serving mesh in its config")

    def _register_metrics(self) -> None:
        """The JAX engine's ``dstpu_serving_*`` and ``dstpu_mesh_*``
        series."""
        reg = get_registry()
        self._m_queue = reg.gauge(
            "dstpu_serving_queue_depth", "requests waiting for a decode slot")
        self._m_active = reg.gauge(
            "dstpu_serving_active_slots",
            "decode-slot occupancy (continuous batch size)")
        self._m_blocks = reg.gauge(
            "dstpu_serving_kv_blocks_in_use", "paged KV pool blocks held")
        self._m_cached = reg.gauge(
            "dstpu_serving_cached_kv_blocks",
            "refcount-0 pool blocks parked in the prefix-cache LRU")
        reg.gauge(
            "dstpu_serving_kv_pool_bytes",
            "device memory held by the paged KV pool (values + dequant "
            "scales)").set(self.kv_pool_bytes)
        reg.gauge(
            "dstpu_serving_kv_bits",
            "KV-cache width: 0 = engine dtype, 8 = int8, 4 = packed "
            "int4").set(self.kv_bits)
        # serving-mesh shape gauges: the per-rank numbers above (pool
        # bytes) read honestly only beside the mesh they were taken on
        reg.gauge(
            "dstpu_mesh_data_size",
            "serving mesh data-axis size (decode-slot sharding)"
            ).set(self.tp_data_size)
        reg.gauge(
            "dstpu_mesh_model_size",
            "serving mesh model-axis size (tensor parallelism)"
            ).set(self.tp_model_size)
        self._m_decisions = reg.counter(
            "dstpu_mesh_decisions_total",
            "iterations whose host decisions rank 0 of the serving mesh "
            "took and broadcast (0 at mesh 1 x 1)")
        self._m_ttft = reg.histogram(
            "dstpu_serving_ttft_seconds",
            "submit -> first token (includes queueing + chunked prefill)")
        self._m_itl = reg.histogram(
            "dstpu_serving_inter_token_seconds",
            "decode-iteration wall time (per-token latency of every "
            "active stream)")
        self._m_tokens = reg.counter(
            "dstpu_serving_tokens_total", "tokens generated by serving")
        self._m_preempt = reg.counter(
            "dstpu_serving_preemptions_total",
            "sequences evicted on KV-pool pressure (tail recompute on "
            "re-admission)")
        self._m_hit_tokens = reg.counter(
            "dstpu_serving_prefix_cache_hit_tokens_total",
            "prompt tokens served from cached KV blocks (prefill skipped)")
        self._m_prefill_tokens = reg.counter(
            "dstpu_serving_prefill_tokens_total",
            "prompt tokens actually computed by chunked prefill "
            "(the prefix-cache miss side)")
        self._m_evictions = reg.counter(
            "dstpu_serving_prefix_cache_evictions_total",
            "cached blocks evicted from the LRU under capacity pressure")
        self._m_cancelled = reg.counter(
            "dstpu_serving_cancelled_total", "requests cancelled by caller")
        self._m_timed_out = reg.counter(
            "dstpu_serving_timed_out_total",
            "requests expired by the per-request deadline sweep")
        self._m_shed = reg.counter(
            "dstpu_serving_shed_total",
            "requests rejected at submit by max_queue_depth backpressure")
        self._m_failed = reg.counter(
            "dstpu_serving_failed_total",
            "requests failed (quarantine, thrash pin-or-fail, fatal fault)")
        self._m_quarantined = reg.counter(
            "dstpu_serving_quarantined_total",
            "requests quarantined on non-finite logits (KV discarded, "
            "batch unaffected)")
        self._m_spec_proposed = reg.counter(
            "dstpu_serving_spec_proposed_tokens_total",
            "draft tokens proposed to the speculative verify lane")
        self._m_spec_accepted = reg.counter(
            "dstpu_serving_spec_accepted_tokens_total",
            "draft tokens accepted by the target's verify step")
        reg.gauge(
            "dstpu_serving_spec_k",
            "draft proposals per slot per iteration (0 = speculative "
            "decoding off)").set(self.spec_k if self._draft_model is not None
                                 else 0)
        # tiered host cache: per-tier hit/spill/evict counters,
        # resident-bytes and promote-queue-depth gauges
        self._m_host_spills = reg.counter(
            "dstpu_serving_host_spills_total",
            "evicted KV blocks demoted into the host tier (vs forgotten)")
        self._m_host_dram_hits = reg.counter(
            "dstpu_serving_host_dram_hits_total",
            "prefix-hit blocks claimed out of the host DRAM tier")
        self._m_host_nvme_hits = reg.counter(
            "dstpu_serving_host_nvme_hits_total",
            "prefix-hit blocks claimed out of the host NVMe tier")
        self._m_host_demotions = reg.counter(
            "dstpu_serving_host_demotions_total",
            "entries pushed DRAM -> NVMe under host-tier pressure")
        self._m_host_evictions = reg.counter(
            "dstpu_serving_host_evictions_total",
            "entries aged out of the host tier entirely")
        self._m_host_hit_tokens = reg.counter(
            "dstpu_serving_host_hit_tokens_total",
            "prompt tokens served by host-tier promotion instead of "
            "recompute")
        self._m_promoted = reg.counter(
            "dstpu_serving_promoted_blocks_total",
            "host-tier payloads landed back into the device pool")
        self._m_promote_failures = reg.counter(
            "dstpu_serving_promote_failures_total",
            "promotions dropped to recompute (fatal fault / bad payload)")
        self._m_spill_failures = reg.counter(
            "dstpu_serving_spill_failures_total",
            "spills degraded to plain eviction (host store fault)")
        # KV-fabric metrics: prefill-side publishes and their degradations
        self._m_fabric_published = reg.counter(
            "dstpu_serving_fabric_published_total",
            "finished-chain blocks published into the KV fabric")
        self._m_fabric_publish_failures = reg.counter(
            "dstpu_serving_fabric_publish_failures_total",
            "fabric publishes degraded to decode-side recompute")
        self._m_host_dram_bytes = reg.gauge(
            "dstpu_serving_host_dram_bytes",
            "encoded KV bytes resident in the host DRAM tier (this "
            "rank's kv-head slices on a model-sharded mesh)")
        self._m_host_nvme_bytes = reg.gauge(
            "dstpu_serving_host_nvme_bytes",
            "encoded KV bytes resident in the host NVMe tier (this "
            "rank's kv-head slices on a model-sharded mesh)")
        self._m_promote_depth = reg.gauge(
            "dstpu_serving_promote_queue_depth",
            "claimed host payloads waiting to land in the pool")

    @property
    def kv_pool_bytes(self) -> int:
        """Device memory this rank's paged KV pool holds: values plus the
        dequant scale planes when quantized (on a model-sharded mesh its
        ``kv_heads / model`` of every block; the data ranks replicate
        the pool)."""
        pools = [self._pool_k, self._pool_v]
        if self._pool_ks is not None:
            pools += [self._pool_ks, self._pool_vs]
        return sum(t.numel() * t.element_size() for t in pools)

    # ------------------------------------------------------------------
    # tiered host prefix cache
    # ------------------------------------------------------------------
    def _init_host_cache(self, hc, shared=None) -> None:
        """Build the host tier from the pool geometry and wire it into
        the allocator: eviction becomes demotion (``_spill_block``) and
        the allocate hit walk extends into the host store.  ``shared``
        injects an already-built (fleet-shared) store instead: entry
        geometry must match, budgets were sized by whoever built it.

        On a model-sharded mesh each rank encodes and stores its own
        ``kv_heads / model`` slice of a block (the codec's scales are one
        per layer, token and kv head, so a slice's bytes are the whole
        entry's bytes for those heads), every data rank alike; the slot
        counts come from the whole block's entry, so what spills, hits
        and promotes is what one rank's engine would, at 1/model of its
        host bytes on each rank."""
        c = self.model.config
        self._hc_codec = BlockCodec(
            c.num_layers, self.block_size, c.kv_heads, c.hdim,
            kv_bits=self.kv_bits, wire_bits=hc.wire_bits,
            dtype=self._pool_k.dtype)
        entry = self._hc_codec.nbytes
        whole = entry * self.tp_model_size
        if shared is not None:
            if shared.entry_nbytes != entry:
                raise ValueError(
                    f"shared host cache entry size "
                    f"{shared.entry_nbytes} != this replica's codec "
                    f"{entry} bytes — fleet replicas must share pool "
                    f"geometry (block size, kv heads, bits)")
            self.host_cache = shared
            self.allocator.attach_host_tier(self.host_cache,
                                            self._spill_block)
            return
        dram_slots = hc.dram_budget_bytes // whole
        nvme_slots = hc.nvme_budget_bytes // whole
        if dram_slots == 0 and nvme_slots == 0:
            raise ValueError(
                f"serving.host_cache budgets admit zero entries — one "
                f"encoded block is {whole} bytes ({c.num_layers} layers "
                f"x {self.block_size} tokens x "
                f"{c.kv_heads * self.tp_model_size} kv heads at "
                f"{self._hc_codec.at_rest_bits or 'raw'} bits)")
        self.host_cache = HostTierCache(
            entry, dram_slots, nvme_slots=nvme_slots,
            nvme_path=hc.nvme_path,
            buffer_count=max(4, self._promote_k))
        self.allocator.attach_host_tier(self.host_cache, self._spill_block)
        logger.info(
            f"serving: tiered host cache on — entry {entry / 2**10:.1f} "
            f"KiB a rank at {self._hc_codec.at_rest_bits or 'raw'}-bit, "
            f"dram {dram_slots} entries"
            f"{f', nvme {nvme_slots} entries' if nvme_slots else ''}, "
            f"promote parallelism {self._promote_k}")

    def _block_pools(self) -> List[torch.Tensor]:
        pools = [self._pool_k, self._pool_v]
        if self.kv_bits:
            pools += [self._pool_ks, self._pool_vs]
        return pools

    def _gather_block(self, block: int) -> List[torch.Tensor]:
        """Pool block ``block`` of every layer on the host: ``[k, v]``
        (``[L, bs, kvh, d_eff]``), and the ``[L, bs, kvh]`` scale planes
        of a quantized pool.  The copy waits for the work queued before
        it (the JAX design's ``np.asarray``): it runs in the admission
        window, never per decode token."""
        return [pool[:, block].cpu() for pool in self._block_pools()]

    @torch.no_grad()
    def _scatter_block(self, block: int, parts) -> None:
        """Write ``parts`` (host tensors, :meth:`_gather_block`'s layout)
        into pool block ``block`` in place, on the current stream: the
        copies are ordered before the next mixed step's kernels."""
        for pool, part in zip(self._block_pools(), parts):
            pool[:, block].copy_(part)

    def _encode_block(self, block: int):
        return self._hc_codec.encode(*self._gather_block(block))

    def _agreed(self, err: Optional[BaseException], what: str
                ) -> Optional[BaseException]:
        """``err`` (None: this rank's part succeeded), or, where another
        rank of the mesh failed its part of ``what``, an error saying so:
        every rank then takes the failure path together."""
        if not self.lockstep.agree(err is None) and err is None:
            err = RuntimeError(f"another rank of the serving mesh failed "
                               f"its slice of {what}")
        return err

    def _spill_block(self, block: int, digest: bytes) -> None:
        """Allocator eviction callback: encode the dying block and park
        it in the host tier under its chain digest.  NEVER raises — the
        ``serving.spill`` fault site (transient faults retried under
        the resilience backoff) degrades any terminal failure to a
        plain eviction, so a sick host store costs warmth, not
        correctness, and never a wrong block.  On a mesh the fault site
        and the store are each agreed: a rank stores its slice only
        where every rank's is ready, and drops it again where another
        rank's store failed."""
        what = f"host-tier spill of block {block}"
        err = payload = None
        try:
            with trace_span("serving/spill", block=block):
                payload = self._encode_block(block)
                retry_call(lambda: get_fault_injector().check(
                    "serving.spill"), what=what)
        except Exception as e:   # noqa: BLE001 — degrade, never raise
            err = e
        err = self._agreed(err, what)
        if err is None:
            try:
                retry_call(lambda: self.host_cache.put(digest, payload),
                           what=what)
            except Exception as e:   # noqa: BLE001 — degrade, never raise
                err = e
            err = self._agreed(err, what)
            if err is not None:
                self.host_cache.discard(digest)
        if err is not None:
            self.host_counts["spill_failures"] += 1
            self._m_spill_failures.inc()
            logger.warning(
                f"serving: spill of block {block} failed ({err!r}) — "
                f"degraded to plain eviction")

    def _publish_block(self, block: int, digest: bytes) -> bool:
        """Push one finished-chain block into the KV fabric (the
        spill's gather and codec, through :meth:`HostTierCache.publish`
        so the entry carries a crc32 and this engine's publisher id).
        NEVER raises: the ``serving.fabric.publish`` site fires inside
        ``publish`` before any fabric mutation, transient faults retry
        under the resilience backoff, and a terminal failure degrades to
        decode-side recompute — a handoff miss, never a wrong token.
        On a mesh each rank publishes its slice, and a block counts as
        published only where every rank's did (the others drop theirs)."""
        what = f"fabric publish of block {block}"
        err = None
        try:
            with trace_span("serving/fabric_publish", block=block):
                payload = self._encode_block(block)

                def _pub():
                    self.host_cache.publish(digest, payload,
                                            publisher=self.publisher_id)
                retry_call(_pub, what=what)
        except Exception as e:   # noqa: BLE001 — degrade, never raise
            err = e
        agreed = self._agreed(err, what)
        if agreed is None:
            self.fabric_counts["published_blocks"] += 1
            self._m_fabric_published.inc()
            return True
        if err is None:
            self.host_cache.discard(digest)
        self.fabric_counts["publish_failures"] += 1
        self._m_fabric_publish_failures.inc()
        logger.warning(
            f"serving: fabric publish of block {block} failed "
            f"({agreed!r}) — decode leg will recompute")
        return False

    def _publish_chain(self, req) -> int:
        """Publish every committed full block of ``req``'s chain, in
        block order, stopping at the first failure so published chains
        stay prefix-contiguous (the decode-side hit walk stops at its
        first miss — a gap would strand the tail as unclaimable
        orphans).  Returns blocks published."""
        if self.host_cache is None:
            return 0
        alloc = self.allocator
        table = alloc.block_table(req.req_id)
        published = 0
        for digest, block in zip(alloc.seq_chain(req.req_id), table):
            if not self._publish_block(block, digest):
                break
            published += 1
        return published

    def _finish_prefill_only(self, slot: int, req) -> None:
        """A ``prefill_only`` request's target landed: publish the
        finished chain to the fabric, OK-finish the slot with its blocks
        unregistered (the digests now live fabric-side only), and close
        the stream with a tokenless OK terminal event — the router's
        handoff trigger.  No token is sampled or emitted on the prefill
        leg; the decode leg starts its stream at output index 0 with the
        pinned key."""
        if self._rt.enabled:
            # fabric_publish anchors the merged fleet trace's
            # prefill->decode flow arrow (observability/fleet_trace.py)
            t0p = time.perf_counter()
            published = self._publish_chain(req)
            self._rt.on_segment(
                req, "fabric_publish", t0p, time.perf_counter() - t0p,
                blocks=published, publisher=self.publisher_id)
        else:
            self._publish_chain(req)
        self.fabric_counts["prefill_only_completed"] += 1
        self.scheduler.finish_prefill(slot)
        self._event_buf.append(TokenEvent(
            request=req, token=None, index=0, status=req.status,
            final=True, tenant=req.tenant, time_s=time.perf_counter(),
            prev_time_s=None))

    def _service_promotions(self) -> int:
        """Land up to ``promote_parallelism`` queued host->pool block
        promotions (the scheduler holds the owning requests in the
        PROMOTING phase until their blocks land).  Transient
        ``serving.promote`` faults that outlive the in-call retry budget
        leave the job queued for next step; a fatal fault drops the job
        AND its registration and rolls every holder back to recompute
        (``promotion_failed``) — stale or mismatched KV is never served.
        On a mesh each rank lands its own slice and the outcome is
        agreed, the worst of every rank's (fatal, then transient, then
        landed), so the job stays queued, or fails, on every rank
        together.  Returns blocks landed (watchdog progress)."""
        alloc = self.allocator
        if self.host_cache is None or not alloc.num_pending:
            return 0
        sched = self.scheduler
        promoting = [r for r in sched.running.values()
                     if sched.promoting(r)]
        t0 = time.perf_counter()
        landed = 0
        for job in alloc.pending_jobs()[:self._promote_k]:
            what = f"host-tier promote of block {job.block}"
            err, outcome = None, _LANDED
            try:
                with trace_span("serving/promote", block=job.block):
                    def _land():
                        # the fault site fires BEFORE the scatter, so a
                        # fault leaves the pool untouched; the scatter
                        # itself is idempotent under retry
                        get_fault_injector().check("serving.promote")
                        self._land_promotion(job)
                    retry_call(_land, what=what)
            except TransientIOError as e:
                err, outcome = e, _TRANSIENT
            except Exception as e:   # noqa: BLE001 — fatal: recompute
                err, outcome = e, _FATAL
            agreed = self.lockstep.agree(outcome)
            if agreed != outcome:
                err = RuntimeError(f"another rank of the serving mesh "
                                   f"failed its slice of {what}")
            if agreed == _TRANSIENT:
                # retry budget exhausted but the fault is transient: the
                # job stays queued (the request stays PROMOTING — delayed,
                # never corrupted)
                logger.warning(
                    f"serving: promote of block {job.block} still "
                    f"transient after retries — queued for next step: "
                    f"{err}")
                continue
            if agreed == _FATAL:
                affected = alloc.promotion_failed(job.digest)
                self.host_counts["promote_failures"] += 1
                self._m_promote_failures.inc()
                for seq_id, block_index in affected:
                    for req in sched.running.values():
                        if req.req_id == seq_id:
                            # roll back to the last row BEFORE the dead
                            # block: prefill recomputes from there
                            # (identical content, so the chain record
                            # stays valid)
                            req.cached_tokens = min(
                                req.cached_tokens,
                                block_index * self.block_size)
                logger.warning(
                    f"serving: promote of block {job.block} failed "
                    f"fatally ({err!r}) — host entry dropped, "
                    f"{len(affected)} holder(s) fall back to recompute")
                continue
            alloc.promotion_landed(job.digest)
            landed += 1
            self.host_counts["promoted_blocks"] += 1
            self._m_promoted.inc()
        dur = time.perf_counter() - t0
        self.promote_seconds += dur
        if landed and self._rt.enabled:
            self._rt.on_promote(promoting, t0, dur, landed)
        return landed

    def _land_promotion(self, job) -> None:
        """Decode one claimed payload and scatter it into the pool at
        its claimed block."""
        k, v, ks, vs = self._hc_codec.decode(job.payload)
        self._scatter_block(job.block,
                            [k, v, ks, vs] if self.kv_bits else [k, v])

    # ------------------------------------------------------------------
    # speculative decoding (draft lane)
    # ------------------------------------------------------------------
    def _init_draft(self, draft, params) -> None:
        """Validate the draft against the target and build its own paged
        pool (the target's geometry, never quantized: it is small and its
        logits drive acceptance, not output) over the target's block
        tables and lengths.  The draft runs in the engine's dtype (a
        model of another dtype is rebuilt, as the engine rebuilds the
        target); ``params`` already in that dtype on the device are used
        as they are, with no copy.  On a serving mesh the draft and its
        pool are whole on every rank (its params are the whole draft's),
        and its view arms only ``data``: each data rank proposes for its
        own slots and every pool replica takes every slot's rows."""
        cfg = self.engine.config.serving
        reason = draft._paged_supported(0)
        if reason is not None:
            raise NotImplementedError(
                f"speculative draft model cannot run the paged path: "
                f"{reason}")
        if draft.config.vocab_size != self.model.config.vocab_size:
            raise ValueError(
                f"draft vocab_size ({draft.config.vocab_size}) must "
                f"match the target's ({self.model.config.vocab_size}) "
                f"— proposals are token ids")
        if draft.config.max_seq_len < self.engine.config.max_out_tokens:
            raise ValueError(
                f"draft max_seq_len ({draft.config.max_seq_len}) is "
                f"shorter than max_out_tokens "
                f"({self.engine.config.max_out_tokens}) — the draft "
                f"must reach every position the target serves")
        dtype = self.engine.dtype
        if draft.config.dtype != dtype:
            draft = type(draft)(dataclasses.replace(draft.config,
                                                    dtype=dtype))
        if params is None:
            # fresh-init drafts are only useful for plumbing tests:
            # acceptance will be ~chance
            logger.warning(
                "serving: no draft_params given — initializing an "
                "UNTRAINED draft (near-zero acceptance; pass a trained "
                "draft checkpoint for real speedups)")
            g = torch.Generator(device=self.device)
            g.manual_seed(1)
            params = draft.init(g, self.device, dtype)

        def cast(x):
            t = x if isinstance(x, torch.Tensor) else leaf_to_torch(x, "cpu")
            return t.to(self.device, dtype if t.is_floating_point()
                        else t.dtype)
        self._draft_params = tree_map(params, cast)
        if self.tp_data_size * self.tp_model_size > 1:
            draft = draft.tp_serving_view(
                1, None, DATA_AXIS if self.tp_data_size > 1 else None)
        self._draft_model = draft
        with trace_span("serving/draft_pool", blocks=cfg.num_kv_blocks):
            dpools = draft.init_paged_cache(
                cfg.num_kv_blocks, self.block_size, dtype=dtype, kv_bits=0,
                device=self.device)
        self._dpool_k, self._dpool_v = dpools["k"], dpools["v"]
        logger.info(
            f"serving: speculative decoding armed — draft "
            f"{draft.config.num_layers}L/{draft.config.d_model}d, "
            f"k={self.spec_k} proposals/slot/iteration")

    # ------------------------------------------------------------------
    # token streaming (frontend/streaming.py)
    # ------------------------------------------------------------------
    def _emit_token(self, req: Request, token: int) -> None:
        """Buffer one emitted token (status/final resolved at flush —
        the request may reach a terminal state later in the same
        iteration)."""
        now = time.perf_counter()
        self._event_buf.append(TokenEvent(
            request=req, token=token, index=len(req.output) - 1,
            status=None, final=False, tenant=req.tenant, time_s=now,
            prev_time_s=req.last_token_time))
        req.last_token_time = now

    def _flush_events(self) -> None:
        """Deliver buffered token/terminal events at the iteration
        boundary: engine-level hooks first (front-end fairness and
        metrics), then the request's own ``on_token``.  A callback
        exception disables that request's stream — logged once, the
        request and the batch keep running."""
        if not self._event_buf:
            return
        events, self._event_buf = self._event_buf, []
        last_of = {id(ev.request): i for i, ev in enumerate(events)}
        for i, ev in enumerate(events):
            req = ev.request
            if req.state is RequestState.FINISHED and \
                    last_of[id(req)] == i:
                ev = ev._replace(status=req.status, final=True)
            for hook in self.token_hooks:
                try:
                    hook(ev)
                except Exception as e:     # hook bugs must not stall serving
                    logger.warning(f"serving: token hook failed: {e!r}")
            cb = req.on_token
            if cb is None:
                continue
            try:
                cb(ev)
            except Exception as e:
                req.on_token = None
                logger.warning(
                    f"serving: {req.req_id} on_token callback raised "
                    f"{e!r} — stream disabled, request continues")

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None,
               on_token: Optional[Callable] = None,
               tenant: str = "default",
               prefill_only: bool = False,
               trace_id: Optional[str] = None) -> Request:
        """Queue a request.  ``deadline_s`` is a TTL from submit swept
        every ``step()`` (default ``serving.default_deadline_s``; 0 =
        none).  Under overload (``serving.max_queue_depth`` waiting) the
        request comes back terminal with ``status == RequestStatus.SHED``.
        Sampling params default to the inference config; ``seed`` is the
        request's key (None = the engine's base key, matching an
        unseeded ``generate()``).  ``on_token`` receives a
        :class:`TokenEvent` per emitted token at iteration boundaries;
        ``tenant`` tags the request for the front end's fairness
        accounting; ``trace_id`` is adopted by the request tracer (the
        fleet carries one id through every leg of a request).

        ``prefill_only`` runs the prefill leg of a disaggregated handoff:
        the prompt's KV is computed and published to the KV fabric (the
        host tier), NO token is emitted, and the stream closes with a
        tokenless OK terminal event the moment the prefill target
        lands."""
        if prefill_only and self.host_cache is None:
            raise ValueError(
                "prefill_only requires the host-tier KV fabric "
                "(serving.host_cache.enabled) — there is nowhere to "
                "publish the finished chain")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        total = len(prompt) + max_new_tokens
        if total > self.engine.config.max_out_tokens:
            raise ValueError(
                f"prompt+new = {total} exceeds max_out_tokens "
                f"({self.engine.config.max_out_tokens})")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(
                f"deadline_s must be >= 0 (0 = no deadline), got "
                f"{deadline_s}")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        temperature = (self.temperature if temperature is None
                       else float(temperature))
        top_k = self.top_k if top_k is None else int(top_k)
        top_p = self.top_p if top_p is None else float(top_p)
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got "
                             f"{top_k}")
        if not 0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id,
                      deadline_s=deadline_s if deadline_s else None,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      prng_key=self._base_key if seed is None else int(seed),
                      on_token=on_token, tenant=tenant,
                      prefill_only=prefill_only)
        if trace_id is not None:
            # set BEFORE scheduler.submit so the tracer adopts it as-is
            req.trace_id = trace_id
        self.scheduler.submit(req)
        self._drain_terminal_events()
        self._m_queue.set(self.scheduler.queue_depth)
        self._flush_events()
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel a request between dispatches; True if it transitioned
        to CANCELLED, False if it was already terminal.  A RUNNING
        request's computed blocks are commit-cached first, like a
        preemption."""
        with trace_span("serving/cancel", req=req.req_id):
            ok = self.scheduler.cancel(req)
        self._drain_terminal_events()
        self._update_gauges()
        self._flush_events()
        return ok

    def _drain_terminal_events(self) -> int:
        """Fold the scheduler's non-OK terminal transitions into the
        lifecycle counters (each counted once), close each stream with a
        tokenless terminal event and call the lifecycle hooks."""
        events = self.scheduler.terminal_events
        if not events:
            return 0
        self.scheduler.terminal_events = []
        by_status = {RequestStatus.CANCELLED: ("cancelled",
                                               self._m_cancelled),
                     RequestStatus.TIMED_OUT: ("timed_out",
                                               self._m_timed_out),
                     RequestStatus.SHED: ("shed", self._m_shed),
                     RequestStatus.FAILED: ("failed", self._m_failed)}
        for req in events:
            key, counter = by_status[req.status]
            counter.inc()
            self.lifecycle_counts[key] += 1
            logger.warning(f"serving: {req.req_id} -> {req.status.value}"
                           f"{': ' + req.error if req.error else ''}")
            self._event_buf.append(TokenEvent(
                request=req, token=None, index=len(req.output),
                status=req.status, final=True, tenant=req.tenant,
                time_s=time.perf_counter(),
                prev_time_s=req.last_token_time))
            for hook in self.lifecycle_hooks:
                try:
                    hook(req)
                except Exception as e:
                    logger.warning(
                        f"serving: lifecycle hook failed: {e!r}")
        return len(events)

    # ------------------------------------------------------------------
    # one dispatch of the mixed step
    # ------------------------------------------------------------------
    def _quarantine(self, slot: int, req: Request, where: str) -> None:
        """Non-finite logits in ``slot``: the request FAILS, its blocks
        are discarded (never registered in the prefix cache), and the
        batch continues."""
        msg = (f"non-finite logits at {where} (slot {slot}) after "
               f"{len(req.output)} tokens — request quarantined, KV "
               f"blocks discarded")
        if self._rt.enabled:
            self._rt.mark(req, "quarantine", where=where, slot=slot)
        with trace_span("serving/quarantine", req=req.req_id, slot=slot):
            self.scheduler.terminate_slot(slot, RequestStatus.FAILED, msg,
                                          discard=True)
        self._m_quarantined.inc()
        self.lifecycle_counts["quarantined"] += 1
        logger.error(f"serving: {req.req_id}: {msg}")

    @staticmethod
    def _sample(logits: torch.Tensor, reqs: List[Optional[Request]],
                offset: int = 0) -> torch.Tensor:
        """Row i samples for ``reqs[i]`` at output index ``len(output) +
        offset``; rows without a request take the argmax and are
        ignored."""
        return sample_tokens(
            logits, [r.prng_key if r else 0 for r in reqs],
            [len(r.output) + offset if r else 0 for r in reqs],
            [r.temperature if r else 0.0 for r in reqs],
            [r.top_k if r else 0 for r in reqs],
            [r.top_p if r else 1.0 for r in reqs])

    def _gather_results(self, local: torch.Tensor,
                        widths: Sequence[int]) -> list:
        """The dispatch's results as one host list: ``[token per slot |
        finite per slot | spec lane | chunk token, chunk finite]``, where
        ``widths`` are the values per slot of each slot-owned segment in
        order (the chunk's values follow them).  On a data-sharded mesh
        each rank holds its slots' values: one all-gather over ``data``
        puts every rank's together, segment by segment in slot order,
        and the chunk's values are data rank 0's (every data rank
        computed the same)."""
        if self.tp_data_size == 1:
            return local.tolist()
        rows = comm.all_gather(local, DATA_AXIS, axis=0,
                               tiled=False).tolist()
        out, pos = [], 0
        for w in widths:
            n = self.num_slots // self.tp_data_size * w
            out += [v for r in rows for v in r[pos:pos + n]]
            pos += n
        return out + rows[0][pos:]

    def _draft_propose(self, cache, decoding, reqs, dec_tokens, any_active,
                       spec_active, chunk_args) -> Optional[torch.Tensor]:
        """The draft's part of a dispatch, on its own pool: mirror the
        prefill chunk, write every decoding slot's token (feed 0), then
        with speculating slots run feeds 1..k at lengths ``lens + i``,
        proposal i drawn with the key and output index the target uses
        there.  Returns ``spec_tokens [B, S]`` (the last token, then the
        proposals) or None without a speculating slot."""
        draft, dp = self._draft_model, self._draft_params
        dcache = {"k": self._dpool_k, "v": self._dpool_v,
                  "block_tables": cache["block_tables"],
                  "lens": cache["lens"]}
        empty = dec_tokens[:0]
        if chunk_args is not None:
            draft._apply_paged_mixed(dp, dcache, empty, empty, *chunk_args)
        if not decoding:
            return None
        dlg, _, _ = draft._apply_paged_mixed(dp, dcache, dec_tokens,
                                             any_active, empty, 0, 0, 0)
        if spec_active is None:
            return None
        toks = [dec_tokens]
        lens = cache["lens"]
        for i in range(1, self.spec_k + 1):
            # feeds d_1 .. d_k; the last one only writes d_k's KV
            toks.append(self._sample(dlg, reqs, i - 1).to(dec_tokens.dtype))
            dlg, _, _ = draft._apply_paged_mixed(
                dp, dict(dcache, lens=lens + i), toks[-1], spec_active,
                empty, 0, 0, 0)
        return torch.stack(toks, dim=1)

    @torch.inference_mode()
    def _dispatch(self, dec: List[Tuple[int, Request]],
                  chunk: Optional[Tuple[int, Request, int, int]],
                  spec: Sequence[Tuple[int, Request]] = ()
                  ) -> Optional[int]:
        """One mixed step: a decode token for every slot in ``dec``, a
        draft + verify round for every slot in ``spec`` (draft armed
        only), plus (optionally) one prompt chunk; then apply the results
        to the requests.  Returns the progress made (tokens emitted +
        prefill tokens landed), or None when a transient fault at the
        ``serving.dispatch`` site skipped the dispatch (the caller
        abandons the iteration; the same work retries next step).  A
        fatal fault raises :class:`ServingError`."""
        try:
            get_fault_injector().check("serving.dispatch")
        except TransientIOError as e:
            logger.warning(f"serving: transient dispatch fault — "
                           f"iteration skipped, will retry: {e}")
            return None
        except FatalIOError as e:
            raise ServingError(
                f"fatal fault at serving dispatch: {e}") from e
        sched = self.scheduler
        dev = self.device
        B, S = self.num_slots, self.spec_k + 1
        draft_on = self._draft_model is not None
        # this rank's decode slots: all B, or its 1/data of them
        bl = B // self.tp_data_size
        lo = comm.axis_index(DATA_AXIS) * bl if self.tp_data_size > 1 else 0
        # a step with no plain-decoding slot passes a decode lane of
        # width 0 (the way a step without a chunk runs no prefill lane);
        # with the draft armed, its feed 0 takes every decoding slot
        n_dec = bl if dec else 0
        tables = np.zeros((B, self.max_pages), np.int32)
        lens = np.zeros((B,), np.int32)
        tokens = np.zeros((B,), np.int32)
        dec_active = np.zeros((B,), np.int32)
        spec_active = np.zeros((B,), np.int32)
        for slot, req in sched.running.items():
            table = self.allocator.block_table(req.req_id)
            tables[slot, :len(table)] = table
            lens[slot] = req.cached_tokens
        row_reqs: List[Optional[Request]] = [None] * B
        for slot, req in list(dec) + list(spec):
            tokens[slot] = req.output[-1]
            row_reqs[slot] = req
        for slot, _req in dec:
            dec_active[slot] = 1
        for slot, _req in spec:
            spec_active[slot] = 1
        c_slot = c_start = c_len = 0
        chunk_ids = np.zeros((0,), np.int32)
        if chunk is not None:
            c_slot, req, c_start, c_len = chunk
            chunk_ids = np.asarray(req.prefix[c_start:c_start + c_len],
                                   np.int32)
        ovl_on = self._ovl.enabled
        t0 = time.perf_counter()
        t_enq = t0
        with contextlib.ExitStack() as spans:
            if dec:
                spans.enter_context(
                    trace_span("serving/decode", batch=len(dec)))
            if spec:
                spans.enter_context(trace_span(
                    "serving/spec_decode", batch=len(spec), k=self.spec_k))
            if chunk is not None:
                spans.enter_context(
                    trace_span("serving/prefill_chunk", slot=c_slot,
                               start=c_start, tokens=c_len))
            mine = slice(lo, lo + bl)
            cache = {"k": self._pool_k, "v": self._pool_v,
                     "k_scale": self._pool_ks, "v_scale": self._pool_vs,
                     "block_tables": torch.from_numpy(tables[mine]).to(dev),
                     "lens": torch.from_numpy(lens[mine]).to(dev)}
            tokens_d = torch.from_numpy(tokens[mine]).to(dev)
            dec_active_d = torch.from_numpy(dec_active[mine]).to(dev)
            chunk_d = torch.from_numpy(chunk_ids).to(dev)
            chunk_args = (chunk_d, c_slot, c_start, c_len)
            spec_active_d = spec_tokens = None
            # the spec lane's rows are this rank's slots', as the decode
            # lane's are
            spec_reqs = [r if spec_active[i] else None
                         for i, r in enumerate(row_reqs)][mine]
            if spec:
                spec_active_d = torch.from_numpy(spec_active[mine]).to(dev)
            if draft_on:
                any_active = (torch.from_numpy((dec_active | spec_active)
                                               [mine]).to(dev))
                spec_tokens = self._draft_propose(
                    cache, bool(dec or spec), spec_reqs, tokens_d,
                    any_active, spec_active_d,
                    chunk_args if chunk is not None else None)
            dec_tok = tokens_d[:n_dec]
            dec_act = dec_active_d[:n_dec]
            params = self.engine._model_params()
            if spec:
                dec_logits, spec_logits, chunk_logits, _ = \
                    self.model._apply_paged_mixed(
                        params, cache, dec_tok, dec_act, *chunk_args,
                        spec_tokens=spec_tokens, spec_active=spec_active_d)
            else:
                dec_logits, chunk_logits, _ = self.model._apply_paged_mixed(
                    params, cache, dec_tok, dec_act, *chunk_args)
            # every result comes back in ONE device->host copy: [next
            # token per slot | finite per slot] for the decode lane,
            # [target samples per slot and depth | tokens to emit | spec
            # finite] for the spec lane, [chunk token, chunk finite]
            parts, widths = [], []
            if n_dec:
                dec_reqs = [r if dec_active[i] else None
                            for i, r in enumerate(row_reqs)][mine]
                parts += [self._sample(dec_logits, dec_reqs),
                          torch.isfinite(dec_logits).all(dim=-1).long()]
                widths += [1, 1]
            if spec:
                # the target samples s_i at every draft position with
                # that position's own key; d_i is accepted while it
                # equals s_{i-1}, so every accepted position saw exactly
                # the context and key the sequential sampler would have
                s = torch.stack([self._sample(spec_logits[:, i], spec_reqs, i)
                                 for i in range(S)], dim=1)
                matches = (spec_tokens[:, 1:].long() == s[:, :-1]).long()
                n_emit = 1 + torch.cumprod(matches, dim=1).sum(dim=1)
                parts += [s.reshape(-1), n_emit,
                          torch.isfinite(spec_logits).all(dim=-1)
                          .all(dim=-1).long()]
                widths += [S, 1, 1]
            if chunk is not None:
                parts += [self._sample(chunk_logits[None], [chunk[1]]),
                          torch.isfinite(chunk_logits).all()[None].long()]
            if ovl_on:
                # launches returned, nothing read back yet: the
                # enqueue/device-wait boundary of the overlap split
                t_enq = time.perf_counter()
            host = self._gather_results(torch.cat(parts), widths)
            n_dec = B if dec else 0
        # ITL = dispatch wall time only, before the host bookkeeping below
        dispatch_dt = time.perf_counter() - t0
        if ovl_on:
            self._ovl.note_dispatch(t_enq - t0, dispatch_dt - (t_enq - t0))
        self.counts["dispatches"] += 1
        if self._rt.enabled and dec:
            self._rt.on_decode([r for _, r in dec], t0, dispatch_dt,
                               len(dec))
        pos = 0
        nxt_h = host[pos:pos + n_dec]
        fin_h = host[pos + n_dec:pos + 2 * n_dec]
        pos += 2 * n_dec
        progress = 0
        for slot, req in dec:
            if not fin_h[slot]:
                # quarantine BEFORE any commit: the row this dispatch
                # wrote is suspect and must not register in the cache
                self._quarantine(slot, req, "decode")
                continue
            req.cached_tokens += 1
            tok = int(nxt_h[slot])
            req.output.append(tok)
            self._emit_token(req, tok)
            progress += 1
            if req.cached_tokens % self.block_size == 0:
                # a decode-filled block just completed: register it so a
                # preemption (or an identical resubmission) stays warm
                self.allocator.commit_cached(req.req_id, req.prefix,
                                             req.cached_tokens)
            if req.done:
                sched.finish(slot)
        if spec:
            emitted = host[pos:pos + B * S]
            n_emit_h = host[pos + B * S:pos + B * S + B]
            spec_fin = host[pos + B * S + B:pos + B * S + 2 * B]
            pos += B * S + 2 * B
        for slot, req in spec:
            if not spec_fin[slot]:
                self._quarantine(slot, req, "spec decode")
                continue
            # the KV rollback is the length vector: positions past
            # lens + appended were written by rejected draft rows but are
            # never attended (and are rewritten before they can be)
            take = min(int(n_emit_h[slot]),
                       req.max_new_tokens - len(req.output))
            appended = 0
            for j in range(take):
                tok = int(emitted[slot * S + j])
                req.output.append(tok)
                self._emit_token(req, tok)
                appended += 1
                if req.done:
                    break
            old = req.cached_tokens
            req.cached_tokens += appended
            progress += appended
            if self._rt.enabled:
                self._rt.on_spec([req], t0, dispatch_dt, self.spec_k,
                                 max(0, appended - 1))
            self.spec_counts["proposed"] += self.spec_k
            self._m_spec_proposed.inc(self.spec_k)
            if appended > 1:
                self.spec_counts["accepted"] += appended - 1
                self._m_spec_accepted.inc(appended - 1)
            if req.cached_tokens // self.block_size \
                    > old // self.block_size:
                self.allocator.commit_cached(req.req_id, req.prefix,
                                             req.cached_tokens)
            if req.done:
                sched.finish(slot)
        if dec or spec:
            # exemplar: any batch participant experienced this latency
            self._m_itl.observe(dispatch_dt,
                                exemplar=(dec[0][1].trace_id if dec
                                          else spec[0][1].trace_id))
            for h in self.mirror_hists.get("itl", ()):
                h.observe(dispatch_dt)
            if progress:
                self._m_tokens.inc(progress)
        self.counts["tokens"] += progress
        if chunk is not None:
            req = chunk[1]
            if not host[-1]:
                self._quarantine(chunk[0], req, "prefill chunk")
            else:
                req.cached_tokens += c_len
                progress += c_len
                self.counts["prefill_tokens"] += c_len
                self._m_prefill_tokens.inc(c_len)
                self.allocator.commit_cached(req.req_id, req.prefix,
                                             req.cached_tokens)
                if self._rt.enabled:
                    self._rt.on_prefill_chunk(
                        req, t0, dispatch_dt, c_start, c_len,
                        done=req.cached_tokens >= req.prefill_target)
                if (req.cached_tokens >= req.prefill_target
                        and req.prefill_only):
                    # prefill leg of a disaggregated handoff: publish the
                    # chain, finish OK, emit no token — the decode leg
                    # samples output index 0 with the same pinned key,
                    # so the stream is a one-replica run's
                    self._finish_prefill_only(chunk[0], req)
                elif req.cached_tokens >= req.prefill_target:
                    # the chunk that completes the prefix carries the
                    # first token, drawn at output index len(output) with
                    # the request's own key — the token a decode step
                    # would have produced
                    tok = int(host[-2])
                    req.output.append(tok)
                    self._emit_token(req, tok)
                    self.counts["tokens"] += 1
                    self._m_tokens.inc()
                    if req.first_token_time is None:
                        req.first_token_time = time.perf_counter()
                        self._m_ttft.observe(
                            req.first_token_time - req.submit_time,
                            exemplar=req.trace_id)
                        for h in self.mirror_hists.get("ttft", ()):
                            h.observe(req.first_token_time
                                      - req.submit_time)
                    if req.done:
                        sched.finish(chunk[0])
        return progress

    # ------------------------------------------------------------------
    # one scheduler iteration
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One continuous-batching iteration: sweep deadlines, guarantee
        KV capacity for decoding slots (preempting under pressure),
        admit, then dispatch decode (and speculative) rows with prefill
        chunks within the chunk token budget.  Returns True while work
        remains.  After ``serving.no_progress_steps`` consecutive
        iterations that moved nothing while work remained, raises
        :class:`ServingError` (the flight recorder, when on, dumps its
        post-mortem bundle first).  On a serving mesh every rank steps
        together: the iteration's collectives run over this engine's own
        process groups."""
        try:
            with comm.use_mesh(self.lockstep.mesh):
                result = self._step_impl()
            # iteration boundary reached with the loop alive: the
            # liveness beat (rate-limited inside maybe_beat)
            self.heartbeat.maybe_beat()
            return result
        except ServingError as e:
            if self._fr.enabled:
                self._fr.dump("serving_error", str(e), extra={
                    "diagnose": self._diagnose("engine state at failure")})
            raise

    def _speculating(self, dec: List[Tuple[int, Request]]
                     ) -> Tuple[List[Tuple[int, Request]],
                                List[Tuple[int, Request]]]:
        """Split decoding slots into (plain, speculating): a slot
        speculates when it wants at least 2 more tokens, fits ``spec_k +
        1`` more positions and its table grows to cover them without
        preempting anyone (``try_grow``); a slot ``try_grow`` failed
        fatally drops out, the rest decode plainly."""
        S = self.spec_k + 1
        limit = min(self.engine.config.max_out_tokens,
                    self.scheduler.max_tokens_per_seq())
        plain, spec = [], []
        for slot, req in dec:
            if (req.max_new_tokens - len(req.output) >= 2
                    and req.cached_tokens + S <= limit
                    and self.scheduler.try_grow(slot, S)):
                spec.append((slot, req))
            elif req.state is RequestState.RUNNING:
                plain.append((slot, req))
        return plain, spec

    def _step_impl(self) -> bool:
        sched = self.scheduler
        if self._ovl.enabled:
            self._ovl.begin()
        finished_before = len(sched.finished)
        # the decisions that read this process's clock: rank 0's for
        # every rank of a mesh, this rank's own at 1 x 1
        sched.sweep_deadlines(expired=self._decide())
        # capacity BEFORE admission: running sequences claim their next
        # block first, so a fresh admission is never immediately the
        # preemption victim
        for req in sched.ensure_decode_capacity():
            self.counts["preemptions"] += 1
            self._m_preempt.inc()
            logger.info(f"serving: preempted {req.req_id} on KV pressure "
                        f"({req.preemptions} time(s))")
        sched.schedule_admissions()
        # land queued host->pool promotions in the admission window:
        # PROMOTING requests are held out of next_prefill_chunk until
        # their claimed blocks carry real KV again
        promoted = self._service_promotions()
        self._drain_terminal_events()
        self._update_gauges()
        # a landed promotion MOVED state (the request it unblocks may
        # only prefill next iteration): a promote-only iteration never
        # trips the watchdog
        progress = promoted
        budget = self.chunk_tokens
        include_decode = True
        while True:
            chunk = sched.next_prefill_chunk(budget)
            dec = sched.decoding_slots() if include_decode else []
            spec: List[Tuple[int, Request]] = []
            if dec and self._draft_model is not None:
                dec, spec = self._speculating(dec)
            if not dec and not spec and chunk is None:
                break
            dispatched = self._dispatch(dec, chunk, spec)
            if dispatched is None:
                # transient dispatch fault: abandon the iteration — the
                # chunk budget was NOT charged and the same work retries
                break
            progress += dispatched
            include_decode = False
            if chunk is None:
                break
            budget -= chunk[3]
            if budget <= 0:
                break
        self._drain_terminal_events()
        self._update_gauges()
        # one flush per iteration boundary, in emission order
        self._flush_events()
        if self._fr.enabled:
            self._fr.record(self._flight_snapshot())
        # terminal transitions count as progress; preemptions do not (a
        # preemption-only iteration is the livelock signature)
        n_finished = len(sched.finished) - finished_before
        progress += n_finished
        self._update_drain_rate(n_finished)
        if progress or not sched.has_work:
            self._no_progress = 0
        else:
            self._no_progress += 1
            if self.no_progress_steps and \
                    self._no_progress >= self.no_progress_steps:
                raise ServingError(self._diagnose(
                    f"serving made no progress for {self._no_progress} "
                    f"consecutive iterations (zero tokens, zero prefill, "
                    f"zero terminal transitions) — scheduler wedged or "
                    f"every dispatch faulted"))
        if self._ovl.enabled:
            self._ovl.end("serving")
        return sched.has_work

    def _decide(self) -> Optional[list]:
        """On a mesh, rank 0's decisions of this iteration on every rank
        (one broadcast), each ``lockstep_hooks`` entry applied against
        the live requests they were taken over, before the deadline
        sweep; returns the ``(request, reason)`` pairs to time out.  None
        at 1 x 1."""
        if not self.lockstep.active:
            return None
        live = self.scheduler.live()
        with trace_span("serving/decide"):
            decision = self.lockstep.decide(self._propose)
        self._m_decisions.inc()
        for name, (_, apply) in self.lockstep_hooks.items():
            apply(decision[name], live)
        return [(live[i], why) for i, why in decision["expire"]]

    def _propose(self) -> dict:
        """Rank 0's decisions at this iteration boundary: the requests
        whose deadline has passed, and each hook's, all at one reading
        of its clock."""
        now = time.perf_counter()
        decision = {"expire": self.scheduler.expired(now)}
        for name, (propose, _) in self.lockstep_hooks.items():
            decision[name] = propose(now)
        return decision

    def _update_drain_rate(self, n_finished: int) -> None:
        """EMA of wall seconds per FINISHED request: the drain rate
        behind the SHED ``retry_after_s`` hint."""
        if n_finished <= 0:
            return
        now = time.perf_counter()
        if self._last_finish_t is not None:
            per = (now - self._last_finish_t) / n_finished
            self._drain_rate_ema = per if self._drain_rate_ema is None \
                else 0.7 * self._drain_rate_ema + 0.3 * per
        self._last_finish_t = now

    def _estimate_retry_after(self) -> float:
        return estimate_retry_after_s(self._drain_rate_ema)

    def _flight_snapshot(self) -> dict:
        """One flight-recorder frame: plain host-side ints."""
        sched, alloc = self.scheduler, self.allocator
        return {
            "t": time.perf_counter(),
            "queue_depth": sched.queue_depth,
            "active_slots": sched.active_slots,
            "pool_used": alloc.num_used,
            "pool_free": alloc.num_free,
            "pool_cached": alloc.num_cached,
            "preemptions": sched.preemption_count,
            "pinned": sum(1 for r in sched.running.values()
                          if sched.pinned(r)),
            "no_progress": self._no_progress,
            "lifecycle": dict(self.lifecycle_counts),
            "spec": dict(self.spec_counts),
            "dispatches": self.counts["dispatches"],
            "host_pending": alloc.num_pending,
            "host": dict(self.host_counts),
        }

    def _update_gauges(self) -> None:
        self._m_queue.set(self.scheduler.queue_depth)
        self._m_active.set(self.scheduler.active_slots)
        self._m_blocks.set(self.allocator.num_used)
        self._m_cached.set(self.allocator.num_cached)
        d = self.allocator.hit_tokens_total - self._hits_polled
        if d:
            self._m_hit_tokens.inc(d)
            self._hits_polled += d
        d = self.allocator.evictions_total - self._evictions_polled
        if d:
            self._m_evictions.inc(d)
            self._evictions_polled += d
        hc = self.host_cache
        if hc is None:
            return
        hp = self._host_polled
        for key, counter, cur in (
                ("spills", self._m_host_spills, hc.spills_total),
                ("demotions", self._m_host_demotions, hc.demotions_total),
                ("evictions", self._m_host_evictions, hc.evictions_total),
                ("dram_hits", self._m_host_dram_hits,
                 hc.hits_total.get("dram", 0)),
                ("nvme_hits", self._m_host_nvme_hits,
                 hc.hits_total.get("nvme", 0)),
                ("hit_tokens", self._m_host_hit_tokens,
                 self.allocator.host_hit_tokens_total)):
            d = cur - hp[key]
            if d:
                counter.inc(d)
                hp[key] += d
        tiers = hc.tier_names
        if "dram" in tiers:
            self._m_host_dram_bytes.set(hc.resident_bytes("dram"))
        if "nvme" in tiers:
            self._m_host_nvme_bytes.set(hc.resident_bytes("nvme"))
        self._m_promote_depth.set(self.allocator.num_pending)

    def _diagnose(self, headline: str) -> str:
        sched, alloc = self.scheduler, self.allocator
        lines = [headline,
                 f"  queue_depth={sched.queue_depth} "
                 f"active_slots={sched.active_slots}/{self.num_slots} "
                 f"pool used={alloc.num_used} free={alloc.num_free} "
                 f"cached={alloc.num_cached} of {alloc.usable_blocks}"]
        for slot, req in sorted(sched.running.items()):
            lines.append(
                f"  slot {slot}: {req.req_id} cached={req.cached_tokens}"
                f"/{req.prefill_target} out={len(req.output)}"
                f"/{req.max_new_tokens} preemptions={req.preemptions}"
                f"{' PINNED' if sched.pinned(req) else ''}")
        for req in list(sched.waiting)[:8]:
            lines.append(f"  waiting: {req.req_id} "
                         f"prompt={len(req.prompt)} "
                         f"preemptions={req.preemptions}")
        if sched.queue_depth > 8:
            lines.append(f"  ... and {sched.queue_depth - 8} more waiting")
        return "\n".join(lines)

    def _default_max_steps(self) -> int:
        """A generous drain bound from the queued work (serial prefill +
        decode of every request, times a preemption allowance): hitting
        it means a scheduler bug, never a healthy drain."""
        sched = self.scheduler
        work = list(sched.waiting) + list(sched.running.values())
        if not work:
            return 1
        steps = 0
        for r in work:
            prefix = len(r.prompt) + r.max_new_tokens
            steps += -(-prefix // self.chunk_tokens) + r.max_new_tokens + 2
            if self.host_cache is not None:
                # a fully host-warm prefix promotes promote_parallelism
                # blocks per iteration while the request waits PROMOTING
                steps += -(-prefix // self.block_size)
        allowance = (sched.max_preemptions or 8) + 1
        return steps * allowance + 64

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drain the queue; returns every terminal request (check
        ``req.status``).  Raises :class:`ServingError` if the queue does
        not drain within ``max_steps`` (default: a generous bound from
        the queued work) and :class:`BlockPoolError` if any block is
        still held afterwards."""
        if max_steps is None:
            max_steps = self._default_max_steps()
        steps = 0
        while self.step():
            steps += 1
            if steps >= max_steps:
                msg = self._diagnose(
                    f"serving did not drain within {max_steps} steps")
                if self._fr.enabled:
                    self._fr.dump("serving_error", msg)
                raise ServingError(msg)
        self.allocator.assert_consistent()
        if self.allocator.num_used:
            raise BlockPoolError(
                f"{self.allocator.num_used} KV blocks still held after "
                f"drain — scheduler leak")
        return list(self.scheduler.finished)

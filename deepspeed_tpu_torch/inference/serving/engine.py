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

Where the JAX engine compiles one program with fixed lane widths, this
one runs eagerly and passes only the lanes a dispatch has: a step
without a chunk runs no prefill lane, one with no plain-decoding slot
no decode lane, one with no speculating slot no spec lane and no draft
feed past the first; every dispatch still ends in one device-to-host
copy.  Not in the port yet: the tensor-parallel serving mesh (ROADMAP.md
queue A item 7), the tiered host cache, the replica fleet and its
prefill/decode roles (queue A item 4, second part).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...models.convert import leaf_to_torch, tree_map
from ...observability import (get_flight_recorder, get_overlap_profiler,
                              get_registry, get_request_tracer, trace_span)
from ...runtime.resilience.errors import (FatalIOError, ServingError,
                                          TransientIOError)
from ...runtime.resilience.fault_injection import get_fault_injector
from ...runtime.resilience.heartbeat import Heartbeat
from ...utils.logging import logger
from ..sampling import sample_tokens
from .block_allocator import BlockPoolError, PagedBlockAllocator
from .frontend.streaming import TokenEvent
from .scheduler import (ContinuousBatchingScheduler, Request, RequestState,
                        RequestStatus, estimate_retry_after_s)

#: what the next slice of queue A item 4 brings
_NEXT = "ROADMAP.md queue A item 4, second part"


def _refuse_out_of_slice(cfg, shared_host_cache=None,
                         role: str = "mixed") -> None:
    later = []
    if cfg.mesh.data != 1 or cfg.mesh.model != 1:
        later.append("serving.mesh beyond 1x1 (multi-device serving, "
                     "ROADMAP.md queue A item 7)")
    if cfg.host_cache.enabled:
        later.append(f"serving.host_cache (the tiered host prefix cache "
                     f"and its KV wire codec, {_NEXT})")
    if shared_host_cache is not None:
        later.append(f"shared_host_cache (the fleet's shared host tier, "
                     f"{_NEXT})")
    if cfg.fleet.enabled:
        later.append(f"serving.fleet (replica fleet, {_NEXT})")
    if role != "mixed":
        if role not in ("prefill", "decode"):
            raise ValueError(f"serving role must be 'mixed', 'prefill' or "
                             f"'decode', got {role!r}")
        later.append(f"role={role!r} (the disaggregated fleet's replica "
                     f"classes, {_NEXT})")
    if later:
        raise NotImplementedError(
            f"{', '.join(later)}: not in the slices of the PyTorch port so "
            f"far")


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
                 shared_host_cache=None, role: str = "mixed"):
        cfg = engine.config.serving
        _refuse_out_of_slice(cfg, shared_host_cache, role)
        model = engine.module
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

        #: plain-int counters beside the metrics registry: tokens emitted,
        #: prompt tokens computed, preemptions, dispatches
        self.counts = {"tokens": 0, "prefill_tokens": 0, "preemptions": 0,
                       "dispatches": 0}
        self.lifecycle_counts = {"cancelled": 0, "timed_out": 0,
                                 "shed": 0, "failed": 0, "quarantined": 0}
        #: acceptance_rate = accepted / proposed
        self.spec_counts = {"proposed": 0, "accepted": 0}
        self._register_metrics()
        # counter deltas are polled off the allocator's cumulative ints
        self._hits_polled = 0
        self._evictions_polled = 0

    def _register_metrics(self) -> None:
        """The JAX engine's ``dstpu_serving_*`` series but those of the
        host cache, the KV fabric and the serving mesh."""
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

    @property
    def kv_pool_bytes(self) -> int:
        """Device memory held by the paged KV pool: values plus the
        dequant scale planes when quantized."""
        pools = [self._pool_k, self._pool_v]
        if self._pool_ks is not None:
            pools += [self._pool_ks, self._pool_vs]
        return sum(t.numel() * t.element_size() for t in pools)

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
        as they are, with no copy."""
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
        accounting; ``trace_id`` is adopted by the request tracer.
        ``prefill_only`` (the disaggregated fleet's prefill leg) needs the
        KV fabric of the next slice and raises."""
        if prefill_only:
            raise NotImplementedError(
                f"prefill_only (the disaggregated fleet's prefill leg over "
                f"the KV fabric, {_NEXT}): not in the slices of the "
                f"PyTorch port so far")
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
                      on_token=on_token, tenant=tenant)
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
        # a step with no plain-decoding slot passes a decode lane of
        # width 0 (the way a step without a chunk runs no prefill lane);
        # with the draft armed, its feed 0 takes every decoding slot
        n_dec = B if dec else 0
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
            cache = {"k": self._pool_k, "v": self._pool_v,
                     "k_scale": self._pool_ks, "v_scale": self._pool_vs,
                     "block_tables": torch.from_numpy(tables).to(dev),
                     "lens": torch.from_numpy(lens).to(dev)}
            tokens_d = torch.from_numpy(tokens).to(dev)
            dec_active_d = torch.from_numpy(dec_active).to(dev)
            chunk_d = torch.from_numpy(chunk_ids).to(dev)
            chunk_args = (chunk_d, c_slot, c_start, c_len)
            spec_active_d = spec_tokens = None
            spec_reqs = [r if spec_active[i] else None
                         for i, r in enumerate(row_reqs)]
            if spec:
                spec_active_d = torch.from_numpy(spec_active).to(dev)
            if draft_on:
                any_active = (torch.from_numpy(dec_active | spec_active)
                              .to(dev))
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
            parts = []
            if n_dec:
                dec_reqs = [r if dec_active[i] else None
                            for i, r in enumerate(row_reqs)]
                parts += [self._sample(dec_logits, dec_reqs),
                          torch.isfinite(dec_logits).all(dim=-1).long()]
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
            if chunk is not None:
                parts += [self._sample(chunk_logits[None], [chunk[1]]),
                          torch.isfinite(chunk_logits).all()[None].long()]
            if ovl_on:
                # launches returned, nothing read back yet: the
                # enqueue/device-wait boundary of the overlap split
                t_enq = time.perf_counter()
            host = torch.cat(parts).tolist()
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
                if req.cached_tokens >= req.prefill_target:
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
        post-mortem bundle first)."""
        try:
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
        sched.sweep_deadlines()
        # capacity BEFORE admission: running sequences claim their next
        # block first, so a fresh admission is never immediately the
        # preemption victim
        for req in sched.ensure_decode_capacity():
            self.counts["preemptions"] += 1
            self._m_preempt.inc()
            logger.info(f"serving: preempted {req.req_id} on KV pressure "
                        f"({req.preemptions} time(s))")
        sched.schedule_admissions()
        self._drain_terminal_events()
        self._update_gauges()
        progress = 0
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

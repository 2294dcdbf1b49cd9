"""Continuous-batching serving engine of the port: the device half.

Counterpart of the core of ``deepspeed_tpu/inference/serving/engine.py``:
``submit()`` queues requests, every ``step()`` sweeps deadlines, grows
block tables (preempting under KV pressure), admits, and dispatches the
mixed step: one decode token for every live slot plus up to
``prefill_chunk_tokens`` of one prompt chunk, through the model's
``_apply_paged_mixed`` (kernels B6 and B7 over the paged pool, which
``serving.kv_cache_bits`` 8 or 4 stores as int8 or packed int4 with f32
scales beside it; with ``quant.enabled`` the step takes the engine's
int8 weights through ``_model_params``).  Sampling
is per request and per output index (``inference/sampling.py``), so a
stream is reproducible across batch composition and preemption and,
greedy, token-identical to ``generate()``.  A slot whose logits turn
non-finite is quarantined alone: it fails, its KV never reaches the
prefix cache, the batch continues.

Where the JAX engine compiles one program with a fixed chunk width, this
one runs eagerly and passes only the chunk's valid tokens; a step
without a chunk runs no prefill lane, and one with no decoding slot no
decode lane.  Not in this slice: the
speculative lane, tensor-parallel mesh, tiered host cache, streaming
front end, fleet, heartbeat and observability hooks.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...runtime.resilience.errors import ServingError
from ...utils.logging import logger
from ..sampling import sample_tokens
from .block_allocator import BlockPoolError, PagedBlockAllocator
from .scheduler import (ContinuousBatchingScheduler, Request, RequestStatus,
                        estimate_retry_after_s)


def _refuse_out_of_slice(cfg) -> None:
    later = []
    if cfg.mesh.data != 1 or cfg.mesh.model != 1:
        later.append("serving.mesh beyond 1x1 (multi-device serving, "
                     "ROADMAP.md queue A item 7)")
    if cfg.host_cache.enabled:
        later.append("serving.host_cache (the tiered host prefix cache "
                     "and its KV wire codec, ROADMAP.md queue A item 4)")
    if cfg.fleet.enabled:
        later.append("serving.fleet (replica fleet, ROADMAP.md queue A "
                     "item 4)")
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
        srv = eng.serving_engine()
        reqs = [srv.submit(p, max_new_tokens=64) for p in prompts]
        srv.run()                      # drain
        streams = [r.output for r in reqs]
    """

    def __init__(self, engine, seed: Optional[int] = None):
        cfg = engine.config.serving
        _refuse_out_of_slice(cfg)
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
        #: KV-cache width: 0 = engine dtype, 8 = int8, 4 = packed int4
        self.kv_bits = cfg.kv_cache_bits
        pools = model.init_paged_cache(cfg.num_kv_blocks, self.block_size,
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
        #: plain-int counters (the JAX engine's metrics registry is a
        #: later slice): tokens emitted, prompt tokens computed,
        #: preemptions, dispatches, and the non-OK terminals
        self.counts = {"tokens": 0, "prefill_tokens": 0, "preemptions": 0,
                       "dispatches": 0}
        self.lifecycle_counts = {"cancelled": 0, "timed_out": 0,
                                 "shed": 0, "failed": 0, "quarantined": 0}
        self._drain_rate_ema: Optional[float] = None
        self._last_finish_t: Optional[float] = None

    @property
    def kv_pool_bytes(self) -> int:
        """Device memory held by the paged KV pool: values plus the
        dequant scale planes when quantized."""
        pools = [self._pool_k, self._pool_v]
        if self._pool_ks is not None:
            pools += [self._pool_ks, self._pool_vs]
        return sum(t.numel() * t.element_size() for t in pools)

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None) -> Request:
        """Queue a request.  ``deadline_s`` is a TTL from submit swept
        every ``step()`` (default ``serving.default_deadline_s``; 0 =
        none).  Under overload (``serving.max_queue_depth`` waiting) the
        request comes back terminal with ``status == RequestStatus.SHED``.
        Sampling params default to the inference config; ``seed`` is the
        request's key (None = the engine's base key, matching an
        unseeded ``generate()``)."""
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
                      prng_key=self._base_key if seed is None else int(seed))
        self.scheduler.submit(req)
        self._drain_terminal_events()
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel a request between dispatches; True if it transitioned
        to CANCELLED, False if it was already terminal."""
        ok = self.scheduler.cancel(req)
        self._drain_terminal_events()
        return ok

    def _drain_terminal_events(self) -> int:
        events = self.scheduler.terminal_events
        if not events:
            return 0
        self.scheduler.terminal_events = []
        keys = {RequestStatus.CANCELLED: "cancelled",
                RequestStatus.TIMED_OUT: "timed_out",
                RequestStatus.SHED: "shed", RequestStatus.FAILED: "failed"}
        for req in events:
            self.lifecycle_counts[keys[req.status]] += 1
            logger.warning(f"serving: {req.req_id} -> {req.status.value}"
                           f"{': ' + req.error if req.error else ''}")
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
        self.scheduler.terminate_slot(slot, RequestStatus.FAILED, msg,
                                      discard=True)
        self.lifecycle_counts["quarantined"] += 1
        logger.error(f"serving: {req.req_id}: {msg}")

    @staticmethod
    def _sample(logits: torch.Tensor, reqs: List[Optional[Request]]
                ) -> torch.Tensor:
        """Row i samples for ``reqs[i]`` at its next output index; rows
        without a request take the argmax and are ignored."""
        return sample_tokens(
            logits, [r.prng_key if r else 0 for r in reqs],
            [len(r.output) if r else 0 for r in reqs],
            [r.temperature if r else 0.0 for r in reqs],
            [r.top_k if r else 0 for r in reqs],
            [r.top_p if r else 1.0 for r in reqs])

    @torch.inference_mode()
    def _dispatch(self, dec: List[Tuple[int, Request]],
                  chunk: Optional[Tuple[int, Request, int, int]]) -> int:
        """One mixed step: a decode token for every slot in ``dec`` plus
        (optionally) one prompt chunk; then apply the results to the
        requests.  Returns the progress made (decode tokens emitted +
        prefill tokens landed)."""
        sched = self.scheduler
        dev = self.device
        # a step with no decoding slot passes a decode lane of width 0
        # (the way a step without a chunk runs no prefill lane)
        n_dec = self.num_slots if dec else 0
        tables = np.zeros((self.num_slots, self.max_pages), np.int32)
        lens = np.zeros((self.num_slots,), np.int32)
        dec_tokens = np.zeros((n_dec,), np.int32)
        dec_active = np.zeros((n_dec,), np.int32)
        for slot, req in sched.running.items():
            table = self.allocator.block_table(req.req_id)
            tables[slot, :len(table)] = table
            lens[slot] = req.cached_tokens
        for slot, req in dec:
            dec_tokens[slot] = req.output[-1]
            dec_active[slot] = 1
        c_slot = c_start = c_len = 0
        chunk_ids = np.zeros((0,), np.int32)
        if chunk is not None:
            c_slot, req, c_start, c_len = chunk
            chunk_ids = np.asarray(req.prefix[c_start:c_start + c_len],
                                   np.int32)
        cache = {"k": self._pool_k, "v": self._pool_v,
                 "k_scale": self._pool_ks, "v_scale": self._pool_vs,
                 "block_tables": torch.from_numpy(tables).to(dev),
                 "lens": torch.from_numpy(lens).to(dev)}
        dec_logits, chunk_logits, _ = self.model._apply_paged_mixed(
            self.engine._model_params(), cache,
            torch.from_numpy(dec_tokens).to(dev),
            torch.from_numpy(dec_active).to(dev),
            torch.from_numpy(chunk_ids).to(dev), c_slot, c_start, c_len)
        self.counts["dispatches"] += 1
        # per-slot finite flags and tokens come back in ONE device->host
        # copy: [next token per slot | finite per slot | chunk token,
        # chunk finite]
        dec_reqs: List[Optional[Request]] = [None] * n_dec
        for slot, req in dec:
            dec_reqs[slot] = req
        parts = []
        if n_dec:
            parts += [self._sample(dec_logits, dec_reqs),
                      torch.isfinite(dec_logits).all(dim=-1).long()]
        if chunk is not None:
            first = self._sample(chunk_logits[None], [chunk[1]])
            parts += [first, torch.isfinite(chunk_logits).all()[None].long()]
        host = torch.cat(parts).tolist()
        nxt_h = host[:n_dec]
        fin_h = host[n_dec:2 * n_dec]
        progress = 0
        for slot, req in dec:
            if not fin_h[slot]:
                # quarantine BEFORE any commit: the row this dispatch
                # wrote is suspect and must not register in the cache
                self._quarantine(slot, req, "decode")
                continue
            req.cached_tokens += 1
            req.output.append(int(nxt_h[slot]))
            progress += 1
            if req.cached_tokens % self.block_size == 0:
                # a decode-filled block just completed: register it so a
                # preemption (or an identical resubmission) stays warm
                self.allocator.commit_cached(req.req_id, req.prefix,
                                             req.cached_tokens)
            if req.done:
                sched.finish(slot)
        self.counts["tokens"] += progress
        if chunk is not None:
            req = chunk[1]
            if not host[-1]:
                self._quarantine(chunk[0], req, "prefill chunk")
            else:
                req.cached_tokens += c_len
                progress += c_len
                self.counts["prefill_tokens"] += c_len
                self.allocator.commit_cached(req.req_id, req.prefix,
                                             req.cached_tokens)
                if req.cached_tokens >= req.prefill_target:
                    # the chunk that completes the prefix carries the
                    # first token, drawn at output index len(output) with
                    # the request's own key — the token a decode step
                    # would have produced
                    req.output.append(int(host[-2]))
                    self.counts["tokens"] += 1
                    if req.first_token_time is None:
                        req.first_token_time = time.perf_counter()
                    if req.done:
                        sched.finish(chunk[0])
        return progress

    # ------------------------------------------------------------------
    # one scheduler iteration
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One continuous-batching iteration: sweep deadlines, guarantee
        KV capacity for decoding slots (preempting under pressure),
        admit, then dispatch decode + prefill chunks within the chunk
        token budget.  Returns True while work remains.  After
        ``serving.no_progress_steps`` consecutive iterations that moved
        nothing while work remained, raises :class:`ServingError`."""
        sched = self.scheduler
        finished_before = len(sched.finished)
        sched.sweep_deadlines()
        # capacity BEFORE admission: running sequences claim their next
        # block first, so a fresh admission is never immediately the
        # preemption victim
        for req in sched.ensure_decode_capacity():
            self.counts["preemptions"] += 1
            logger.info(f"serving: preempted {req.req_id} on KV pressure "
                        f"({req.preemptions} time(s))")
        sched.schedule_admissions()
        self._drain_terminal_events()
        progress = 0
        budget = self.chunk_tokens
        include_decode = True
        while True:
            chunk = sched.next_prefill_chunk(budget)
            dec = sched.decoding_slots() if include_decode else []
            if not dec and chunk is None:
                break
            progress += self._dispatch(dec, chunk)
            include_decode = False
            if chunk is None:
                break
            budget -= chunk[3]
            if budget <= 0:
                break
        self._drain_terminal_events()
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
                    f"zero terminal transitions) — scheduler wedged"))
        return sched.has_work

    def _update_drain_rate(self, n_finished: int) -> None:
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
                raise ServingError(self._diagnose(
                    f"serving did not drain within {max_steps} steps"))
        self.allocator.assert_consistent()
        if self.allocator.num_used:
            raise BlockPoolError(
                f"{self.allocator.num_used} KV blocks still held after "
                f"drain — scheduler leak")
        return list(self.scheduler.finished)

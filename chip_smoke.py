#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: every kernel in ``deepspeed_tpu_torch/csrc`` with ``nvcc``
   (timed as set-up);
3. each kernel against its plain PyTorch version at the slices' shapes
   (serving: GPT-3 6.7B heads, H=32, D=128; training: GPT-2 125M
   attention, B*H = 64 x 12, T = 1024, D = 64, and TinyLlama-1.1B
   attention, B*H = 8 x 32 query heads over B*KVH = 8 x 4 kv heads,
   T = 2048, D = 64, also at a ragged T (2000), without the causal mask
   and with one kv head per query head; bf16), with its time, the plain
   version's time, one PyTorch library call's time where one computes
   the same function, and the least time the card could take; B1 and
   B2 must give the same bits on two launches; B2's time is the
   wrapper's call, which computes delta = rowsum(dO * O) in eager
   PyTorch, and that rowsum and the kernel alone are timed beside it,
   as is the kernel's other layout, two launches (B3 then B4 at g = 1);
   first, the bf16 B1, B2, B3, B4, B8, B9 and B10 must show tensor-core
   instructions (``HMMA``) in ``cuobjdump -sass`` of their libraries and
   no ptxas spill at D 64 (registers and spills printed for every head
   dim), and the bf16 B7 (``paged_prefill_mma_kernel``) ``HMMA`` and no
   spill at D 64 and 128 for kv_bits 0, 8 and 4 (its registers and B6's
   cluster kernel's printed); B5-B7 must give the same bits on two
   launches;
4. ``init_inference(TransformerLM(gpt2_config("6.7b")))`` with random
   weights from seed 0, then ``generate()`` on 8 prompts of 128 tokens,
   64 new tokens, greedy: every decode step goes through kernel B5;
   then ``forward()`` on the same prompts through kernel B1, its
   last-position logits checked against ``generate()``'s prefill;
5. the continuous-batching server on the same engine: 16 greedy requests
   with prompt lengths 16-512, 32 new tokens each, drained with
   ``run()``: decode through kernel B6, prompt chunks through kernel B7,
   each exactly once a layer for each mixed step with a decode lane or a
   chunk; first-step logits of 4 requests checked against
   ``generate()``'s, every greedy stream equal to ``generate()``'s up to
   a near tie, the peak device memory printed; the
   profiles of a short burst and of the drain run again on fresh prompts
   print the device time and B6's and B7's shares of it;
6. training: ``initialize`` on GPT-2 125M (all 12 layers, seq 1024,
   ``remat="full"``, flash attention, fused loss head at chunk 256) with
   ``bench.py``'s config (micro batch 64, AdamW, bf16 over f32 masters,
   clipping 1.0), weights from seed 0, 10 ``train_step``s (20 until
   phase 31 came, for the run's time) on one seeded
   batch: every layer's forward (twice, with the remat recompute) runs
   kernel B1 and its backward kernel B2 (the profile prints their shares
   of the step's device time); then the same step with plain
   attention at micro batch 8 for 3 steps, checked against the kernels';
7. training TinyLlama-1.1B (``hf_llama_config`` on its published
   config: all 22 layers, d_model 2048, 32 query heads over 4 kv heads,
   seq 2048, micro 8, ``remat="full"``, flash attention, fused untied
   loss head at chunk 256, AdamW lr 4e-4, weight decay 0.1, betas
   (0.9, 0.95), clipping 1.0, bf16 over f32 masters), 10 steps on one
   seeded batch: B1 with a kv group of 8 twice per layer, and B3 and B4
   once (the sequence spans two 1024-row blocks and attention is
   grouped), never B2; the profile prints B1's and B3 + B4's shares of
   the step's device time; then flash against plain attention at micro 2;
8. TinyLlama-1.1B served as in phases 4-5 (bf16, random weights from
   seed 0; 6 of its 22 layers since the offload phases came, for the
   run's time): ``generate()`` on B5 over the cache at kv-head width (B5
   must see the layer's cache of 4 kv heads, never a copy expanded over
   the group),
   ``forward()`` on B1, and the server on B6/B7 at kv-head width (the
   drain's profile with B6's and B7's shares as in phase 5);
9. training block-sparse GPT-2 125M (all 12 layers, ``attn_impl=
   "blocksparse"`` with ``FixedSparsityConfig(block=64, 4 local blocks,
   1 global, unidirectional)``, seq 8192, micro 8, ``remat="full"``,
   fused loss head at chunk 256, AdamW and bf16 as in phase 6), 10 steps:
   every layer runs kernel B8 twice and B9 and B10 once, never B1-B4
   (the profile prints B8's and B9 + B10's shares of the step's device
   time); then the kernels against plain attention masked by the layout
   at micro 1, and the same model with dense flash attention for 3
   steps;
10. the block-sparse model served (``init_inference``, kernel injection
   on): ``forward()`` on 2 x 8192 tokens through B8, ``generate()`` on 2
   x 4096-token prompts on the dense cache with the layout as a mask,
   checked against ``forward()``; the server must refuse the model;
11. quantized KV serving at GPT-3 6.7B width (8 of its 32 layers since
   the offload phases came, for the run's time; the pools' MiB scale
   with it): the phase-5 server and
   requests with ``serving.kv_cache_bits`` 8, then 4 (int8 / packed-int4
   pools with f32 scales, bf16 weights from seed 0): the int8 and int4
   variants of B6 and B7 run and the bf16 ones do not; pool bytes,
   ``blocks_for_budget`` at the bf16 pool's budget, tokens/s, token
   agreement with ``generate()``, first-step logits at 8 bits against
   ``generate()``'s, one recorded mixed step (a chunk plus decode slots)
   rerun with the kernels' plain versions, and the drain's profile with
   the int8/int4 B6's and B7's shares;
12. int8 weight-only serving at GPT-3 6.7B width (``quant.enabled`` and
   ``kv_cache_bits`` 8, the seed-0 weights quantized): parameter bytes,
   ``generate()`` (TTFT, decode ms/token), ``forward()`` against phase
   4's bf16 prefill logits, and the 16-request drain.
13. GPT-3 2.7B served as in phases 4-5 (8 of its 32 layers, cut for
   the run's time; d_model 2560, 32 heads of 80; bf16, random weights
   from seed 0): ``generate()`` on B5,
   ``forward()`` on B1 and the server on B6/B7, all at head dim 80, with
   the same logit checks, and B5's share of ``generate()``'s device time
   beside B6's and B7's of the drain;
14. fp16 training of GPT-3 760M (all 24 layers, d_model 1536, 16 heads
   of 96, seq 1024, micro 16, ``remat="full"``, flash, fused loss head at
   chunk 256, ``bench.py``'s AdamW, clipping 1.0, ``fp16`` with dynamic
   loss scaling from 2^16, window 1000, hysteresis 2, min scale 1): 10
   steps launching exactly 48 float16 B1 and 24 float16 B2 a step at D
   96 and no other flash kernel, the loss-scale trajectory and skipped
   steps, 3 warm steps (tokens/s, MFU); an inf planted in one embedding
   entry until the scale falls (each such step skipped, ``step`` held);
   then 2 steps at seq 2048 (GPT-3's context): float16 B1, B3 and B4;
15. fp16 serving at GPT-3 6.7B width (``init_inference(dtype=
   "float16")``, random weights from seed 0; 8 of its 32 layers since
   the offload phases came, for the run's time): ``generate()`` on the
   float16 B5 and no other B5, then phase 5's drain at ``kv_cache_bits``
   0, 8 and 4 on the float16 B6/B7 of that width and no other (at
   kv_bits 0 every greedy server stream equal to ``generate()``'s up to
   a near tie): TTFT, ms/token, tokens/s; then int8 weights over the
   same float16 weights (``forward()`` logits, ``generate()`` on f16 B5);
16. fp16 block-sparse training: phase 9's GPT-2 125M (seq 8192, micro 8)
   with dynamic loss scaling from 2^16: exactly 24 float16 B8, 12 B9 and
   12 B10 a step and no other attention kernel, ms/step, MFU, the scale
   trajectory and skipped steps; step 1 at micro 1 held against plain
   attention masked by the layout;
17. resume: GPT-2 125M with LAMB, ``remat="dots_no_batch"`` and fp16
   scaling, 6 steps straight against 3, ``save_checkpoint``, a fresh
   engine, ``load_checkpoint`` and 3 more: the later losses and the final
   state bit-equal; the save and load seconds and the bytes written; then
   ``init_inference(checkpoint=...)`` serves the checkpoint on the float16
   B5;
18. the remat policies (none, full, dots_saveable, dots_no_batch,
   nothing_saveable) at GPT-2 125M: peak memory and ms/step, the same
   first-step loss under each;
19. GPT-NeoX-20B served at full width (``hf_neox_config`` on
   its published config: 44 layers, served at 6 of them since the
   offload phases came, for the run's time; d_model 6144, 64 heads of 96, rotary
   on 24 of the 96 dims, rotate-half, parallel residual, untied head,
   vocab 50432; bf16, random weights from seed 0) after every earlier
   engine is freed: phases 4-5's protocol (B5 seeing each layer's cache
   at 64 kv heads, ``forward()`` on B1, the drain on B6/B7 with exact
   launch counts) with every greedy server stream equal to
   ``generate()``'s up to a near tie, and the peak device memory;
20. training GPT-NeoX 1.3B (``neox_config("1.3b")``: 24 layers, d_model
   2048, 16 heads of 128, parallel residual, rotate-half rotary; seq
   1024, micro 8, ``remat="full"``, flash, fused loss head at chunk 256,
   AdamW, bf16 over f32 masters), 10 steps as phase 6: 48 B1 and 24 B2 a
   step, a falling loss, the same-state step check against plain
   attention at micro 2;
21. DeepSpeed-MoE 350M+MoE-128 served (``MOE_SERVE``: 24 layers,
   d_model 1024, 16 heads of 64, 128 experts on every other layer,
   top-1, capacity factor 1.0, min capacity 4; 13.15 B parameters, bf16,
   random weights from seed 0) after every earlier engine is freed: the
   server refuses it (the JAX reason), ``generate()`` of 8 x 128 prompts,
   64 new tokens (exactly 24 x 63 B5 launches), ``forward()`` on the same
   prompts (24 B1), its last-position logits within ``LOGITS_REL_TOL``
   of ``generate()``'s first step, each MoE layer's exp_counts and
   dropped tokens, TTFT, decode ms/token, busy share, peak memory;
22. training 125M+MoE-64 (``MOE_TRAIN``: 12 layers, d_model 768, 64
   experts on every other layer; 1.91 B parameters; seq 2048, micro 8,
   remat full, flash, fused loss head at chunk 256, AdamW, bf16 over f32
   masters), 10 steps with ``moe_rng`` seeded per step (RTS): 24 B1, 12
   B3, 12 B4 and no B2 a step (seq 2048 takes the two-pass backward),
   a falling loss, ms/step and MFU on the active parameters, the
   same-state step check against plain attention with the same routing
   seed, remat none against full at step 1 (equal routing, grad norm
   within the step check's limit);
23. Stable Diffusion v1.x (``init_diffusion`` with the JAX defaults: UNet
   859.5 M, VAE 83.7 M, CLIP text 123.1 M parameters, exactly; bf16,
   random weights from seed 0): one UNet step's eps in bf16 against
   float32 within ``DIFFUSION_EPS_REL_TOL``, ms per guided UNet step,
   the pipeline (20 DDIM steps, guidance 7.5, 512x512) to a finite image
   in [0, 1], seconds per image, peak memory;
24. speculative serving on phase 5's GPT-3 6.7B engine (run right after
   phase 5, on its weights): phase 5's 16 requests (32 new tokens,
   greedy, spec_k 3) with (a) no draft, (b) the GPT-3 Small draft (12
   layers, d_model 768, 12 heads of 64; untrained, from seed 1) and (c)
   the target as its own draft (its module and params): streams of (b)
   and (c) equal (a)'s up to a near tie, every proposal (c) rejects at a
   near tie, B6/B7 launches exact against the dispatch log (target
   layers x (a decode lane + 4 x a spec lane) B6, draft layers x (feed
   0 + 3 x a spec lane) B6, both x a chunk B7), the pool empty after
   each drain; tokens/s, iterations, acceptance, peak memory and the
   overlap profiler's enqueue / device-wait shares of each; B6 at spec
   depth 4 against its plain version with its time and bound;
25. the multi-tenant front end on the same engine: ``bench_all.py``'s
   ``multi_tenant_replay_bench`` mix (3 tenants, 4 slots,
   ``max_queue_depth`` 6, 60 rounds, 16 new tokens, the GPT-3 Small
   draft at spec_k 1, its ``SloMonitor`` windows) with tracing, metrics,
   request tracing, overlap and the flight recorder on into a temporary
   directory and ``DSTPU_HEARTBEAT_FILE`` set: every stream in order
   and exactly once, the Chrome trace's serving spans and request
   tracks, every ported ``dstpu_serving_*`` series in the textfile, the
   heartbeat stamped; per-tenant TTFT / ITL p50 and p99, shed and
   timeout rates, alerts fired and resolved; then phase 5's drain with
   observability on and off (equal greedy streams, tokens/s of both).
   Phase 6 also takes 3 more steps with tracing and metrics on (the
   ``engine/*`` spans, ``dstpu_train_steps_total``, ms/step on and off);
26. the tiered host KV cache on the same engine: a shared 928-token
   prefix P (58 blocks), A = P + a 64-token tail, filler waves until every
   block of P is evicted (spilled, and resident in the host tier), then
   B = P + another tail (32 new tokens, greedy) as (i) an HBM hit, (ii) a
   DRAM hit at wire 0 and wire 8, (iii) an NVMe hit (a temporary
   directory, its filesystem and whether O_DIRECT held printed), (iv)
   cold and (v) a kv_bits 8 pool through DRAM against its own HBM hit:
   exact streams at wire 0, on NVMe and at kv_bits 8, near ties at wire
   8 and cold, promoted blocks equal to the bytes gathered at their spill,
   B7 over the tail alone on every hit (a full prefill cold) and B6/B7
   exact; B's TTFT each way, the promote's share of B's drain and GB/s,
   the spill's GB/s, resident bytes per tier;
27. the replica fleet on the same engine, pumped: (a) 2 replicas over one
   host tier, phase 5's 16 requests and 8 over a shared 512-token prefix,
   every stream exactly once and equal to one ``ServingEngine``'s up to a
   near tie, the later shared-prefix requests on the warm replica, B6/B7
   exact over both replicas, tokens/s beside the single engine's; (b) r1
   killed mid-drain by a fatal ``serving.fleet.replica_step`` plan: the
   replayed tokens, and every replay that parts from the delivered stream
   (``StreamReplayError``) printed with its logit gap and held to a near
   tie; (c) disaggregated (1 prefill + 1 decode replica): the fabric's
   entries promoted or dropped as redundant, none orphaned, every
   handed-off prefill on the decode replica its tail alone; (d) a
   transient ``serving.fleet.route`` plan: streams exactly once; (e) the
   replicas on their own threads: streams exactly once;
28. ZeRO-Offload (``offload_phase``): GPT-2 125M with the host optimizer
   against the in-HBM engine (3 steps, the JAX tests' bounds), then GPT-3
   6.7B's width at 8 of its 32 layers (all 32 until phase 32 came, 16
   until phase 33 did, for the run's time) on the host optimizer (seq
   1024, micro 4, 20 GB of host Adam state): s/step split into the grads, the host
   sweep and the upload lane, the sweep's and the wire's GB/s, 1 step at
   wire 0 and 1 at wire 8 (3 and 2 until phase 31 came, for the run's
   time); B1 and B2 launches exact;
29. ZeRO-Infinity at GPT-NeoX-20B width (``infinity_phase``): 4 layers
   (cut to the host's memory: 10 of the 12 wanted until phase 32 came,
   cut for the run's time) streamed past the card,
   pure stream (2 steps) then clip-gated at gas 2 (1 step; 3 and 2
   until phase 31 came, for the run's time); 2 layers against the in-HBM
   engine (B1, B3, B4 exact a layer) and on the NVMe tier bit-equal to
   DRAM;
30. ``remat="host_offload"`` against ``remat="full"`` at GPT-NeoX 1.3B
   (``host_offload_phase``): equal losses, lower peak memory, the step
   ratio;
31. data parallelism and ZeRO stages 0-3 (``zero_phase``) at phase 6's
   GPT-2 125M configuration (seq 1024, flash, remat full, loss chunk 256,
   AdamW lr 6e-4 and weight decay 0.1, bf16 over f32 masters, clipping
   1.0; global batch 64), each world in child processes with a deadline:
   (a) world 1 on NCCL at stage 3 against the engine without ZeRO in the
   same process, each step from the same state (bit-equal expected: every
   collective at world 1 is an identity; which held is printed), 2
   steps (3 until phase 32 came, for the run's time); (b) world 4 over
   gloo, four ranks sharing the one card (NCCL takes one card a rank) at
   micro 16 each, stages 0-3, 2 steps each,
   each step from (a)'s state of that step (saved by (a), every rank
   keeping its shards: ``adopt_state``): every rank's losses and grad
   norms held to (a)'s engine without ZeRO within the same-state step
   check, B1 24 and B2 12 launches a step on
   every rank exactly, each rank's state bytes (counted from its
   tensors) equal to the plan's count and stage 3's at most a quarter of
   stage 0's plus its resident leaves'; per stage the bytes, peak
   memory, ms/step and the comm log's bytes and GB/s per op and step.

32. tensor parallelism (``tp_phase``), one process per rank: (a) GPT-3
   6.7B's width (32 heads of 128, vocab 50304) at 8 of its 32 layers,
   random weights from seed 0 (every rank draws the whole tree, keeps its
   slice): phase 5's 16-request drain and phase 4's ``generate()`` (8 x
   128, 32 new: 64 in phase 4) at one rank without a mesh as the
   reference; world 1 on
   NCCL at ``serving.mesh`` 1 x 1 bit-equal to it; then 4 gloo ranks
   sharing the card at ``serving.mesh`` {data 1, model 4} and {data 2,
   model 2} (the drain) and ``generate()`` at ``tensor_parallel.tp_size``
   4: every rank's streams equal, equal to the reference's up to a near
   tie, the first 4 requests' first-step logits within
   ``LOGITS_REL_TOL``, B6/B7 (B5) launches exact on every rank with a spy
   seeing ``32 / model`` kv heads, each rank's weight bytes (sharded
   leaves at 1/model, replicated ones whole) and pool bytes
   (``kv_block_bytes(model_shards=model)`` x blocks x layers) the plans'
   counts; tokens/s and the comm log per op (gloo on one host, not
   tensor parallelism across cards); (b) in phase 31's world of 4: GPT-2
   125M at {data 1, model 4} stage 0 and {data 2, model 2} stage 2,
   global batch 8, 2 steps each from phase 31 (a)'s state of that step:
   losses and grad norms within the same-state step check of the engine
   without ZeRO at that state and batch, B1 24 and B2 12 a step on every
   rank, state bytes the plan's count.

33. pipeline parallelism (``pipe_report``), in phase 31's world of 4
   gloo ranks sharing the card, after phase 32 (b): GPT-2 125M at
   phase 32 (b)'s global batch of 8 and micro 1, 2 steps each from
   phase 31 (a)'s state of that step (stage-stacked, each rank keeping
   its stage's slice), at {pipe 4} under 1F1B and under gpipe (8 micro
   batches), {pipe 2, data 2} at ZeRO stage 1 (4 a data rank) and {pipe
   2, model 2} under 1F1B (8): every rank's loss and grad norm the same
   and within the same-state step check of phase 32 (b)'s reference, B1
   2 x layers a stage x micro batches and B2 once that a step on every
   rank exactly, each rank's state bytes the plan's count (blocks / S
   beside the replicated embedding, positions and final norm), stage
   0's schedule peak (``torch.cuda.max_memory_allocated`` above what
   the schedule started with) under 1F1B at most gpipe's; per mesh the
   bytes, peak memory, s/step, the sends' and receives' calls, bytes and
   ms a call, the all-reduce over pipe; at {pipe 4} the two-point bubble
   fit of each schedule (``measure_bubble_fraction``, M 4 and 8).

``python3 chip_smoke.py --only 3 6 21 22 23 24 28 29 30 31 32 33`` (any
of them) builds the kernels and runs only those phases ("3": phase 3's
cases at the MoE shapes; "24": phases 24-27 on a fresh 6.7B engine;
"32" without "31": phase 32 (a) alone; "33" needs "31", whose world it
runs in), then prints no result line: a probe of the newest phases.

Phase 3 holds B5 at GPT-3 6.7B's decode shape (H = Hkv 32, D 128;
caches 192 and 1024) and at TinyLlama-1.1B's at kv-head width (H 32
over Hkv 4, D 64, cache 192), bit-equal on two launches, against SDPA
with ``enable_gqa``; at the GQA shape also the cache expanded over the
group then B5 (the model's path before B5 read at kv-head width).  It
also holds B8, B9 and B10 (block-sparse forward, dq and dk/dv)
against their plain versions: at phase 9's attention shape, at
``bench_all.py``'s block-sparse lane (T 16384, 512-row blocks) and with
16-row blocks of a per-head BigBird layout, each with the whole
backward as the autograd function runs it (eager delta, B9, B10: the
span of SDPA's masked backward), and at phase 9's shape B10's longest
and mean walk and B9/B10 over the layout's local blocks alone (no
summary column: even walks); and B6 and B7 over int8 and packed-int4
pools (``quant_kernel_checks``).  And it holds the kernels at the head
dims, groups and dtypes of phases 13-14, 19-20 and of the reference's
other configurations (``c1_flash_checks``, ``c1_decode_checks``,
``c1_sparse_checks``): B1 at GPT-NeoX-20B's forward (64 heads of 96),
B1 and B2 at GPT-NeoX 1.3B's step (16 heads of 128), B1-B4 at D 80, 96
and 256 in bf16 and in float16
at 760M's, GPT-2's and TinyLlama's shapes (float16 within
``F16_TOL``); B5-B7 at D 80, 96 (GPT-NeoX-20B's 64 heads among them)
and 256 and kv groups 3, 16 and 32 (MQA), B6/B7 at kv_bits 0, 8 and 4; B8-B10 at D 96 over 48-row blocks
and D 80 over 128-row blocks; and the float16 B5-B7 (kv_bits 0, 8, 4) at
GPT-3 6.7B's and 2.7B's heads and B8-B10 at phase 16's shape
(``f16_decode_checks``, ``f16_sparse_checks``, within ``F16_TOL``); each
with its planted fault, two launches bit-equal, its time, bound and
SDPA's time where one call computes it; B1/B2 at the GPT-3 6.7B offload
step's shape and B1/B3/B4 at the GPT-NeoX-20B Infinity step's.  Each
timing is the median of ``N_TIMED`` (4) calls after ``N_WARM`` (1).

The line before the last holds ``nvidia-smi``'s name and power limit,
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

#: bf16 kernel-vs-plain tolerance: both sides accumulate in f32 and round
#: the output to bf16 once, so where their f32 values straddle a rounding
#: boundary they differ by one bf16 ulp, at most 2^-7 = 0.0078 of the
#: value (rtol); atol covers outputs near zero.  Every case also plants a
#: fault in the plain version (one tail row left out of the softmax) and
#: fails unless the limit catches it.
KERNEL_ATOL, KERNEL_RTOL = 4e-3, 8e-3

#: serving-vs-generate first-step logits: the two paths round bf16
#: activations at different places (chunked paged prefill vs dense
#: prefill) through 32 layers; they must agree to this fraction of the
#: reference logits' largest magnitude.  The same limit holds
#: forward()'s logits (kernel B1) against generate()'s prefill (plain
#: attention).
LOGITS_REL_TOL = 0.05
#: the same comparison in float16 (3 more bits of mantissa than bf16):
#: on an H100 80GB HBM3 at 700 W, GPT-3 6.7B's first-step logits agreed
#: within 0.0023 of max|logit| and the two streams that parted from
#: generate() did so where generate()'s logit gap was 0.0024 and 0.0001
#: of it.  A stream may part only where that gap is within twice this
#: limit, the most two paths that each agree within it can differ by.
F16_LOGITS_REL_TOL = 0.005

#: flash vs plain attention through the whole training step (3 steps,
#: each taken by both from the same state): bf16 activations are rounded
#: at different places in the two attention paths (B1 rounds the
#: probabilities before P.V and writes o once; the plain path rounds the
#: probabilities and the P.V product), so the losses must agree to this
#: fraction and the gradient norms to STEP_GNORM_REL_TOL.  Each step
#: starts from one state because AdamW's first updates are about
#: lr * sign(g): rounding-level gradient differences become lr-sized
#: parameter differences, and two free trajectories part within two or
#: three steps (on an H100, TinyLlama-1.1B at micro 2 parted at its
#: third step by 6x the loss limit with each earlier step within 0.1 of
#: it).
STEP_LOSS_REL_TOL = 2e-3
STEP_GNORM_REL_TOL = 2e-2

#: lse (float32 in both versions) may differ by the order of the sums
LSE_ATOL = 1e-3

#: float16 kernel-vs-plain tolerance: two f16 ulps (2^-9 of a value in
#: [1, 2)).  Both sides round p and ds to f16 at the same points, but an
#: f16 ulp is 8x finer than a bf16 one, so the kernel's and the plain
#: version's f32 values (ex2.approx against exp, sums in another order)
#: straddle f16 rounding boundaries 8x as often: on an H100 one element
#: of the f16 B2 at GPT-2's shape (of 150 M) came out 2 ulps off, 1.03 of
#: a one-ulp limit (atol 5e-4 + rtol 1e-3).  The planted fault must exceed
#: this limit too.
F16_TOL = (1e-3, 2e-3)

#: the training phase: bench.py's GPT-2 125M step (seq 1024, micro 64),
#: 10 steps (20 until phase 31 came: cut for the run's time)
TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 1024, 64, 10

#: the TinyLlama-1.1B training phase: seq 2048, micro 8, 10 steps; flash
#: against plain attention at micro 2
LLAMA_SEQ, LLAMA_MICRO, LLAMA_STEPS, LLAMA_CHECK_MICRO = 2048, 8, 10, 2

#: the block-sparse GPT-2 125M phase: seq 8192, micro 8 (bench.py's 65536
#: tokens per step), 10 steps; kernels against masked plain attention at
#: micro 1
SPARSE_SEQ, SPARSE_MICRO, SPARSE_STEPS = 8192, 8, 10

#: the GPT-NeoX 1.3B training phase: seq 1024, micro 8, 10 steps; flash
#: against plain attention at micro 2
NEOX_SEQ, NEOX_MICRO, NEOX_STEPS, NEOX_CHECK_MICRO = 1024, 8, 10, 2

#: timed calls of a kernel in phase 3, after warm-up calls (30 and 5
#: until the MoE and diffusion phases needed the time, 20 and 3 until the
#: offload phases did; the median of 4 is the time printed)
N_TIMED, N_WARM = 4, 1
#: phase 13 serves GPT-3 2.7B's width (32 heads of 80) at 8 of its 32
#: layers (16 until the offload phases came), cut for the run's time: the
#: phase is there for head dim 80
PHASE13_LAYERS = 8
#: depth cuts for the run's time, made when the offload phases (28-30)
#: came; widths, heads and every check stay: phase 8 serves TinyLlama at
#: 6 of its 22 layers, phases 11 and 15 serve GPT-3 6.7B's width at 8 of
#: 32, phase 19 GPT-NeoX-20B's at 6 of 44
LLAMA_SERVE_LAYERS, QUANT_SERVE_LAYERS = 6, 8
FP16_SERVE_LAYERS, NEOX20_SERVE_LAYERS = 8, 6
#: timed calls of a plain version over [B*H, 2048, 2048] scores (each
#: takes tens of ms; its time is a yardstick, not a result), after one
#: warm-up call (5 until the offload phases came, 3 until phase 31 did,
#: 2 until phase 32 did)
N_TIMED_PLAIN = 1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


#: GPU clock cycles of the spin that keeps the card busy while the host
#: enqueues a timed call (~1 ms at H100 clocks)
SPIN_CYCLES = 2_000_000


def time_ms(fn, torch, flush, n_timed: int = N_TIMED,
            n_warm: int = N_WARM) -> float:
    """Median device ms of one call of ``fn`` over ``n_timed`` calls after
    ``n_warm``, each between two CUDA events.  Before each call the L2 cache
    is flushed (a decode step finds it cold: 32 layers of KV exceed the
    50 MB L2), then a spin kernel holds the stream while the host
    enqueues the call, so the events bracket the call's kernels and not
    the host's launch latency."""
    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n_timed):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def margin(a, b, tol=None) -> float:
    """Largest |a - b| as a share of the limit ``tol`` (atol, rtol;
    default the bf16 one) at that element: the check passes where this is
    at most 1."""
    atol, rtol = tol or (KERNEL_ATOL, KERNEL_RTOL)
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def agree(name, got, want, fault, tol=None) -> dict:
    """Hold a kernel's output against its plain version within ``tol``
    (default the bf16 limit), and check that the limit catches the
    planted fault ``fault`` (the plain version with one tail row left
    out) on the same inputs."""
    check(bool(got.isfinite().all()), f"{name}: non-finite output")
    err, m = max_err(got, want), margin(got, want, tol)
    check(m <= 1.0, f"{name}: max |err| {err} ({m:.3g} of the limit)")
    fm = margin(fault, want, tol)
    check(fm > 1.0, f"{name}: the limit misses a planted fault (one tail "
                    f"row left out: {fm:.3g} of the limit)")
    return dict(max_abs_err=err, limit_share=m,
                fault_err=max_err(fault, want), fault_limit_share=fm)


# -- phase 3: each kernel against its plain version ------------------------
def kernel_checks(torch, dev, flush):
    from deepspeed_tpu_torch.ops.transformer import decode_attention as DA
    from deepspeed_tpu_torch.ops.transformer import (
        paged_decode_attention as PA)
    F = torch.nn.functional
    bf16 = torch.bfloat16
    H, D = 32, 128
    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    results = {}
    SMS = torch.cuda.get_device_properties(dev).multi_processor_count

    # B5: dense decode at the generate() shape (8 rows, cache 192) and a
    # long cache, GPT-3 6.7B's heads (H = Hkv 32, D 128), then
    # TinyLlama-1.1B's decode shape at kv-head width (H 32 over Hkv 4, D
    # 64); lengths full and not a multiple of any chunk; rows past the
    # length hold NaN (so the planted fault at length - 1 reads none)
    b5 = []
    for S, length, Hq, Hkv, Dh in ((192, 192, H, H, D), (192, 130, H, H, D),
                                   (1024, 1024, H, H, D),
                                   (1024, 1000, H, H, D),
                                   (192, 192, 32, 4, 64),
                                   (192, 130, 32, 4, 64)):
        B, grp = 8, Hq // Hkv
        q, k, v = randn(B, Hq, Dh), randn(B, S, Hkv, Dh), randn(B, S, Hkv, Dh)
        k[:, length:] = float("nan")
        v[:, length:] = float("nan")
        got = DA.decode_attention(q, k, v, length)
        again = DA.decode_attention(q, k, v, length)
        want = DA.decode_attention_plain(q, k, v, length)
        fault = DA.decode_attention_plain(q, k, v, length - 1)
        torch.cuda.synchronize()
        case = f"B={B} H={Hq} Hkv={Hkv} D={Dh} S={S} length={length}"
        acc = agree(f"B5 {case}", got, want, fault)
        rerun = max_err(got, again)
        check(rerun == 0.0, f"B5 {case}: two launches differ by {rerun}")
        ms = time_ms(lambda: DA.decode_attention(q, k, v, length), torch,
                     flush)
        plain = time_ms(lambda: DA.decode_attention_plain(q, k, v, length),
                        torch, flush)
        kt = k[:, :length].transpose(1, 2)
        vt = v[:, :length].transpose(1, 2)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, enable_gqa=True), torch, flush)
        nbytes = 2 * B * length * Hkv * Dh * 2 + 2 * B * Hq * Dh * 2
        bnd, by = bound_ms(nbytes, 4.0 * B * Hq * length * Dh)
        rec = dict(case=case, **acc, rerun_diff=rerun, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
                   plan=DA.cluster_plan(B, Hkv, length, SMS))
        if grp > 1:
            # the parent's model path: the valid cache expanded over the
            # group (repeat_interleave), then B5 at one kv head a head
            rec["expand_ms"] = time_ms(lambda: DA.decode_attention(
                q, k[:, :length].repeat_interleave(grp, dim=2),
                v[:, :length].repeat_interleave(grp, dim=2), length), torch,
                flush)
        b5.append(rec)
    results["decode_attention"] = b5

    # B6: 8 slots of ragged lengths (PAGED_LENGTHS)
    pk, pv, tables, lens, perm = paged_decode_case(torch, randn, dev, H, D)
    lengths = PAGED_LENGTHS
    NB, BLK, NP = PAGED_POOL
    q = randn(8, H, D)
    got = PA.paged_decode_attention(q, pk, pv, lens, tables)
    again = PA.paged_decode_attention(q, pk, pv, lens, tables)
    want = PA.paged_decode_attention_plain(q, pk, pv, lens, tables)
    fault = PA.paged_decode_attention_plain(
        q, pk, pv, (lens - (lens > 0).int()).int(), tables)
    torch.cuda.synchronize()
    acc = agree("B6", got, want, fault)
    check(float(got[4].abs().max()) == 0.0 and
          float(got[6].abs().max()) == 0.0, "B6: inactive slots not zero")
    rerun = max_err(got, again)
    check(rerun == 0.0, f"B6: two launches differ by {rerun}")
    ms = time_ms(lambda: PA.paged_decode_attention(q, pk, pv, lens, tables),
                 torch, flush)
    plain = time_ms(lambda: PA.paged_decode_attention_plain(
        q, pk, pv, lens, tables), torch, flush)
    rows = sum(lengths)
    bnd, by = bound_ms(2 * rows * H * D * 2 + 2 * 8 * H * D * 2
                       + tables.numel() * 4, 4.0 * rows * H * D)
    results["paged_decode_attention"] = [dict(
        case=f"8 slots, lengths {lengths}", **acc, rerun_diff=rerun, ms=ms,
        plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by,
        plan=DA.paged_split_plan(NP, BLK))]

    # B7: chunk of 256 through one slot's table at base 0, at base 256,
    # and a short chunk (chunk_len < C); rows past base + chunk_len are NaN
    b7 = []
    table = torch.tensor(perm[:NP], dtype=torch.int32, device=dev)
    C = 256
    for base, clen in ((0, 256), (256, 256), (64, 100)):
        pk2, pv2 = randn(NB, BLK, H, D), randn(NB, BLK, H, D)
        total = base + clen
        for pg in range(total // BLK, NP):
            off = max(0, total - pg * BLK)
            pk2[perm[pg], off:] = float("nan")
            pv2[perm[pg], off:] = float("nan")
        q = randn(C, H, D)
        got = PA.paged_prefill_attention(q, pk2, pv2, base, clen, table)
        again = PA.paged_prefill_attention(q, pk2, pv2, base, clen, table)
        want = PA.paged_prefill_attention_plain(q, pk2, pv2, base, clen,
                                                table)
        fault = PA.paged_prefill_attention_plain(q, pk2, pv2, base,
                                                 clen - 1, table)
        torch.cuda.synchronize()
        acc = agree(f"B7 base={base} len={clen}", got, want, fault)
        rerun = max_err(got, again)
        check(rerun == 0.0, f"B7 base={base} len={clen}: two launches "
                            f"differ by {rerun}")
        acc["rerun_diff"] = rerun
        ms = time_ms(lambda: PA.paged_prefill_attention(
            q, pk2, pv2, base, clen, table), torch, flush)
        plain = time_ms(lambda: PA.paged_prefill_attention_plain(
            q, pk2, pv2, base, clen, table), torch, flush)
        # causal pairs: query i sees min(total, base + i + 1) keys
        pairs = sum(min(total, base + i + 1) for i in range(C))
        bnd, by = bound_ms(2 * total * H * D * 2 + 2 * C * H * D * 2,
                           4.0 * pairs * H * D)
        b7.append(dict(case=f"C={C} base={base} chunk_len={clen}",
                       **acc, ms=ms, plain_ms=plain,
                       library_ms=None, bound_ms=bnd, bound_by=by))
    results["paged_prefill_attention"] = b7
    results.update(flash_checks(torch, dev, flush))
    for name, cases in gqa_flash_checks(torch, dev, flush).items():
        results.setdefault(name, []).extend(cases)
    results.update(blocksparse_checks(torch, dev, flush))
    results.update(quant_kernel_checks(torch, dev, flush))
    for extra in (c1_flash_checks, c1_decode_checks, c1_sparse_checks,
                  f16_decode_checks, f16_sparse_checks):
        for name, cases in extra(torch, dev, flush).items():
            results.setdefault(name, []).extend(cases)
    return results


def f16_decode_checks(torch, dev, flush):
    """Phase 3's float16 B5, B6 and B7 (kv_bits 0, 8, 4) at the fp16
    serving phase's heads (``F16_DECODE_CASES``)."""
    return c1_decode_checks(torch, dev, flush, F16_DECODE_CASES, "float16")


def f16_sparse_checks(torch, dev, flush):
    """Phase 3's float16 B8, B9 and B10 at the fp16 block-sparse training
    phase's attention (``F16_SPARSE_CASES``)."""
    return c1_sparse_checks(torch, dev, flush, F16_SPARSE_CASES, "float16")


# -- phase 3 (C1, fp16): the head dims, groups and dtypes of this slice ----
#: (label, B*H, B*KVH, T, D, dtype, kernels) of the flash cases:
#: GPT-NeoX-20B's forward() (8 x 128 prompts, 64 heads of 96) and GPT-NeoX
#: 1.3B's training step (micro 8, 16 heads of 128); GPT-3 2.7B's attention (32 heads of 80) and 760M's (16 heads of 96) at micro 8
#: and 16, seq 1024; GPT-J's head of 256 (16 heads, micro 4); and the
#: float16 kernels at 760M's shape, at phase 3's GPT-2 and TinyLlama
#: shapes (the kv group of 8 takes B1, B3 and B4) and at 760M's seq 2048
#: step (B3 and B4); 350M+MoE-128's forward() (8 x 128 prompts, 16 heads
#: of 64) and 125M+MoE-64's step (micro 8, 12 heads of 64, seq 2048: B1,
#: B3 and B4)
C1_FLASH_CASES = (
    ("GPT-NeoX-20B forward", 512, 512, 128, 96, "bfloat16", ("B1",)),
    ("GPT-NeoX 1.3B", 128, 128, 1024, 128, "bfloat16", ("B1", "B2")),
    ("GPT-3 2.7B", 256, 256, 1024, 80, "bfloat16", ("B1", "B2", "B3", "B4")),
    ("GPT-3 760M", 256, 256, 1024, 96, "bfloat16", ("B1", "B2", "B3", "B4")),
    ("GPT-J", 64, 64, 1024, 256, "bfloat16", ("B1", "B2", "B3", "B4")),
    ("GPT-3 760M fp16", 256, 256, 1024, 96, "float16", ("B1", "B2")),
    ("GPT-2 125M fp16", 768, 768, 1024, 64, "float16", ("B1", "B2")),
    ("TinyLlama fp16", 256, 32, 2048, 64, "float16", ("B1", "B3", "B4")),
    ("GPT-3 760M fp16 seq 2048", 256, 256, 2048, 96, "float16",
     ("B3", "B4")),
    ("350M+MoE-128 forward", 128, 128, 128, 64, "bfloat16", ("B1",)),
    ("125M+MoE-64 step", 96, 96, 2048, 64, "bfloat16", ("B1", "B3", "B4")),
    ("GPT-3 6.7B offload step", 128, 128, 1024, 128, "bfloat16",
     ("B1", "B2")),
    ("GPT-NeoX-20B Infinity step", 64, 64, 2048, 96, "bfloat16",
     ("B1", "B3", "B4")),
)


def c1_flash_checks(torch, dev, flush, cases=None):
    """B1-B4 at ``C1_FLASH_CASES``, causal: each against its plain version
    (bf16 limit, or ``F16_TOL`` for float16) with the planted fault of
    ``flash_checks`` caught, bit-equal on two launches, timed beside its
    bound and SDPA (its forward for B1, its backward for B2-B4; the
    backward kernels timed with delta given).  Results are keyed by the
    kernel's launch counter (``_f16`` for float16)."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as FA
    F = torch.nn.functional
    g = torch.Generator(device=dev)
    g.manual_seed(1111)
    out = {}
    names = {"B1": "flash_attention_fwd", "B2": "flash_attention_bwd",
             "B3": "flash_attention_bwd_dq", "B4": "flash_attention_bwd_dkv"}
    for label, BH, BKV, T, D, dtype, kinds in cases or C1_FLASH_CASES:
        dt = getattr(torch, dtype)
        tol = F16_TOL if dt == torch.float16 else None
        grp = BH // BKV

        def randn(n):
            return torch.randn((n, T, D), generator=g, device=dev).to(dt)
        q, do, k, v = randn(BH), randn(BH), randn(BKV), randn(BKV)
        keep = fault_keep(torch, T, True, dev)
        case = f"{label}: B*H={BH} B*KVH={BKV} T={T} D={D} {dtype} causal"
        pairs = BH * T * (T + 1) // 2
        qb, kvb, rb = BH * T * D * 2, BKV * T * D * 2, BH * T * 4
        o_p, lse_p = FA.flash_attention_fwd_plain(q, k, v, True)
        delta = FA._delta(o_p, do)
        q4 = q.view(1, BH, T, D)
        k4, v4 = (x.view(1, BKV, T, D) for x in (k, v))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                              enable_gqa=grp > 1)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), do.view(1, BH, T, D), retain_graph=True),
            torch, flush)
        del sdpa, qg, kg, vg
        for kind in kinds:
            run = {
                "B1": (lambda: FA.flash_attention_fwd(q, k, v, True)[0],
                       lambda keep=None: FA.flash_attention_fwd_plain(
                           q, k, v, True, keep=keep)[0]),
                "B2": (lambda: flat(FA.flash_attention_bwd(
                    q, k, v, o_p, lse_p, do, True, None, delta)),
                       lambda keep=None: flat(FA.flash_attention_bwd_plain(
                           q, k, v, o_p, lse_p, do, True, keep=keep))),
                "B3": (lambda: FA.flash_attention_bwd_dq(
                    q, k, v, o_p, lse_p, do, True, None, delta),
                       lambda keep=None: FA.flash_attention_bwd_dq_plain(
                           q, k, v, o_p, lse_p, do, True, keep=keep)),
                "B4": (lambda: flat(FA.flash_attention_bwd_dkv(
                    q, k, v, o_p, lse_p, do, True, None, delta)),
                       lambda keep=None: flat(FA.flash_attention_bwd_dkv_plain(
                           q, k, v, o_p, lse_p, do, True, keep=keep))),
            }[kind]
            got, again = run[0](), run[0]()
            want, fault = run[1](), run[1](keep)
            torch.cuda.synchronize()
            acc = agree(f"{kind} {case}", got, want, fault, tol)
            rerun = max_err(got, again)
            check(rerun == 0.0, f"{kind} {case}: two launches differ by "
                                f"{rerun}")
            del got, again, want, fault
            # timed as called: the outputs, not their f32 concatenation
            timed = {
                "B1": (lambda: FA.flash_attention_fwd(q, k, v, True),
                       lambda: FA.flash_attention_fwd_plain(q, k, v, True)),
                "B2": (lambda: FA.flash_attention_bwd(
                    q, k, v, o_p, lse_p, do, True, None, delta),
                       lambda: FA.flash_attention_bwd_plain(
                           q, k, v, o_p, lse_p, do, True)),
                "B3": run,
                "B4": (lambda: FA.flash_attention_bwd_dkv(
                    q, k, v, o_p, lse_p, do, True, None, delta),
                       lambda: FA.flash_attention_bwd_dkv_plain(
                           q, k, v, o_p, lse_p, do, True)),
            }[kind]
            ms = time_ms(timed[0], torch, flush)
            plain = time_ms(timed[1], torch, flush, N_TIMED_PLAIN, 1)
            if kind == "B1":
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=grp > 1), torch,
                    flush)
                nbytes, flops = 2 * qb + 2 * kvb + rb, 4.0 * D * pairs
            elif kind == "B2":
                lib = lib_bwd
                nbytes, flops = 4 * qb + 3 * kvb + 2 * rb, 10.0 * D * pairs
            elif kind == "B3":
                lib = lib_bwd
                nbytes, flops = 3 * qb + 2 * kvb + 2 * rb, 6.0 * D * pairs
            else:
                lib = lib_bwd
                nbytes, flops = 2 * qb + 4 * kvb + 2 * rb, 8.0 * D * pairs
            bnd, by = bound_ms(nbytes, flops)
            out.setdefault(build.counter(names[kind], dtype=dt), []).append(
                dict(case=case, **acc, rerun_diff=rerun, ms=ms,
                     plain_ms=plain, library_ms=lib, bound_ms=bnd,
                     bound_by=by, tol=tol or (KERNEL_ATOL, KERNEL_RTOL)))
        del q, do, k, v, o_p, lse_p, delta, keep
        torch.cuda.empty_cache()
    return out


#: (label, H, Hkv, D) of the decode cases: GPT-NeoX-20B's heads, GPT-3
#: 2.7B's, 760M's, GPT-J's head of 256, kv groups of 3, 16 and 32 (MQA)
#: at D 128, and 350M+MoE-128's 16 heads of 64 (phase 21's decode)
C1_DECODE_CASES = (("GPT-NeoX-20B", 64, 64, 96),
                   ("GPT-3 2.7B", 32, 32, 80), ("GPT-3 760M", 16, 16, 96),
                   ("GPT-J", 16, 16, 256), ("g 3", 12, 4, 128),
                   ("g 16", 32, 2, 128), ("g 32 (MQA)", 32, 1, 128),
                   ("350M+MoE-128", 16, 16, 64))


#: the float16 decode cases: the fp16 serving phase's GPT-3 6.7B heads
#: (its main path) and 2.7B's
F16_DECODE_CASES = (("GPT-3 6.7B fp16", 32, 32, 128),
                    ("GPT-3 2.7B fp16", 32, 32, 80))


def c1_decode_checks(torch, dev, flush, cases=C1_DECODE_CASES,
                     dtype="bfloat16"):
    """B5 (8 rows, cache 192, length 130), B6 (phase 3's 8 slots) and B7
    (C 256 at base 256) at ``cases`` in ``dtype``, B6 and B7 at kv_bits 0,
    8 and 4: each against its plain version (bf16 limit, or ``F16_TOL``
    for float16) with phase 3's planted faults caught, bit-equal on two
    launches, timed beside its bound (and B5 beside SDPA with
    ``enable_gqa``).  Results are keyed by the launch counter."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.quantizer import kv_quantize
    from deepspeed_tpu_torch.ops.transformer import decode_attention as DA
    from deepspeed_tpu_torch.ops.transformer import (
        paged_decode_attention as PA)
    F = torch.nn.functional
    dt = getattr(torch, dtype)
    tol = F16_TOL if dt == torch.float16 else None
    g = torch.Generator(device=dev)
    g.manual_seed(2222)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)
    out = {}
    NB, BLK, NP = PAGED_POOL
    for label, H, Hkv, D in cases:
        # B5
        B, S, length = 8, 192, 130
        q, k, v = randn(B, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        k[:, length:] = float("nan")
        v[:, length:] = float("nan")
        case = (f"{label}: B={B} H={H} Hkv={Hkv} D={D} S={S} "
                f"length={length} {dtype}")
        got, again = (DA.decode_attention(q, k, v, length) for _ in range(2))
        want = DA.decode_attention_plain(q, k, v, length)
        fault = DA.decode_attention_plain(q, k, v, length - 1)
        acc = agree(f"B5 {case}", got, want, fault, tol)
        rerun = max_err(got, again)
        check(rerun == 0.0, f"B5 {case}: two launches differ by {rerun}")
        kt, vt = (x[:, :length].transpose(1, 2) for x in (k, v))
        bnd, by = bound_ms(2 * B * length * Hkv * D * 2 + 2 * B * H * D * 2,
                           4.0 * B * H * length * D)
        out.setdefault(build.counter("decode_attention", dtype=dt),
                       []).append(dict(
            case=case, **acc, rerun_diff=rerun,
            tol=tol or (KERNEL_ATOL, KERNEL_RTOL),
            ms=time_ms(lambda: DA.decode_attention(q, k, v, length), torch,
                       flush),
            plain_ms=time_ms(lambda: DA.decode_attention_plain(
                q, k, v, length), torch, flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, enable_gqa=True), torch, flush),
            bound_ms=bnd, bound_by=by,
            parts=build.group_parts(H // Hkv, D, DA._MAX_GROUP_DIM)))
        del q, k, v, kt, vt
        # B6 and B7 at kv_bits 0, 8, 4
        pk, pv, tables, lens, perm = paged_decode_case(torch, randn, dev,
                                                       Hkv, D)
        table = torch.tensor(perm[:NP], dtype=torch.int32, device=dev)
        qd, qc = randn(8, H, D), randn(256, H, D)
        rows = sum(PAGED_LENGTHS)
        base, clen = 256, 256
        total = base + clen
        pairs = sum(min(total, base + i + 1) for i in range(256))
        # B7's slot: fresh pools, NaN in every row of its table past total
        pk2, pv2 = randn(NB, BLK, Hkv, D), randn(NB, BLK, Hkv, D)
        for pg in range(total // BLK, NP):
            off = max(0, total - pg * BLK)
            pk2[perm[pg], off:] = float("nan")
            pv2[perm[pg], off:] = float("nan")

        def pools(bits, pk, pv):
            if not bits:
                return pk, pv, {}
            kq, ks = kv_quantize(pk, bits)
            vq, vs = kv_quantize(pv, bits)
            return kq, vq, dict(k_scale=ks, v_scale=vs, kv_bits=bits)
        for bits in (0, 8, 4):
            rowb = 2 * D if not bits else (D if bits == 8 else D // 2) + 4
            kq, vq, quant = pools(bits, pk, pv)
            tag = (f"{case.split(':')[0]}: H={H} Hkv={Hkv} D={D} kv_bits "
                   f"{bits} {dtype}")
            got, again = (PA.paged_decode_attention(qd, kq, vq, lens, tables,
                                                    **quant)
                          for _ in range(2))
            want = PA.paged_decode_attention_plain(qd, kq, vq, lens, tables,
                                                   **quant)
            fault = PA.paged_decode_attention_plain(
                qd, kq, vq, (lens - (lens > 0).int()).int(), tables, **quant)
            acc = agree(f"B6 {tag}", got, want, fault, tol)
            rerun = max_err(got, again)
            check(rerun == 0.0, f"B6 {tag}: two launches differ by {rerun}")
            bnd, by = bound_ms(2 * rows * Hkv * rowb + 2 * 8 * H * D * 2
                               + tables.numel() * 4, 4.0 * rows * H * D)
            out.setdefault(build.counter("paged_decode_attention", bits, dt),
                           []).append(dict(
                case=f"8 slots, {tag}", **acc, rerun_diff=rerun,
                tol=tol or (KERNEL_ATOL, KERNEL_RTOL),
                ms=time_ms(lambda: PA.paged_decode_attention(
                    qd, kq, vq, lens, tables, **quant), torch, flush),
                plain_ms=time_ms(lambda: PA.paged_decode_attention_plain(
                    qd, kq, vq, lens, tables, **quant), torch, flush),
                library_ms=None, bound_ms=bnd, bound_by=by))
            kq, vq, quant = pools(bits, pk2, pv2)
            got, again = (PA.paged_prefill_attention(qc, kq, vq, base, clen,
                                                     table, **quant)
                          for _ in range(2))
            want = PA.paged_prefill_attention_plain(qc, kq, vq, base, clen,
                                                    table, **quant)
            fault = PA.paged_prefill_attention_plain(qc, kq, vq, base,
                                                     clen - 1, table, **quant)
            acc = agree(f"B7 {tag}", got, want, fault, tol)
            rerun = max_err(got, again)
            check(rerun == 0.0, f"B7 {tag}: two launches differ by {rerun}")
            bnd, by = bound_ms(2 * total * Hkv * rowb + 2 * 256 * H * D * 2,
                               4.0 * pairs * H * D)
            out.setdefault(build.counter("paged_prefill_attention", bits,
                                         dt), []).append(dict(
                case=f"C=256 base={base} chunk_len={clen}, {tag}", **acc,
                rerun_diff=rerun,
                tol=tol or (KERNEL_ATOL, KERNEL_RTOL),
                ms=time_ms(lambda: PA.paged_prefill_attention(
                    qc, kq, vq, base, clen, table, **quant), torch, flush),
                plain_ms=time_ms(lambda: PA.paged_prefill_attention_plain(
                    qc, kq, vq, base, clen, table, **quant), torch, flush),
                library_ms=None, bound_ms=bnd, bound_by=by))
        del pk, pv, pk2, pv2, kq, vq, qd, qc
        torch.cuda.empty_cache()
    return out


#: (label, micro, heads, T, D, layout block) of the block-sparse cases:
#: 760M's heads over 48-row blocks, 2.7B's over 128-row blocks (bf16)
C1_SPARSE_CASES = (("GPT-3 760M", 2, 16, 3072, 96, 48),
                   ("GPT-3 2.7B", 2, 32, 4096, 80, 128))
#: the float16 block-sparse case: the fp16 block-sparse training phase's
#: attention (GPT-2 125M, micro 8, seq 8192, 64-row blocks)
F16_SPARSE_CASES = (("GPT-2 125M fp16", 8, 12, 8192, 64, 64),)


def c1_sparse_checks(torch, dev, flush, cases=C1_SPARSE_CASES,
                     dtype="bfloat16"):
    """B8, B9 and B10 at ``cases`` in ``dtype``: the new head dims and
    layout blocks (760M's heads, 16 of 96, over a Fixed layout of 48-row
    blocks at T 3072, where the tile pairs carry the layout in 16-row
    sub-blocks, and 2.7B's, 32 of 80, over 128-row blocks at T 4096, micro
    2), and the float16 kernels at the fp16 block-sparse phase's shape;
    causal, 4 local and 1 global block: against their plain versions
    (bf16 limit, or ``F16_TOL`` for float16) with a block left out of one
    layout row as the planted fault, bit-equal on two launches, timed
    beside their bound and SDPA with the layout as a boolean mask.
    Results are keyed by the launch counter."""
    import numpy as np
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig, blocksparse_flash as BS)
    from deepspeed_tpu_torch.ops.transformer import flash_attention as FA
    from deepspeed_tpu_torch.ops import build
    F = torch.nn.functional
    dt = getattr(torch, dtype)
    tol = F16_TOL if dt == torch.float16 else None
    g = torch.Generator(device=dev)
    g.manual_seed(3333)
    out = {}
    for label, B, H, T, D, blk in cases:
        cfg = FixedSparsityConfig(num_heads=H, block=blk, num_local_blocks=4,
                                  num_global_blocks=1,
                                  attention="unidirectional")
        lay = cfg.make_layout(T)
        lay = (lay & np.tril(np.ones_like(lay)))[None]
        lc = BS.compress_layout(lay)
        rows = np.argwhere(lay.sum(-1) >= 2)
        h, r = rows[len(rows) // 3]
        bad = lay.copy()
        bad[h, r, np.nonzero(lay[h, r])[0][-1]] = False
        lc_bad = BS.compress_layout(bad)
        args, bad_args = (lc, blk, H, True), (lc_bad, blk, H, True)
        BH = B * H
        q, k, v, do = (torch.randn((BH, T, D), generator=g,
                                   device=dev).to(dt) for _ in range(4))
        pairs = B * H * visible_pairs(lay, blk, True)
        case = (f"{label}: B*H={BH} T={T} D={D} block={blk} causal, "
                f"{int(lay.sum())} blocks of {lay.size}, {dtype}")
        mask = torch.from_numpy(lay).to(dev)
        mask = (mask.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
                & torch.ones((T, T), dtype=torch.bool, device=dev).tril())
        q4, k4, v4, do4 = (x.view(B, H, T, D) for x in (q, k, v, do))
        qb, rb = BH * T * D * 2, BH * T * 4
        o_p, lse_p = BS.blocksparse_attention_fwd_plain(q, k, v, *args)
        delta = FA._delta(o_p, do)
        runs = {
            "blocksparse_flash_fwd": (
                lambda a=args: BS.blocksparse_attention_fwd(q, k, v, *a)[0],
                lambda a=args: BS.blocksparse_attention_fwd_plain(
                    q, k, v, *a)[0], 4 * qb + rb, 4.0 * D * pairs),
            "blocksparse_flash_bwd_dq": (
                lambda a=args: BS.blocksparse_attention_bwd_dq(
                    q, k, v, o_p, lse_p, do, *a, delta=delta),
                lambda a=args: BS.blocksparse_attention_bwd_dq_plain(
                    q, k, v, o_p, lse_p, do, *a), 5 * qb + 2 * rb,
                6.0 * D * pairs),
            "blocksparse_flash_bwd_dkv": (
                lambda a=args: flat(BS.blocksparse_attention_bwd_dkv(
                    q, k, v, o_p, lse_p, do, *a, delta=delta)),
                lambda a=args: flat(BS.blocksparse_attention_bwd_dkv_plain(
                    q, k, v, o_p, lse_p, do, *a)), 6 * qb + 2 * rb,
                8.0 * D * pairs),
        }
        # B10 timed as called: its outputs, not their f32 concatenation
        timed = {"blocksparse_flash_bwd_dkv": (
            lambda: BS.blocksparse_attention_bwd_dkv(
                q, k, v, o_p, lse_p, do, *args, delta=delta),
            lambda: BS.blocksparse_attention_bwd_dkv_plain(
                q, k, v, o_p, lse_p, do, *args))}
        m4 = mask[None]                                    # [1, 1, T, T]
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4), torch, flush)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))
        sd = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m4)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            sd, (qg, kg, vg), do4, retain_graph=True), torch, flush)
        del sd, qg, kg, vg
        for name, (fn, plain, nbytes, flops) in runs.items():
            got, again = fn(), fn()
            want, fault = plain(), plain(bad_args)
            acc = agree(f"{name} {case}", got, want, fault, tol)
            rerun = max_err(got, again)
            check(rerun == 0.0, f"{name} {case}: two launches differ by "
                                f"{rerun}")
            del got, again, want, fault
            bnd, by = bound_ms(nbytes, flops)
            t_fn, t_plain = timed.get(name, (fn, plain))
            out.setdefault(build.counter(name, dtype=dt), []).append(dict(
                case=case, **acc, rerun_diff=rerun,
                tol=tol or (KERNEL_ATOL, KERNEL_RTOL),
                ms=time_ms(t_fn, torch, flush),
                plain_ms=time_ms(t_plain, torch, flush, N_TIMED_PLAIN, 1),
                library_ms=lib_fwd if name.endswith("fwd") else lib_bwd,
                bound_ms=bnd, bound_by=by))
        del q, k, v, do, o_p, lse_p, delta, mask, m4
        torch.cuda.empty_cache()
    return out


#: phase 3's paged pool (blocks, block size, pages a table) and its 8
#: slots' lengths: two inactive, one of a single row, ragged others
PAGED_POOL = (512, 16, 64)
PAGED_LENGTHS = [1, 17, 200, 513, 0, 96, 0, 255]


def paged_decode_case(torch, randn, dev, hkv, d):
    """Pools ``[512, 16, hkv, d]`` from ``randn`` and the 8 slots' tables
    (shuffled blocks; every unused row of a partly filled page is NaN, and
    a NaN block sits in slot 2's table just past its length): (pk, pv,
    tables, lengths, the shuffled block order)."""
    NB, BLK, NP = PAGED_POOL
    lengths = PAGED_LENGTHS
    pk, pv = randn(NB, BLK, hkv, d), randn(NB, BLK, hkv, d)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(7))
    perm = (perm + 1).tolist()
    tables = torch.zeros((8, NP), dtype=torch.int32)
    cursor = 0
    for i, n in enumerate(lengths):
        pages = -(-n // BLK)
        tables[i, :pages] = torch.tensor(perm[cursor:cursor + pages])
        cursor += pages
        if n % BLK:
            last = tables[i, pages - 1]
            pk[last, n % BLK:] = float("nan")
            pv[last, n % BLK:] = float("nan")
    nan_block = perm[cursor]
    pk[nan_block] = float("nan")
    pv[nan_block] = float("nan")
    tables[2, -(-lengths[2] // BLK)] = nan_block
    return (pk, pv, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev), perm)


def swap_nibbles(torch, pool, block):
    """A copy of a packed-int4 pool with the two nibble halves of every
    byte of ``block``'s rows swapped (features j and j + D/2 exchanged):
    the second planted fault of the int4 cases."""
    bad = pool.clone()
    x = bad[block].to(torch.int32)
    bad[block] = (((x & 0xF) << 4) | ((x >> 4) & 0xF)).to(torch.int8)
    return bad


def quant_kernel_checks(torch, dev, flush):
    """B6 and B7 over int8 and packed-int4 pools against their plain
    versions (which dequantize with ``kv_dequantize``), bf16 queries.  B6:
    the 8-slot case of phase 3 at GPT-3 6.7B's heads (H 32 = Hkv, D 128)
    and TinyLlama-1.1B's (H 32 over Hkv 4, D 64); B7: C 256 at base 0,
    base 256 and a short chunk, 6.7B heads.  The bf16 pools (NaN past every
    length, a NaN block in a table) are encoded with ``kv_quantize``, so
    NaN rows carry NaN scales.  Planted faults: one tail row left out;
    at 4 bits also the nibble halves swapped in one block's rows of the
    plain version's pool (B6: the block of the length-1 slot, whose output
    is that row; B7: the table's first page).  One row alone among
    hundreds moves the output by less than the limit's bf16 ulp, so the
    swap takes a whole block.  Exactness: a single fully attended row
    comes back as the dequantized v row rounded to bf16, through B6 and
    B7."""
    from deepspeed_tpu_torch.ops.quantizer import kv_dequantize, kv_quantize
    from deepspeed_tpu_torch.ops.transformer import (
        paged_decode_attention as PA)
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(2468)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)
    results = {f"{k}_int{b}": [] for k in ("paged_decode_attention",
                                           "paged_prefill_attention")
               for b in (8, 4)}
    H, C = 32, 256
    NB, BLK, NP = PAGED_POOL

    def encode(pk, pv, bits):
        kq, ks = kv_quantize(pk, bits)
        vq, vs = kv_quantize(pv, bits)
        return kq, vq, dict(k_scale=ks, v_scale=vs, kv_bits=bits)

    def nibble_fault(acc, fn, want, kq, vq, quant, block):
        fault = fn(swap_nibbles(torch, kq, block),
                   swap_nibbles(torch, vq, block), quant)
        fm = margin(fault, want)
        check(fm > 1.0, f"the limit misses the nibble-swap fault ({fm:.3g} "
                        f"of the limit)")
        acc.update(nibble_fault_err=max_err(fault, want),
                   nibble_fault_limit_share=fm)
    for hkv, d in ((H, 128), (4, 64)):
        pk, pv, tables, lens, perm = paged_decode_case(torch, randn, dev,
                                                       hkv, d)
        q = randn(8, H, d)
        rows = sum(PAGED_LENGTHS)
        for bits in (8, 4):
            kq, vq, quant = encode(pk, pv, bits)
            name = f"B6 int{bits} Hkv={hkv} D={d}"

            def plain(kq, vq, quant, lens=lens):
                return PA.paged_decode_attention_plain(q, kq, vq, lens,
                                                       tables, **quant)
            got = PA.paged_decode_attention(q, kq, vq, lens, tables, **quant)
            again = PA.paged_decode_attention(q, kq, vq, lens, tables,
                                              **quant)
            want = plain(kq, vq, quant)
            fault = plain(kq, vq, quant, (lens - (lens > 0).int()).int())
            torch.cuda.synchronize()
            acc = agree(name, got, want, fault)
            acc["rerun_diff"] = max_err(got, again)
            check(acc["rerun_diff"] == 0.0, f"{name}: two launches differ")
            check(float(got[4].abs().max()) == 0.0 and
                  float(got[6].abs().max()) == 0.0,
                  f"{name}: inactive slots not zero")
            if bits == 4:
                nibble_fault(acc, plain, want, kq, vq, quant,
                             int(tables[0, 0]))
            if hkv == H:
                # the length-1 slot alone: its output is its v row
                one = tables[:1, :1].contiguous()
                row = PA.paged_decode_attention(
                    q[:1], kq, vq, lens[:1], one, **quant)
                dq = kv_dequantize(vq[int(one[0, 0]), 0],
                                   quant["v_scale"][int(one[0, 0]), 0], bits)
                check(torch.equal(row[0], dq.to(bf16)),
                      f"{name}: a single row is not its dequantized v row")
            ms = time_ms(lambda: PA.paged_decode_attention(
                q, kq, vq, lens, tables, **quant), torch, flush)
            plain_ms = time_ms(lambda: plain(kq, vq, quant), torch, flush)
            de = d if bits == 8 else d // 2
            bnd, by = bound_ms(2 * rows * hkv * (de + 4) + 2 * 8 * H * d * 2
                               + tables.numel() * 4, 4.0 * rows * H * d)
            results[f"paged_decode_attention_int{bits}"].append(dict(
                case=f"8 slots, H {H} over Hkv {hkv}, D {d}, lengths "
                     f"{PAGED_LENGTHS}", **acc, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bnd, bound_by=by))
        del pk, pv
    table = torch.tensor(perm[:NP], dtype=torch.int32, device=dev)
    for base, clen in ((0, 256), (256, 256), (64, 100)):
        pk, pv = randn(NB, BLK, H, 128), randn(NB, BLK, H, 128)
        total = base + clen
        for pg in range(total // BLK, NP):
            off = max(0, total - pg * BLK)
            pk[int(table[pg]), off:] = float("nan")
            pv[int(table[pg]), off:] = float("nan")
        q = randn(C, H, 128)
        pairs = sum(min(total, base + i + 1) for i in range(C))
        for bits in (8, 4):
            kq, vq, quant = encode(pk, pv, bits)
            name = f"B7 int{bits} base={base} len={clen}"

            def plain(kq, vq, quant, clen=clen):
                return PA.paged_prefill_attention_plain(
                    q, kq, vq, base, clen, table, **quant)
            got = PA.paged_prefill_attention(q, kq, vq, base, clen, table,
                                             **quant)
            again = PA.paged_prefill_attention(q, kq, vq, base, clen, table,
                                               **quant)
            want = plain(kq, vq, quant)
            fault = plain(kq, vq, quant, clen - 1)
            torch.cuda.synchronize()
            acc = agree(name, got, want, fault)
            acc["rerun_diff"] = max_err(got, again)
            check(acc["rerun_diff"] == 0.0, f"{name}: two launches differ")
            if bits == 4:
                nibble_fault(acc, plain, want, kq, vq, quant, int(table[0]))
            if base == 0:
                # query 0 sees key 0 alone: its output is v row 0
                first = PA.paged_prefill_attention(q[:1], kq, vq, 0, 1,
                                                   table, **quant)
                dq = kv_dequantize(vq[int(table[0]), 0],
                                   quant["v_scale"][int(table[0]), 0], bits)
                check(torch.equal(first[0], dq.to(bf16)),
                      f"{name}: a single row is not its dequantized v row")
            ms = time_ms(lambda: PA.paged_prefill_attention(
                q, kq, vq, base, clen, table, **quant), torch, flush)
            plain_ms = time_ms(lambda: plain(kq, vq, quant), torch, flush)
            de = 128 if bits == 8 else 64
            bnd, by = bound_ms(2 * total * H * (de + 4) + 2 * C * H * 128 * 2,
                               4.0 * pairs * H * 128)
            results[f"paged_prefill_attention_int{bits}"].append(dict(
                case=f"C={C} base={base} chunk_len={clen}", **acc, ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bnd,
                bound_by=by))
        del pk, pv
    torch.cuda.empty_cache()
    return results


def fault_keep(torch, T, causal, dev):
    """The planted fault's visibility mask: each query's last visible key
    left out (the diagonal key of rows >= 1 when causal; row 0 keeps its
    only key), or the last key of every row without the causal mask."""
    keep = torch.ones((T, T), dtype=torch.bool, device=dev)
    if causal:
        keep = keep.tril()
        drop = torch.arange(1, T, device=dev)
        keep[drop, drop] = False
    else:
        keep[:, T - 1] = False
    return keep


def flat(ts):
    """One f32 vector of every tensor of ``ts`` (a kernel's outputs)."""
    import torch
    return torch.cat([t.float().flatten() for t in ts])


def flash_checks(torch, dev, flush):
    """B1 and B2 at the training shape (B*H = 64 x 12, T = 1024, D = 64,
    causal), at a ragged T (1000) and without the causal mask.  The
    planted fault is the plain version with each query's last visible
    key left out (row 0 of a causal case keeps its only key)."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as FA
    F = torch.nn.functional
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    BH, D = TRAIN_MICRO * 12, 64
    b1, b2 = [], []
    for T, causal in ((1024, True), (1000, True), (1024, False)):
        q, k, v, do = (torch.randn((BH, T, D), generator=g,
                                   device=dev).to(bf16) for _ in range(4))
        keep = fault_keep(torch, T, causal, dev)
        case = f"B*H={BH} T={T} D={D} {'causal' if causal else 'full'}"
        # B1
        o, lse = FA.flash_attention_fwd(q, k, v, causal)
        o_p, lse_p = FA.flash_attention_fwd_plain(q, k, v, causal)
        o_f, _ = FA.flash_attention_fwd_plain(q, k, v, causal, keep=keep)
        o2, lse2 = FA.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        acc = agree(f"B1 {case}", o, o_p, o_f)
        lse_err = max_err(lse, lse_p)
        check(lse_err <= LSE_ATOL, f"B1 {case}: lse off by {lse_err}")
        rerun = max(max_err(o, o2), max_err(lse, lse2))
        check(rerun == 0.0, f"B1 {case}: two launches differ by {rerun}")
        del o2, lse2
        ms = time_ms(lambda: FA.flash_attention_fwd(q, k, v, causal), torch,
                     flush)
        plain = time_ms(lambda: FA.flash_attention_fwd_plain(q, k, v,
                                                             causal),
                        torch, flush)
        q4, k4, v4 = (x.view(1, BH, T, D) for x in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), torch, flush)
        pairs = BH * (T * (T + 1) // 2 if causal else T * T)
        nbytes = 4 * BH * T * D * 2 + BH * T * 4
        bnd, by = bound_ms(nbytes, 4.0 * D * pairs)
        b1.append(dict(case=case, **acc, lse_err=lse_err, rerun_diff=rerun,
                       ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by))
        # B2, from the sound forward's o and lse
        got = FA.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
        want = FA.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal)
        fault = FA.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do,
                                             causal, keep=keep)
        again = FA.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
        torch.cuda.synchronize()
        acc = agree(f"B2 {case}", flat(got), flat(want), flat(fault))
        rerun = max_err(flat(got), flat(again))
        check(rerun == 0.0, f"B2 {case}: two launches differ by {rerun}")
        del want, fault, again
        # the wrapper's call, delta = rowsum(dO * O) computed in it in
        # eager PyTorch, as SDPA's backward computes its own; then that
        # rowsum alone, and the kernel alone with delta given
        ms = time_ms(lambda: FA.flash_attention_bwd(q, k, v, o_p, lse_p, do,
                                                    causal), torch, flush)
        delta_ms = time_ms(lambda: FA._delta(o_p, do), torch, flush)
        delta = FA._delta(o_p, do)
        kernel_ms = time_ms(lambda: FA.flash_attention_bwd(
            q, k, v, o_p, lse_p, do, causal, None, delta), torch, flush)
        # the other layout of the same two walks, delta given: two
        # launches, B3's kernel then B4's at g = 1
        split = time_ms(lambda: (
            FA.flash_attention_bwd_dq(q, k, v, o_p, lse_p, do, causal, None,
                                      delta),
            FA.flash_attention_bwd_dkv(q, k, v, o_p, lse_p, do, causal, None,
                                       delta)), torch, flush)
        plain = time_ms(lambda: FA.flash_attention_bwd_plain(
            q, k, v, o_p, lse_p, do, causal), torch, flush)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        do4 = do.view(1, BH, T, D)
        lib = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do4, retain_graph=True), torch, flush)
        del out
        nbytes = 7 * BH * T * D * 2 + 2 * BH * T * 4
        bnd, by = bound_ms(nbytes, 10.0 * D * pairs)
        b2.append(dict(case=case, **acc, rerun_diff=rerun, ms=ms,
                       delta_ms=delta_ms, kernel_ms=kernel_ms,
                       split_ms=split, plain_ms=plain, library_ms=lib,
                       bound_ms=bnd, bound_by=by))
    return {"flash_attention_fwd": b1, "flash_attention_bwd": b2}


def gqa_flash_checks(torch, dev, flush):
    """B1 with a kv group, B3 and B4 at TinyLlama-1.1B's training shape
    (micro 8: B*H = 256 query heads over B*KVH = 32 kv heads, T = 2048,
    D = 64, bf16, causal), at a ragged T (2000), without the causal mask,
    and with one kv head per query head (g = 1) at T = 2048, which spans
    two 1024-row blocks and so also runs B3/B4.  The planted fault is the
    plain version with each query's last visible key left out; B3 and B4
    are run twice and must give the same bits.  The yardstick is SDPA
    with ``enable_gqa``: its forward for B1, its backward (dq, dk and dv
    in one call) for B3 and B4 together."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as FA
    F = torch.nn.functional
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(5678)
    B, H, D = LLAMA_MICRO, 32, 64
    BH = B * H
    b1, b3, b4 = [], [], []

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)
    for T, causal, group in ((2048, True, 8), (2000, True, 8),
                             (2048, False, 8), (2048, True, 1)):
        BKV = BH // group
        q, do = randn(BH, T, D), randn(BH, T, D)
        k, v = randn(BKV, T, D), randn(BKV, T, D)
        keep = fault_keep(torch, T, causal, dev)
        case = (f"B*H={BH} B*KVH={BKV} T={T} D={D} "
                f"{'causal' if causal else 'full'}")
        pairs = BH * (T * (T + 1) // 2 if causal else T * T)
        qbytes, kvbytes, rowbytes = BH * T * D * 2, BKV * T * D * 2, BH * T * 4
        q4 = q.view(B, H, T, D)
        k4, v4 = (x.view(B, H // group, T, D) for x in (k, v))
        # B1
        o, lse = FA.flash_attention_fwd(q, k, v, causal)
        o_p, lse_p = FA.flash_attention_fwd_plain(q, k, v, causal)
        o_f, _ = FA.flash_attention_fwd_plain(q, k, v, causal, keep=keep)
        o2, lse2 = FA.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        acc = agree(f"B1 {case}", o, o_p, o_f)
        lse_err = max_err(lse, lse_p)
        check(lse_err <= LSE_ATOL, f"B1 {case}: lse off by {lse_err}")
        rerun = max(max_err(o, o2), max_err(lse, lse2))
        check(rerun == 0.0, f"B1 {case}: two launches differ by {rerun}")
        del o_f, o2, lse2
        ms = time_ms(lambda: FA.flash_attention_fwd(q, k, v, causal), torch,
                     flush)
        plain = time_ms(lambda: FA.flash_attention_fwd_plain(q, k, v,
                                                             causal),
                        torch, flush, N_TIMED_PLAIN, 1)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=True), torch, flush)
        bnd, by = bound_ms(2 * qbytes + 2 * kvbytes + rowbytes,
                           4.0 * D * pairs)
        b1.append(dict(case=case, **acc, lse_err=lse_err, rerun_diff=rerun,
                       ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by))
        del o, lse
        # SDPA's backward: dq, dk and dv in one call (B3 + B4's yardstick)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             enable_gqa=True)
        do4 = do.view(B, H, T, D)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do4, retain_graph=True), torch, flush)
        del out, qg, kg, vg
        delta = (do.float() * o_p.float()).sum(dim=-1)
        # B3, from the sound forward's o and lse
        got = FA.flash_attention_bwd_dq(q, k, v, o_p, lse_p, do, causal)
        again = FA.flash_attention_bwd_dq(q, k, v, o_p, lse_p, do, causal)
        want = FA.flash_attention_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                               causal)
        fault = FA.flash_attention_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                                causal, keep=keep)
        torch.cuda.synchronize()
        acc = agree(f"B3 {case}", got, want, fault)
        rerun = max_err(got, again)
        check(rerun == 0.0, f"B3 {case}: two launches differ by {rerun}")
        del got, again, want, fault
        ms = time_ms(lambda: FA.flash_attention_bwd_dq(
            q, k, v, o_p, lse_p, do, causal, None, delta), torch, flush)
        plain = time_ms(lambda: FA.flash_attention_bwd_dq_plain(
            q, k, v, o_p, lse_p, do, causal), torch, flush, N_TIMED_PLAIN, 1)
        bnd, by = bound_ms(3 * qbytes + 2 * kvbytes + 2 * rowbytes,
                           6.0 * D * pairs)
        b3.append(dict(case=case, **acc, rerun_diff=rerun, ms=ms,
                       plain_ms=plain, library_ms=lib_bwd, bound_ms=bnd,
                       bound_by=by))
        # B4
        got = FA.flash_attention_bwd_dkv(q, k, v, o_p, lse_p, do, causal)
        again = FA.flash_attention_bwd_dkv(q, k, v, o_p, lse_p, do, causal)
        want = FA.flash_attention_bwd_dkv_plain(q, k, v, o_p, lse_p, do,
                                                causal)
        fault = FA.flash_attention_bwd_dkv_plain(q, k, v, o_p, lse_p, do,
                                                 causal, keep=keep)
        torch.cuda.synchronize()
        acc = agree(f"B4 {case}", flat(got), flat(want), flat(fault))
        rerun = max_err(flat(got), flat(again))
        check(rerun == 0.0, f"B4 {case}: two launches differ by {rerun}")
        del got, again, want, fault
        ms = time_ms(lambda: FA.flash_attention_bwd_dkv(
            q, k, v, o_p, lse_p, do, causal, None, delta), torch, flush)
        plain = time_ms(lambda: FA.flash_attention_bwd_dkv_plain(
            q, k, v, o_p, lse_p, do, causal), torch, flush, N_TIMED_PLAIN, 1)
        bnd, by = bound_ms(2 * qbytes + 4 * kvbytes + 2 * rowbytes,
                           8.0 * D * pairs)
        b4.append(dict(case=case, **acc, rerun_diff=rerun, ms=ms,
                       plain_ms=plain, library_ms=lib_bwd, bound_ms=bnd,
                       bound_by=by))
        del q, k, v, do, o_p, lse_p, delta
        torch.cuda.empty_cache()
    return {"flash_attention_fwd": b1, "flash_attention_bwd_dq": b3,
            "flash_attention_bwd_dkv": b4}


#: the libraries whose bf16 kernels run their products on the tensor
#: cores, and the name of that kernel in each
TENSOR_CORE_KERNELS = {"flash_attention_fwd": "flash_fwd_mma_kernel",
                       "blocksparse_flash_fwd": "bsa_fwd_mma_kernel",
                       "flash_attention_bwd": "flash_bwd_mma_kernel",
                       "flash_attention_bwd_dq": "flash_bwd_dq_mma_kernel",
                       "flash_attention_bwd_dkv": "flash_bwd_dkv_mma_kernel",
                       "blocksparse_flash_bwd_dq": "bsa_bwd_dq_mma_kernel",
                       "blocksparse_flash_bwd_dkv": "bsa_bwd_dkv_mma_kernel"}


def short_name(fn: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    ``flash_bwd_mma_kernel<Li48E6__half>``."""
    m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)I(.+?)EE", fn)
    return f"{m.group(1)}<{m.group(2)}>" if m else fn[:80]


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of every kernel in an ``-Xptxas -v``
    report, by mangled name."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


#: ``cuobjdump -sass`` of each library phase 3 reads, by library name
_SASS: dict = {}


def dump_sass(build, names) -> None:
    """``cuobjdump -sass`` of the libraries ``names``, all at once (one
    process each, on the host's cores), into ``_SASS``."""
    from concurrent.futures import ThreadPoolExecutor
    tool = Path(build.nvcc_path()).with_name("cuobjdump")

    def one(name):
        return subprocess.run([str(tool), "-sass",
                               str(build.library_path(name))], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
    with ThreadPoolExecutor(len(names)) as pool:
        _SASS.update(zip(names, pool.map(one, names)))


def tensor_core_check(build) -> dict:
    """Phase 3's proof that the bf16 and f16 B1, B2, B3, B4, B8, B9 and
    B10 run on the tensor cores: ``cuobjdump -sass`` of each built
    library must hold mma instructions (``HMMA``; ``HGMMA`` for wgmma),
    ptxas must report the tensor-core kernel at every head dim of
    ``build.FLASH_HEAD_DIMS`` in bf16 and f16 and no spill at D 64 (the
    main paths' head dim).  Prints the counts and each
    instantiation's registers and spills."""
    out = {}
    for name, kernel in TENSOR_CORE_KERNELS.items():
        path = build.library_path(name)
        sass = _SASS[name]
        counts = {op: sass.count(f" {op}.") for op in ("HMMA", "HGMMA")}
        check(counts["HMMA"] + counts["HGMMA"] > 0,
              f"{name}: no tensor-core instruction in its SASS")
        regs = {}
        for fn, rep in ptxas_report(Path(f"{path}.log").read_text()).items():
            m = re.search(kernel + r"ILi(\d+)E(6__half)?", fn)
            if m:
                regs[int(m.group(1)), "f16" if m.group(2) else "bf16"] = rep
        types = ("bf16", "f16")
        want = {(d, t) for d in build.FLASH_HEAD_DIMS for t in types}
        check(set(regs) == want,
              f"{name}: ptxas reported {sorted(regs)} of {kernel}'s (head "
              f"dim, dtype)")
        for t in types:
            check(regs[64, t].get("spill", 0) == 0,
                  f"{name}: {kernel} spills {regs[64, t]['spill']} bytes at "
                  f"D 64 ({t})")
        print(f"tensor cores: {name}: {counts['HMMA']} HMMA, "
              f"{counts['HGMMA']} HGMMA in its SASS; {kernel} " + ", ".join(
                  f"D {d} {t}: {r.get('registers')} registers, "
                  f"{r.get('spill', 0)} bytes spilled"
                  for (d, t), r in sorted(regs.items())))
        out[name] = dict(sass=counts, ptxas=regs)
    return out


def paged_kernel_check(build) -> dict:
    """Phase 3's proof that the bf16 and f16 B7 run on the tensor cores:
    ``cuobjdump -sass`` of its library must hold ``HMMA``, and ptxas must
    report ``paged_prefill_mma_kernel`` at every multiple of 16 up to 128
    for kv_bits 0, 8 and 4 in bf16 and f16, with no spill at D 64, 80 and
    128 (the served head dims) where the kv group fills the tile (the
    split-group instantiations are printed apart).  Prints
    the count and the registers of every instantiation of B7's
    tensor-core kernel and of B6's cluster kernel (D 8-256)."""
    out = {}
    for name, kernel in (("paged_prefill_attention",
                          "paged_prefill_mma_kernel"),
                         ("paged_decode_attention",
                          "paged_decode_cluster_kernel")):
        path = build.library_path(name)
        sass = _SASS[name]
        hmma = sass.count(" HMMA.")
        regs, split = {}, {}
        for fn, rep in ptxas_report(Path(f"{path}.log").read_text()).items():
            m = re.search(kernel + r"ILi(\d+)ELi(\d+)E(?:Li4ELb([01])E)?"
                          r"(6__half)?", fn)
            if m:
                (split if m.group(3) == "1" else regs)[
                    int(m.group(1)), int(m.group(2)),
                    "f16" if m.group(4) else "bf16"] = rep
        if name == "paged_prefill_attention":
            check(hmma > 0, f"{name}: no tensor-core instruction in its SASS")
            want = {(d, b, t) for d in range(16, 129, 16) for b in (0, 8, 4)
                    for t in ("bf16", "f16")}
            check(set(regs) == want, f"{name}: ptxas reported "
                  f"{sorted(regs)} of {kernel}'s (head dim, kv_bits, "
                  f"dtype)")
            for (d, b, t), rep in regs.items():
                check(d not in (64, 80, 128) or rep.get("spill", 0) == 0,
                      f"{name}: {kernel} spills {rep['spill']} bytes at D "
                      f"{d}, kv_bits {b}, {t}")
        print(f"paged kernels: {name}: {hmma} HMMA in its SASS; {kernel} "
              + ", ".join(f"D {d} kv_bits {b} {t}: {r.get('registers')} "
                          f"registers, {r.get('spill', 0)} bytes spilled"
                          for (d, b, t), r in sorted(regs.items()))
              + ("; with a split group: " + ", ".join(
                  f"D {d} kv_bits {b} {t}: {r.get('registers')} registers, "
                  f"{r.get('spill', 0)} bytes spilled"
                  for (d, b, t), r in sorted(split.items())) if split
                 else ""))
        out[name] = dict(hmma=hmma, ptxas=regs)
    return out


#: the block-sparse slice's layout (GPT-2 125M's 12 heads at seq 8192)
def sparse_config(heads: int = 12):
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    return FixedSparsityConfig(num_heads=heads, block=64, num_local_blocks=4,
                               num_global_blocks=1,
                               attention="unidirectional")


def visible_pairs(lay, block: int, causal: bool) -> int:
    """(q, k) pairs one sequence's heads see under a bool block layout
    ``[heads, nb, nb]``: a whole block off the diagonal, the lower
    triangle with the diagonal of a diagonal block when causal."""
    import numpy as np
    n = int(lay.sum())
    if not causal:
        return n * block * block
    diag = int(np.trace(lay, axis1=1, axis2=2).sum())
    return (n - diag) * block * block + diag * block * (block + 1) // 2


def sparse_kernel_cases():
    """(tag, B, H, T, D, causal, block, bool layout ``[1|H, nb, nb]``) of
    phase 3's block-sparse cases: (a) the training shape of phase 9 (B*H
    = 8 x 12, T 8192, D 64, ``sparse_config()``: 64-row blocks, causal);
    (b) ``bench_all.py``'s block-sparse lane (B*H = 1 x 8, T 16384, D
    128, a causal sliding window of three 512-row blocks: each block
    spans 8 x 8 tiles); (c) 16-row blocks of a BigBird layout drawn per
    head (a different seed for each of 12 heads), non-causal, B*H = 2 x
    12, T 2048, D 64 (4 x 4 sub-blocks share each 64-row tile pair)."""
    import numpy as np
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, LocalSlidingWindowSparsityConfig)

    def causal_layout(cfg, t_len):
        lay = cfg.make_layout(t_len)
        return (lay & np.tril(np.ones_like(lay)))[None]
    big = [BigBirdSparsityConfig(block=16, num_random_blocks=2, seed=h)
           for h in range(12)]
    return (
        ("a", 8, 12, 8192, 64, True, 64,
         causal_layout(sparse_config(), 8192)),
        ("b", 1, 8, 16384, 128, True, 512, causal_layout(
            LocalSlidingWindowSparsityConfig(
                num_heads=8, block=512, num_sliding_window_blocks=3),
            16384)),
        ("c", 2, 12, 2048, 64, False, 16,
         np.stack([c.make_layout(2048) for c in big])),
    )


def blocksparse_checks(torch, dev, flush):
    """B8, B9 and B10 against their plain versions (which walk the same
    compressed layout one tile at a time) in the cases of
    ``sparse_kernel_cases()``.  The planted fault is the
    plain version with one set block left out of one row of its layout;
    B9 and B10 run twice and must give the same bits.  Yardsticks: SDPA
    with the layout expanded into a boolean ``attn_mask`` (its forward
    for B8, its backward for B9 + B10: the same function with dense
    work), and dense B1, B3 and B4 on the same inputs (what the sparsity
    saves)."""
    import numpy as np
    from deepspeed_tpu_torch.ops.sparse_attention import (
        blocksparse_flash as BS)
    from deepspeed_tpu_torch.ops.transformer import flash_attention as FA
    F = torch.nn.functional
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(8765)
    b8, b9, b10 = [], [], []
    for tag, B, H, T, D, causal, blk, lay in sparse_kernel_cases():
        BH = B * H
        q, k, v, do = (torch.randn((BH, T, D), generator=g,
                                   device=dev).to(bf16) for _ in range(4))
        lc = BS.compress_layout(lay)
        # the planted fault: a row with two or more blocks loses its last
        rows = np.argwhere(lay.sum(-1) >= 2)
        h, r = rows[len(rows) // 3]
        bad = lay.copy()
        bad[h, r, np.nonzero(lay[h, r])[0][-1]] = False
        lc_bad = BS.compress_layout(bad)
        args = (lc, blk, H, causal)
        pairs = B * (H // lay.shape[0]) * visible_pairs(lay, blk, causal)
        case = (f"({tag}) B*H={BH} T={T} D={D} block={blk} "
                f"{'causal' if causal else 'full'}, "
                f"{int(lay.sum())} blocks of {lay.size}, {pairs} pairs")
        mask = torch.from_numpy(lay).to(dev)
        mask = mask.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
        if causal:
            mask = mask & torch.ones((T, T), dtype=torch.bool,
                                     device=dev).tril()
        mask = mask[None]                                  # [1, H|1, T, T]
        q4, k4, v4, do4 = (x.view(B, H, T, D) for x in (q, k, v, do))
        qbytes, rowbytes = BH * T * D * 2, BH * T * 4
        # B8
        o, lse = BS.blocksparse_attention_fwd(q, k, v, *args)
        o2, lse2 = BS.blocksparse_attention_fwd(q, k, v, *args)
        o_p, lse_p = BS.blocksparse_attention_fwd_plain(q, k, v, *args)
        o_f, _ = BS.blocksparse_attention_fwd_plain(q, k, v, lc_bad, blk, H,
                                                    causal)
        torch.cuda.synchronize()
        acc = agree(f"B8 {case}", o, o_p, o_f)
        lse_err = max_err(lse, lse_p)
        check(lse_err <= LSE_ATOL, f"B8 {case}: lse off by {lse_err}")
        rerun = max(max_err(o, o2), max_err(lse, lse2))
        check(rerun == 0.0, f"B8 {case}: two launches differ by {rerun}")
        del o, lse, o_f, o2, lse2
        ms = time_ms(lambda: BS.blocksparse_attention_fwd(q, k, v, *args),
                     torch, flush)
        plain = time_ms(lambda: BS.blocksparse_attention_fwd_plain(
            q, k, v, *args), torch, flush, N_TIMED_PLAIN, 1)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask), torch, flush, N_TIMED_PLAIN, 1)
        dense = time_ms(lambda: FA.flash_attention_fwd(q, k, v, causal),
                        torch, flush, N_TIMED_PLAIN, 1)
        bnd, by = bound_ms(4 * qbytes + rowbytes, 4.0 * D * pairs)
        b8.append(dict(case=case, **acc, lse_err=lse_err, rerun_diff=rerun,
                       ms=ms, plain_ms=plain, library_ms=lib, dense_ms=dense,
                       bound_ms=bnd, bound_by=by, pairs=pairs))
        # SDPA's backward with the mask: B9 + B10's yardstick
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do4, retain_graph=True), torch, flush,
            N_TIMED_PLAIN, 1)
        del out, qg, kg, vg
        delta = (do.float() * o_p.float()).sum(dim=-1)
        bwd = (q, k, v, o_p, lse_p, do)
        # B9, from the sound forward's o and lse
        got = BS.blocksparse_attention_bwd_dq(*bwd, *args)
        again = BS.blocksparse_attention_bwd_dq(*bwd, *args)
        want = BS.blocksparse_attention_bwd_dq_plain(*bwd, *args)
        fault = BS.blocksparse_attention_bwd_dq_plain(*bwd, lc_bad, blk, H,
                                                      causal)
        torch.cuda.synchronize()
        acc = agree(f"B9 {case}", got, want, fault)
        rerun = max_err(got, again)
        check(rerun == 0.0, f"B9 {case}: two launches differ by {rerun}")
        del got, again, want, fault
        ms = time_ms(lambda: BS.blocksparse_attention_bwd_dq(
            *bwd, *args, None, delta), torch, flush)
        plain = time_ms(lambda: BS.blocksparse_attention_bwd_dq_plain(
            *bwd, *args), torch, flush, N_TIMED_PLAIN, 1)
        dense = time_ms(lambda: FA.flash_attention_bwd_dq(
            *bwd, causal, None, delta), torch, flush, N_TIMED_PLAIN, 1)
        bnd, by = bound_ms(5 * qbytes + 2 * rowbytes, 6.0 * D * pairs)
        b9.append(dict(case=case, **acc, rerun_diff=rerun, ms=ms,
                       plain_ms=plain, library_ms=lib_bwd, dense_ms=dense,
                       bound_ms=bnd, bound_by=by, pairs=pairs))
        # B10
        got = BS.blocksparse_attention_bwd_dkv(*bwd, *args)
        again = BS.blocksparse_attention_bwd_dkv(*bwd, *args)
        want = BS.blocksparse_attention_bwd_dkv_plain(*bwd, *args)
        fault = BS.blocksparse_attention_bwd_dkv_plain(*bwd, lc_bad, blk, H,
                                                       causal)
        torch.cuda.synchronize()
        acc = agree(f"B10 {case}", flat(got), flat(want), flat(fault))
        rerun = max_err(flat(got), flat(again))
        check(rerun == 0.0, f"B10 {case}: two launches differ by {rerun}")
        del got, again, want, fault
        ms = time_ms(lambda: BS.blocksparse_attention_bwd_dkv(
            *bwd, *args, None, delta), torch, flush)
        plain = time_ms(lambda: BS.blocksparse_attention_bwd_dkv_plain(
            *bwd, *args), torch, flush, N_TIMED_PLAIN, 1)
        dense = time_ms(lambda: FA.flash_attention_bwd_dkv(
            *bwd, causal, None, delta), torch, flush, N_TIMED_PLAIN, 1)
        bnd, by = bound_ms(6 * qbytes + 2 * rowbytes, 8.0 * D * pairs)
        b10.append(dict(case=case, **acc, rerun_diff=rerun, ms=ms,
                        plain_ms=plain, library_ms=lib_bwd, dense_ms=dense,
                        bound_ms=bnd, bound_by=by, pairs=pairs))
        # the whole backward as the autograd function runs it (eager
        # delta = rowsum(dO * O), then B9 and B10): the span SDPA's
        # masked backward covers
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = BS.blocksparse_attention(qg, kg, vg, *args)
        whole = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), torch, flush)
        delta_ms = time_ms(lambda: FA._delta(o_p, do), torch, flush)
        del out, qg, kg, vg
        for rec in (b9[-1], b10[-1]):
            rec.update(backward_ms=whole, delta_ms=delta_ms)
        if tag == "a":
            # B10's walks (query tiles a kv tile's list holds) and both
            # kernels over the local blocks alone: no summary column, so
            # every walk is as long as its window
            cnt = BS.tile_layout(lc, blk, T).kv_walk[1]
            w = np.arange(lay.shape[-1]) // sparse_config().num_local_blocks
            local = ((w[:, None] == w[None, :])
                     & np.tril(np.ones_like(lay[0])))[None]
            lc_local = BS.compress_layout(local)
            largs = (lc_local, blk, H, causal)
            o_l, lse_l = BS.blocksparse_attention_fwd(q, k, v, *largs)
            d_l = FA._delta(o_l, do)
            lbwd = (q, k, v, o_l, lse_l, do)
            b10[-1].update(
                walk_max=int(cnt.max()), walk_mean=float(cnt.mean()),
                local_pairs=B * H * visible_pairs(local, blk, causal),
                local_dq_ms=time_ms(lambda: BS.blocksparse_attention_bwd_dq(
                    *lbwd, *largs, None, d_l), torch, flush),
                local_dkv_ms=time_ms(
                    lambda: BS.blocksparse_attention_bwd_dkv(
                        *lbwd, *largs, None, d_l), torch, flush))
            del o_l, lse_l, d_l, lbwd
        del q, k, v, do, o_p, lse_p, delta, mask, bwd
        torch.cuda.empty_cache()
    return {"blocksparse_flash_fwd": b8, "blocksparse_flash_bwd_dq": b9,
            "blocksparse_flash_bwd_dkv": b10}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        only = set(argv[1:])
        if argv[0] != "--only" or not only or not only <= ONLY_PHASES:
            print(f"usage: python3 chip_smoke.py [--only PHASE ...] with "
                  f"PHASE in {sorted(ONLY_PHASES)}", file=sys.stderr)
            return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "deepspeed_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} holds no deepspeed_tpu_torch package; "
              f"run from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    from deepspeed_tpu_torch import hf_llama_config, hf_neox_config
    from deepspeed_tpu_torch.accelerator import device_report, nvidia_smi_line
    from deepspeed_tpu_torch.models.transformer import gpt2_config, neox_config
    from deepspeed_tpu_torch.module_inject.policies import (GPT_NEOX_20B,
                                                            TINYLLAMA_1_1B)
    from deepspeed_tpu_torch.ops import build
    dev = torch.device("cuda", 0)

    # -- 1. environment ------------------------------------------------
    host_report()
    rep = device_report(dev)
    print(f"card: {rep['nvidia_smi']} (capability {rep['capability']}, "
          f"{rep['sms']} SMs, {rep['memory_bytes'] / 2**30:.1f} GiB)")
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    nv = subprocess.run([build.nvcc_path(), "--version"], check=True,
                        capture_output=True, text=True, timeout=60)
    print("nvcc: " + nv.stdout.strip().splitlines()[-1])

    # -- 2. build ----------------------------------------------------------
    t_start = time.perf_counter()

    def elapsed(what):
        print(f"[{what} done at {time.perf_counter() - t_start:.0f} s]")
    t0 = time.perf_counter()
    libs = build.build()
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    for name, path in libs.items():
        log = Path(f"{path}.log").read_text()
        rep = ptxas_report(log)
        spills = {short_name(fn): r["spill"] for fn, r in rep.items()
                  if r.get("spill")}
        secs = [float(x) for x in
                re.findall(r"nvcc wall time: ([\d.]+) s", log)]
        print(f"  {name}: {len(rep)} kernels"
              + (f" in {max(secs)} s" if secs else "")
              + (f" ({len(secs)} parts)" if len(secs) > 1 else "")
              + f", at most {max(r.get('registers', 0) for r in rep.values())}"
              f" registers; spilling: " + (", ".join(
                  f"{fn} {n} bytes" for fn, n in spills.items()) or "none"))

    elapsed("phase 2")
    if only is not None:
        return partial_run(torch, np, dev, only, elapsed)

    # -- 3. kernels against their plain versions -----------------------
    dump_sass(build, [*TENSOR_CORE_KERNELS, "paged_prefill_attention",
                      "paged_decode_attention"])
    elapsed("phase 3's cuobjdump -sass")
    tensor_core_check(build)
    paged_kernel_check(build)
    elapsed("phase 3's SASS and ptxas checks")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    kres = kernel_checks(torch, dev, flush)
    for name, cases in kres.items():
        for c in cases:
            atol, rtol = c.get("tol", (KERNEL_ATOL, KERNEL_RTOL))
            print(f"kernel {name} [{c['case']}]: max|err| "
                  f"{c['max_abs_err']:.3g} = {c['limit_share']:.3g} of the "
                  f"limit (atol {atol}, rtol {rtol}); planted "
                  f"fault {c['fault_err']:.3g} = "
                  f"{c['fault_limit_share']:.3g} of it; {c['ms']:.4f} ms, plain "
                  f"{c['plain_ms']:.4f} ms, library "
                  f"{'-' if c['library_ms'] is None else '%.4f' % c['library_ms']}"
                  f" ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
                  + (f"; lse max|err| {c['lse_err']:.3g}"
                     if "lse_err" in c else "")
                  + (f"; two launches differ by {c['rerun_diff']:.3g}"
                     if "rerun_diff" in c else "")
                  + (f"; of it rowsum(dO * O) {c['delta_ms']:.4f} ms; the "
                     f"kernel alone (delta given) {c['kernel_ms']:.4f} ms, "
                     f"as two launches (B3 then B4 at g 1) "
                     f"{c['split_ms']:.4f} ms" if "split_ms" in c else "")
                  + (f"; dense kernel {c['dense_ms']:.4f} ms"
                     if "dense_ms" in c else "")
                  + (f"; plan {c['plan'][0]} split(s) of {c['plan'][1]} "
                     f"positions" if "plan" in c else "")
                  + (f"; the cache expanded over the group "
                     f"(repeat_interleave) then B5 {c['expand_ms']:.4f} ms"
                     if "expand_ms" in c else "")
                  + (f"; the whole backward (eager rowsum(dO * O) "
                     f"{c['delta_ms']:.4f} ms, B9, B10) "
                     f"{c['backward_ms']:.4f} ms against SDPA's masked "
                     f"backward {c['library_ms']:.4f} ms"
                     if "backward_ms" in c else "")
                  + (f"; B10's walks: longest {c['walk_max']}, mean "
                     f"{c['walk_mean']:.2f} query tiles; the local blocks "
                     f"alone ({c['local_pairs']} pairs, no summary column):"
                     f" B9 {c['local_dq_ms']:.4f} ms, B10 "
                     f"{c['local_dkv_ms']:.4f} ms"
                     if "walk_max" in c else "")
                  + (f"; nibble-swap fault {c['nibble_fault_err']:.3g} = "
                     f"{c['nibble_fault_limit_share']:.3g} of the limit"
                     if "nibble_fault_err" in c else ""))
    del flush

    elapsed("phase 3")

    # -- 4-5. generate(), forward() and the server at GPT-3 6.7B width --
    # -- 24-27. then on the same engine: the speculative lane, the
    # multi-tenant front end and observability, the tiered host cache and
    # the replica fleet ------------------------------------------------
    served = serve_phase(torch, np, "GPT-3 6.7B", gpt2_config("6.7b"),
                         then=lambda eng: spec_front_phases(torch, np, eng,
                                                            elapsed))

    elapsed("phases 4-5, 24-27")

    # -- 6. training GPT-2 125M at bench.py's configuration -------------
    tck = TENSOR_CORE_KERNELS

    def gpt2_optimizer():        # bench.py:171-180
        return {"type": "AdamW", "params": {"lr": 6e-4, "weight_decay": 0.1}}
    gpt2 = gpt2_train_phase(torch, np)

    elapsed("phase 6")

    # -- 7. training TinyLlama-1.1B ---------------------------------------
    def llama_model(attn_impl):
        return hf_llama_config(TINYLLAMA_1_1B, remat="full",
                               attn_impl=attn_impl, loss_chunk=256)
    llama_opt = {"type": "AdamW", "params": {
        "lr": 4e-4, "weight_decay": 0.1, "betas": [0.9, 0.95]}}
    n_layers = llama_model("flash").num_layers
    llama = train_phase(torch, np, "TinyLlama-1.1B", llama_model, llama_opt,
                        LLAMA_MICRO, LLAMA_SEQ, LLAMA_STEPS,
                        {"flash_attention_fwd": 2 * n_layers,
                         "flash_attention_bwd": 0,
                         "flash_attention_bwd_dq": n_layers,
                         "flash_attention_bwd_dkv": n_layers},
                        check_micro=LLAMA_CHECK_MICRO,
                        profile_shares={
                            "B1": (tck["flash_attention_fwd"],),
                            "B3 + B4": (tck["flash_attention_bwd_dq"],
                                        tck["flash_attention_bwd_dkv"])})

    elapsed("phase 7")

    # -- 8. generate(), forward() and the server for TinyLlama-1.1B -----
    llama_served = serve_phase(
        torch, np, f"TinyLlama-1.1B ({LLAMA_SERVE_LAYERS} of 22 layers)",
        hf_llama_config(dict(TINYLLAMA_1_1B,
                             num_hidden_layers=LLAMA_SERVE_LAYERS)))

    elapsed("phase 8")

    # -- 9. training block-sparse GPT-2 125M at seq 8192 -------------------
    def sparse_model(attn_impl):
        return gpt2_config("125m", max_seq_len=SPARSE_SEQ, remat="full",
                           attn_impl="blocksparse", loss_chunk=256,
                           sparsity_config=sparse_config())
    lay = sparse_config().make_layout(SPARSE_SEQ)
    keys = visible_pairs((lay & np.tril(np.ones_like(lay)))[None], 64,
                         True) / SPARSE_SEQ
    sparse_steps = {"blocksparse_flash_fwd": 24,
                    "blocksparse_flash_bwd_dq": 12,
                    "blocksparse_flash_bwd_dkv": 12,
                    **{name: 0 for name in build.KERNELS
                       if name.startswith("flash_attention")}}
    sparse = train_phase(torch, np, "block-sparse GPT-2 125M", sparse_model,
                         gpt2_optimizer(), SPARSE_MICRO, SPARSE_SEQ,
                         SPARSE_STEPS, sparse_steps, check_micro=1,
                         plain_model=masked_plain_model,
                         keys_per_query=keys,
                         profile_shares={
                             "B8": (tck["blocksparse_flash_fwd"],),
                             "B9 + B10": (tck["blocksparse_flash_bwd_dq"],
                                          tck["blocksparse_flash_bwd_dkv"])})
    print(f"  MFU's attention term: {keys:.1f} visible keys per query "
          f"(the layout's {int((lay & np.tril(np.ones_like(lay))).sum())} "
          f"causal blocks of 64 at seq {SPARSE_SEQ})")
    step_time_phase(torch, np, "GPT-2 125M dense flash at the same seq",
                    gpt2_config("125m", max_seq_len=SPARSE_SEQ, remat="full",
                                attn_impl="flash", loss_chunk=256),
                    gpt2_optimizer(), SPARSE_MICRO, SPARSE_SEQ, 3,
                    {"flash_attention_fwd": 24, "flash_attention_bwd_dq": 12,
                     "flash_attention_bwd_dkv": 12,
                     "blocksparse_flash_fwd": 0})

    elapsed("phase 9")

    # -- 10. forward() and generate() of the block-sparse model ----------
    sparse_served = sparse_serve_phase(torch, np, sparse_model("blocksparse"))

    elapsed("phase 10")

    # -- 11. quantized KV serving at GPT-3 6.7B width --------------------
    quant_served = quant_serve_phase(
        torch, np, f"GPT-3 6.7B ({QUANT_SERVE_LAYERS} of 32 layers)",
        gpt2_config("6.7b", num_layers=QUANT_SERVE_LAYERS))

    elapsed("phase 11")

    # -- 12. int8 weight-only serving at GPT-3 6.7B width ----------------
    int8_served = int8_serve_phase(torch, np, "GPT-3 6.7B",
                                   gpt2_config("6.7b"),
                                   served["prefill_logits"])

    elapsed("phase 12")

    # -- 13. generate(), forward() and the server at GPT-3 2.7B width --
    served27 = serve_phase(torch, np,
                           f"GPT-3 2.7B ({PHASE13_LAYERS} of 32 layers)",
                           gpt2_config("2.7b", num_layers=PHASE13_LAYERS))

    elapsed("phase 13")

    # -- 14. fp16 training of GPT-3 760M ------------------------------------
    fp16 = fp16_train_phase(
        torch, np, "GPT-3 760M",
        gpt2_config("760m", max_seq_len=FP16_LONG_SEQ, remat="full",
                    attn_impl="flash", loss_chunk=256), gpt2_optimizer())
    elapsed("phase 14")

    # -- 15. fp16 serving at GPT-3 6.7B width --------------------------------
    fp16_served = fp16_serve_phase(
        torch, np, f"GPT-3 6.7B ({FP16_SERVE_LAYERS} of 32 layers)",
        gpt2_config("6.7b", num_layers=FP16_SERVE_LAYERS))
    elapsed("phase 15")

    # -- 16. fp16 block-sparse training of GPT-2 125M ------------------------
    fp16_sparse = fp16_sparse_train_phase(torch, np, sparse_model, keys)
    elapsed("phase 16")

    # -- 17. save, load and resume; serve the checkpoint ---------------------
    resume_phase(torch, np)
    elapsed("phase 17")

    # -- 18. the remat policies ----------------------------------------------
    remat_table_phase(torch, np)
    elapsed("phase 18")

    # -- 19. GPT-NeoX-20B served at full width and depth ----------------------
    free_card(torch, "GPT-NeoX-20B serving")
    neox20 = hf_neox_config(GPT_NEOX_20B)
    check((neox20.num_layers, neox20.d_model, neox20.num_heads, neox20.hdim,
           neox20.rotary_dim, neox20.parallel_residual,
           neox20.tie_embeddings, neox20.vocab_size)
          == (44, 6144, 64, 96, 24, True, False, 50432),
          f"GPT-NeoX-20B config {neox20}")
    neox_served = serve_phase(
        torch, np, f"GPT-NeoX-20B ({NEOX20_SERVE_LAYERS} of 44 layers)",
        hf_neox_config(dict(GPT_NEOX_20B,
                            num_hidden_layers=NEOX20_SERVE_LAYERS)))
    elapsed("phase 19")

    # -- 20. training GPT-NeoX 1.3B ---------------------------------------------
    def neox_model(attn_impl):
        return neox_config("1.3b", max_seq_len=NEOX_SEQ, remat="full",
                           attn_impl=attn_impl, loss_chunk=256)
    n_layers = neox_model("flash").num_layers
    free_card(torch, "GPT-NeoX 1.3B training")
    neox_train = train_phase(
        torch, np, "GPT-NeoX 1.3B", neox_model, gpt2_optimizer(),
        NEOX_MICRO, NEOX_SEQ, NEOX_STEPS,
        {"flash_attention_fwd": 2 * n_layers,
         "flash_attention_bwd": n_layers, "flash_attention_bwd_dq": 0,
         "flash_attention_bwd_dkv": 0}, check_micro=NEOX_CHECK_MICRO,
        profile_shares={"B1": (tck["flash_attention_fwd"],),
                        "B2": (tck["flash_attention_bwd"],)})
    elapsed("phase 20")

    # -- 21-23. MoE serving and training, Stable Diffusion ---------------------
    moe = new_phases(torch, np, elapsed)

    # -- 28-30. ZeRO-Offload, ZeRO-Infinity, host_offload remat --------------
    off = offload_phases(torch, np, elapsed)

    # -- 31. data parallelism and ZeRO stages 0-3 ----------------------------
    free_card(torch, "ZeRO over data parallelism")
    zero = zero_phase(torch, np)
    elapsed("phase 31")

    # -- 32. tensor parallelism: serving at GPT-3 6.7B width, training
    # GPT-2 125M (its (b) ran in phase 31's world) --------------------------
    free_card(torch, "tensor parallelism")
    tp = tp_phase(torch, np, zero)
    elapsed("phase 32")

    # -- 33. pipeline parallelism (it ran in phase 31's world) --------------
    pp = pipe_report(zero, nvidia_smi_line(0))
    elapsed("phase 33")

    # -- result lines ------------------------------------------------------
    flash = "deepspeed_tpu/ops/transformer/flash_attention.py"
    paged = "deepspeed_tpu/ops/transformer/paged_decode_attention.py"
    sparse_file = "deepspeed_tpu/ops/sparse_attention/blocksparse_flash.py"
    # (TPU kernel replaced, launches over its main path's run, index of
    # the main-path case in the phase-3 results): B5-B7 from GPT-3 6.7B
    # serving, B1/B3/B4 from TinyLlama training (B1 at its GQA shape), B2
    # from GPT-2 training, B8-B10 from block-sparse GPT-2 training; the
    # int8/int4 B6/B7 from phase 11's drain at that width (B6 at the 6.7B
    # heads, B7 at base 256)
    rows = {
        "decode_attention": (
            "deepspeed_tpu/ops/transformer/decode_attention.py:56",
            served["decode_attention"], 0),
        "paged_decode_attention": (
            f"{paged}:143", served["paged_decode_attention"], 0),
        "paged_prefill_attention": (
            f"{paged}:358", served["paged_prefill_attention"], 1),
        "flash_attention_fwd": (f"{flash}:94", llama["flash_attention_fwd"],
                                3),
        "flash_attention_bwd": (f"{flash}:300", gpt2["flash_attention_bwd"],
                                0),
        "flash_attention_bwd_dq": (
            f"{flash}:196", llama["flash_attention_bwd_dq"], 0),
        "flash_attention_bwd_dkv": (
            f"{flash}:241", llama["flash_attention_bwd_dkv"], 0),
        "blocksparse_flash_fwd": (
            f"{sparse_file}:75", sparse["blocksparse_flash_fwd"], 0),
        "blocksparse_flash_bwd_dq": (
            f"{sparse_file}:165", sparse["blocksparse_flash_bwd_dq"], 0),
        "blocksparse_flash_bwd_dkv": (
            f"{sparse_file}:204", sparse["blocksparse_flash_bwd_dkv"], 0),
    }
    for bits in build.QUANT_BITS:
        for kernel, line, main in (("paged_decode_attention", 143, 0),
                                   ("paged_prefill_attention", 358, 1)):
            name = build.counter(kernel, bits)
            rows[name] = (f"{paged}:{line} (kv_bits {bits})",
                          quant_served[bits][name], main)
    # the float16 B1-B4 from GPT-3 760M fp16 training: B1 and B2 over its
    # 10 steps at seq 1024 (phase 3's 760M case), B3 and B4 over its 2
    # steps at seq 2048 (phase 3's 760M seq 2048 case)
    for kernel, line, launches, main in (
            ("flash_attention_fwd", 94, fp16["steps"], 0),
            ("flash_attention_bwd", 300, fp16["steps"], 0),
            ("flash_attention_bwd_dq", 196, fp16["long"], 1),
            ("flash_attention_bwd_dkv", 241, fp16["long"], 1)):
        name = build.counter(kernel, dtype=torch.float16)
        rows[name] = (f"{flash}:{line} (float16)", launches[name], main)
    # the float16 B5-B7 from phase 15's GPT-3 6.7B fp16 serving (B5 over
    # generate(), B6/B7 over each kv_bits' drain; phase 3's 6.7B fp16
    # case) and B8-B10 from phase 16's fp16 block-sparse training
    for kernel, line in (("decode_attention", 56),
                         ("paged_decode_attention", 143),
                         ("paged_prefill_attention", 358)):
        for bits in ((0,) if kernel == "decode_attention"
                     else (0,) + build.QUANT_BITS):
            name = build.counter(kernel, bits, torch.float16)
            src = ("deepspeed_tpu/ops/transformer/decode_attention.py"
                   if kernel == "decode_attention" else paged)
            rows[name] = (f"{src}:{line} (float16"
                          + (f", kv_bits {bits})" if bits else ")"),
                          fp16_served[name], 0)
    for kernel, line in (("blocksparse_flash_fwd", 75),
                         ("blocksparse_flash_bwd_dq", 165),
                         ("blocksparse_flash_bwd_dkv", 204)):
        name = build.counter(kernel, dtype=torch.float16)
        rows[name] = (f"{sparse_file}:{line} (float16)", fp16_sparse[name],
                      0)
    print(f"TinyLlama serving launches: B5 "
          f"{llama_served['decode_attention']}, B6 "
          f"{llama_served['paged_decode_attention']}, B7 "
          f"{llama_served['paged_prefill_attention']}, B1 (forward) "
          f"{llama_served['flash_attention_fwd']}; block-sparse forward() "
          f"B8 {sparse_served['blocksparse_flash_fwd']}; int8 weights + "
          f"int8 KV drain: B6 int8 "
          f"{int8_served['paged_decode_attention_int8']}, B7 int8 "
          f"{int8_served['paged_prefill_attention_int8']}; GPT-3 2.7B "
          f"(D 80): B5 {served27['decode_attention']}, B1 (forward) "
          f"{served27['flash_attention_fwd']}, B6 "
          f"{served27['paged_decode_attention']}, B7 "
          f"{served27['paged_prefill_attention']}; GPT-NeoX-20B (64 heads "
          f"of 96): B5 {neox_served['decode_attention']}, B1 (forward) "
          f"{neox_served['flash_attention_fwd']}, B6 "
          f"{neox_served['paged_decode_attention']}, B7 "
          f"{neox_served['paged_prefill_attention']}; GPT-NeoX 1.3B "
          f"training: B1 {neox_train['flash_attention_fwd']}, B2 "
          f"{neox_train['flash_attention_bwd']}; 350M+MoE-128: B5 "
          f"{moe['served']['decode_attention']}, B1 (forward) "
          f"{moe['served']['flash_attention_fwd']}; 125M+MoE-64 training: "
          f"B1 {moe['trained']['flash_attention_fwd']}, B3 "
          f"{moe['trained']['flash_attention_bwd_dq']}, B4 "
          f"{moe['trained']['flash_attention_bwd_dkv']}; GPT-3 6.7B offload "
          f"({OFFLOAD_67_STEPS} steps): B1 "
          f"{off['offload']['flash_attention_fwd']}, B2 "
          f"{off['offload']['flash_attention_bwd']}; GPT-NeoX-20B width "
          f"Infinity (2 layers, 3 steps): B1 "
          f"{off['infinity']['flash_attention_fwd']}, B3 "
          f"{off['infinity']['flash_attention_bwd_dq']}, B4 "
          f"{off['infinity']['flash_attention_bwd_dkv']}; GPT-NeoX 1.3B "
          f"host_offload (3 steps): B1 "
          f"{off['host_offload']['flash_attention_fwd']}, B2 "
          f"{off['host_offload']['flash_attention_bwd']}; ZeRO world 1 "
          f"on NCCL, stage 3 ({ZERO_STEPS} steps): B1 "
          f"{zero['world1']['flash_attention_fwd']}, B2 "
          f"{zero['world1']['flash_attention_bwd']}; ZeRO world 4 over "
          f"gloo, stages 0-3 ({ZERO_STEPS} steps each), every rank: B1 "
          f"{zero['world4']['flash_attention_fwd']}, B2 "
          f"{zero['world4']['flash_attention_bwd']}; tensor parallelism "
          f"over 4 gloo ranks, every rank: serving {{data 1, model 4}} B6 "
          f"{tp['1x4']['paged_decode_attention']}, B7 "
          f"{tp['1x4']['paged_prefill_attention']}, {{data 2, model 2}} B6 "
          f"{tp['2x2']['paged_decode_attention']}, B7 "
          f"{tp['2x2']['paged_prefill_attention']}, generate() at tp_size "
          f"4 B5 {tp['generate']['decode_attention']}; training ("
          f"{TP_TRAIN_STEPS} steps a mesh) {{data 1, model 4}} B1 "
          f"{tp['train']['1x4']['flash_attention_fwd']}, B2 "
          f"{tp['train']['1x4']['flash_attention_bwd']}, {{data 2, model "
          f"2}} B1 {tp['train']['2x2']['flash_attention_fwd']}, B2 "
          f"{tp['train']['2x2']['flash_attention_bwd']}; the pipeline ("
          f"{TP_TRAIN_STEPS} steps a mesh), every rank: " + ", ".join(
              f"{k} B1 {v['flash_attention_fwd']}, B2 "
              f"{v['flash_attention_bwd']}" for k, v in pp.items()))
    kernels = []
    for name in build.COUNTERS:
        replaces, launches, main = rows[name]
        check(launches > 0, f"{name}: no launch on its main path")
        c = kres[name][main]
        source = name.rsplit("_int", 1)[0].removesuffix("_f16")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in kres[name]),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line(0))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def free_card(torch, label) -> None:
    """Collect what earlier phases left (an engine and its server refer
    to each other, so only the cycle collector frees them) and fail unless
    the card holds under 8 GiB: the next phase needs the rest (GPT-NeoX-20B
    serving 51 GB, GPT-NeoX 1.3B training 54 GiB)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    # and the pinned host buffers torch keeps cached (the offload phases'
    # rings), so the next phase finds the host's memory too
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    left = torch.cuda.memory_allocated()
    print(f"{label}: {left / 2**20:.1f} MiB held on the card by earlier "
          f"phases; host MemAvailable {mem_available() / 1e9:.1f} GB")
    check(left < 8 * 2**30, f"{label}: earlier phases still hold {left} "
                            f"bytes")


def warm_up_at_kv_head_width(eng, prompts, label, kv_heads) -> None:
    """``generate()`` 4 new tokens as the untimed warm-up, with a spy on
    the model's B5 call that fails unless every call sees the layer's
    cache at the model's ``kv_heads``, never a copy expanded over the
    group.  The spy is gone before the timed run."""
    from deepspeed_tpu_torch.models import transformer as model_mod
    real_b5 = model_mod.decode_attention
    seen = set()

    def b5_spy(q, k, v, length, sm_scale=None):
        seen.add(int(k.shape[2]))
        return real_b5(q, k, v, length, sm_scale)
    model_mod.decode_attention = b5_spy
    try:
        eng.generate(prompts, max_new_tokens=4)
    finally:
        model_mod.decode_attention = real_b5
    check(seen == {kv_heads}, f"{label}: B5 saw caches of {sorted(seen)} "
          f"kv heads, not the model's {kv_heads}")


def serve_phase(torch, np, label, cfg, then=None) -> dict:
    """``init_inference`` on ``cfg`` in bf16 with random weights from
    seed 0, then ``generate()`` (8 x 128 prompts, 64 new tokens, greedy:
    every decode step on B5), ``forward()`` on B1 against ``generate()``'s
    prefill, and the server (16 requests, prompts 16-512, 32 new each: B6
    and B7), every greedy server stream equal to ``generate()``'s up to
    its first near tie (``divergence_gaps`` within twice
    ``LOGITS_REL_TOL``, as ``fp16_serve_phase`` holds float16); prints
    the peak device memory.  Returns the launch counts of the main paths:
    B5 over the 64-token ``generate()``, B1 over ``forward()``, B6/B7
    over the drain.  ``then(eng)``, when given, runs on the engine at the
    end (phases 24-25), with the phase's server freed."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer import TransformerLM
    from deepspeed_tpu_torch.ops import build
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = init_inference(TransformerLM(cfg), {
        "dtype": "bfloat16", "temperature": 0.0, "serving": SERVING})
    torch.cuda.synchronize()
    print(f"{label} init: {cfg.num_params() / 1e9:.2f} B params "
          f"({sum(t.numel() * t.element_size() for t in _leaves(eng.params)) / 1e9:.2f} GB bf16) "
          f"in {time.perf_counter() - t0:.1f} s")
    rng, prompts, lens, sprompts = serving_prompts(np, cfg.vocab_size)
    warm_up_at_kv_head_width(eng, prompts, label, cfg.kv_heads)
    build.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    gen_counts = dict(build.launch_counts)
    check(tuple(out.shape) == (8, 64), f"generate shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generate tokens out of vocab range")
    want = cfg.num_layers * 63
    check(gen_counts["decode_attention"] == want,
          f"B5 launches {gen_counts['decode_attention']} != {want}")
    stats = eng.latency_stats()
    print(f"{label} generate: 8 x 128-token prompts, 64 new tokens: TTFT "
          f"{stats['ttft_p50_ms']:.1f} ms, decode "
          f"{stats['p50_ms']:.2f} ms/token ({8 * stats['tokens_per_sec']:.0f}"
          f" tokens/s over the batch); B5 launches "
          f"{gen_counts['decode_attention']}, each over the cache at "
          f"{cfg.kv_heads} kv heads ({cfg.num_heads} query heads)")

    device_profile(torch, lambda: eng.generate(prompts, max_new_tokens=16),
                   f"{label} generate 8 x 128 prompts, 16 new tokens",
                   shares={"B5": ("decode_cluster", "decode_attention")})

    # forward() through kernel B1, against generate()'s prefill logits
    prefill = eng._prefill
    gen_last = {}

    def recording_prefill(ids, true_len, cache_len):
        cache, last = prefill(ids, true_len, cache_len)
        gen_last["logits"] = last.float()
        return cache, last
    eng._prefill = recording_prefill
    eng.generate(prompts, max_new_tokens=1)
    eng._prefill = prefill
    build.reset_launch_counts()
    t0 = time.perf_counter()
    fwd = eng.forward(prompts)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_counts = dict(build.launch_counts)
    check(tuple(fwd.shape) == (8, 128, cfg.vocab_size)
          and bool(fwd.isfinite().all()), f"forward logits {fwd.shape}")
    check(fwd_counts["flash_attention_fwd"] == cfg.num_layers,
          f"forward: B1 launches {fwd_counts['flash_attention_fwd']} != "
          f"{cfg.num_layers}")
    ref = gen_last["logits"]
    fwd_err = float((fwd[:, -1] - ref).abs().max())
    fwd_rel = fwd_err / float(ref.abs().max())
    same = int((fwd[:, -1].argmax(-1) == ref.argmax(-1)).sum())
    print(f"{label} forward: 8 x 128 prompts in {fwd_s * 1e3:.1f} ms, B1 "
          f"launches {fwd_counts['flash_attention_fwd']}; last-position "
          f"logits max|forward - generate prefill| {fwd_err:.4f} = "
          f"{fwd_rel:.4f} of max|logit| (limit {LOGITS_REL_TOL}), argmax "
          f"equal on {same} of 8")
    check(fwd_rel <= LOGITS_REL_TOL,
          f"forward/generate logits differ by {fwd_rel:.4f} of their scale")
    prefill_logits = ref.cpu()
    del fwd, ref

    srv = eng.serving_engine()
    first_logits = {}
    reqs, srv_counts, wall = drain(
        torch, srv, sprompts, f"{label} serving", 0,
        lambda mixed: first_step_recorder(srv, mixed, first_logits))
    ntok = sum(len(r.output) for r in reqs)
    print(f"{label} serving: 16 requests, prompts {int(lens.min())}-"
          f"{int(lens.max())} tokens ({int(lens.sum())} total), 32 new "
          f"each: {ntok} tokens in {wall:.2f} s = {ntok / wall:.1f} "
          f"tokens/s ({srv.counts['dispatches']} dispatches, "
          f"{srv.counts['preemptions']} preemptions); B6 launches "
          f"{srv_counts['paged_decode_attention']}, B7 launches "
          f"{srv_counts['paged_prefill_attention']}")

    # serving vs generate(): first-step logits on 4 requests, token share
    # on all 16 (greedy bf16 streams may part after a near tie)
    gen_first = {}
    prefill = eng._prefill

    def recording_prefill(ids, true_len, cache_len):
        cache, last = prefill(ids, true_len, cache_len)
        gen_first["last"] = last[0].float().cpu()
        return cache, last
    eng._prefill = recording_prefill
    same = 0
    same_streams = 0
    worst = 0.0
    refs = []
    for i, r in enumerate(reqs):
        ref = eng.generate(np.asarray(r.prompt)[None], max_new_tokens=32)
        ref = ref[0].tolist()
        refs.append(ref)
        same += int(sum(a == b for a, b in zip(r.output, ref)))
        same_streams += int(r.output == ref)
        if i < 4:
            a, b = first_logits[r.req_id], gen_first["last"]
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            worst = max(worst, err / scale)
            print(f"  {r.req_id} (prompt {len(r.prompt)}): first-step "
                  f"logits max|serving - generate| {err:.4f} of max|logit| "
                  f"{scale:.3f}; argmax {int(a.argmax())} vs "
                  f"{int(b.argmax())}")
    eng._prefill = prefill
    check(worst <= LOGITS_REL_TOL,
          f"serving/generate first-step logits differ by {worst:.4f} of "
          f"their scale (> {LOGITS_REL_TOL})")
    print(f"{label} serving streams equal to generate(): {same_streams} of "
          f"16 streams, {same} of {ntok} tokens "
          f"({100.0 * same / ntok:.1f} %)")
    for req_id, pos, gap in divergence_gaps(np, eng, reqs, refs):
        print(f"  {req_id} parts from generate() at token {pos}: "
              f"generate()'s logit gap there {gap!r} of max|logit| (limit "
              f"{2 * LOGITS_REL_TOL})")
        check(gap <= 2 * LOGITS_REL_TOL,
              f"{label} serving: {req_id} parts from generate() at token "
              f"{pos} where generate()'s gap is {gap:.4f} of max|logit|, "
              f"not a near tie")

    # fresh prompts of the first 8 lengths for each of device_profile's
    # two runs (the served prompts sit in the prefix cache now)
    bursts = iter([[rng.integers(0, cfg.vocab_size, n).tolist()
                    for n in lens[:8]] for _ in range(2)])

    def serve_burst():
        for p in next(bursts):
            srv.submit(p, max_new_tokens=8)
        srv.run()
    device_profile(torch, serve_burst,
                   f"{label} serving 8 requests, 8 new tokens",
                   shares=PAGED_SHARES)
    drain_profile(torch, srv, lens, cfg.vocab_size, rng, label)
    print(f"{label}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated) of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    del srv
    eng._serving = None
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    after = then(eng) if then is not None else None
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"then": after, "decode_attention": gen_counts["decode_attention"],
            "flash_attention_fwd": fwd_counts["flash_attention_fwd"],
            "paged_decode_attention": srv_counts["paged_decode_attention"],
            "paged_prefill_attention": srv_counts["paged_prefill_attention"],
            "prefill_logits": prefill_logits}


#: B6's and B7's kernels in a profile, by name (every dtype and kv_bits)
PAGED_SHARES = {"B6": ("paged_decode",), "B7": ("paged_prefill",)}


def drain_profile(torch, srv, lens, vocab, rng, label) -> None:
    """``device_profile`` of phase 5's drain again on ``srv``: 16
    requests of the drain's prompt lengths ``lens`` (fresh tokens from
    ``rng``: the served prompts sit in the prefix cache), 32 new each,
    with B6's and B7's shares of the drain's device time."""
    runs = iter([[rng.integers(0, vocab, n).tolist() for n in lens]
                 for _ in range(2)])

    def run():
        for prompt in next(runs):
            srv.submit(prompt, max_new_tokens=32)
        srv.run()
    device_profile(torch, run, f"{label} drain again: {len(lens)} "
                               f"requests, 32 new tokens each",
                   shares=PAGED_SHARES)


#: phase 5's server: 512 blocks of 16 tokens, 8 slots, chunk 256
SERVING = {"enabled": True, "kv_block_size": 16, "num_kv_blocks": 512,
           "max_batch_slots": 8, "prefill_chunk_tokens": 256}


def serving_prompts(np, vocab):
    """Phase 4's 8 x 128 prompts and phase 5's 16 requests (prompts of
    16-512 tokens) from seed 0: (the generator, prompts, request lengths,
    request prompts)."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab, (8, 128))
    lens = rng.integers(16, 513, 16)
    return (rng, prompts, lens,
            [rng.integers(0, vocab, n).tolist() for n in lens])


def first_step_recorder(srv, mixed, first_logits):
    """``mixed`` (a model's mixed step) that also keeps, by request id,
    the logits of each chunk that completes a prompt: the request's
    first-step logits."""
    def recording(params, cache, dec_tokens, dec_active, chunk_ids,
                  chunk_slot, chunk_start, chunk_len):
        res = mixed(params, cache, dec_tokens, dec_active, chunk_ids,
                    chunk_slot, chunk_start, chunk_len)
        if chunk_len:
            req = srv.scheduler.running[chunk_slot]
            if chunk_start + chunk_len == len(req.prompt):
                first_logits[req.req_id] = res[1].float().cpu()
        return res
    return recording


def drain(torch, srv, prompts, label, kv_bits, record=None, dtype=None):
    """Submit ``prompts`` (32 new tokens each) to ``srv`` and ``run()``:
    every request OK with 32 tokens, the allocator empty afterwards, the
    B6/B7 variants of ``kv_bits`` and ``dtype`` (default bf16) launched
    exactly once a layer for each mixed step with a decode lane (B6) and
    with a prompt chunk (B7), and no other.  ``record(...)`` wraps the
    model's mixed step during the drain when given.  Returns (requests,
    launch counts, seconds)."""
    from deepspeed_tpu_torch.ops import build
    model = srv.model
    mixed = model._apply_paged_mixed
    lanes = {"decode": 0, "chunk": 0}

    def counted(params, cache, dec_tokens, dec_active, chunk_ids, *rest):
        lanes["decode"] += int(dec_tokens.shape[0] > 0)
        lanes["chunk"] += int(chunk_ids.shape[0] > 0)
        return inner(params, cache, dec_tokens, dec_active, chunk_ids,
                     *rest)
    inner = mixed if record is None else record(mixed)
    model._apply_paged_mixed = counted
    build.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
    finished = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    model._apply_paged_mixed = mixed
    done = sum(any(r is q for q in finished) for r in reqs)
    check(done == len(prompts),
          f"{label}: {done} of {len(prompts)} requests finished")
    for r in reqs:
        check(r.status is not None and r.status.value == "ok"
              and len(r.output) == 32,
              f"{label} {r.req_id}: status {r.status}, {len(r.output)} "
              f"tokens")
    check(srv.allocator.num_used == 0,
          f"{label}: allocator holds {srv.allocator.num_used} blocks after "
          f"drain")
    dtype = dtype or torch.bfloat16
    layers = model.config.num_layers
    steps = {"paged_decode_attention": lanes["decode"],
             "paged_prefill_attention": lanes["chunk"]}
    for kernel in build.QUANT_KERNELS:
        for bits in (0,) + build.QUANT_BITS:
            for dt in (torch.bfloat16, torch.float16):
                name = build.counter(kernel, bits, dt)
                n = counts[name]
                want = (layers * steps[kernel]
                        if (bits, dt) == (kv_bits, dtype) else 0)
                check(n == want and (want > 0 or (bits, dt) != (kv_bits,
                                                                dtype)),
                      f"{label}: {name} launched {n} times at kv_bits "
                      f"{kv_bits}, {dtype} (want {want})")
    return reqs, counts, wall


def quant_serve_phase(torch, np, label, cfg) -> dict:
    """Phase 11: the phase-5 server and requests over quantized KV pools
    (``serving.kv_cache_bits`` 8, then 4), bf16 weights from seed 0 shared
    with a bf16 engine whose ``generate()`` (dense bf16 cache) is the
    reference.  Pool bytes exact; ``blocks_for_budget`` at the bf16 pool's
    budget; the drain's tokens/s and launches (the int8 or int4 B6/B7,
    never the bf16 ones); token agreement with ``generate()``; first-step
    logits of 4 requests against ``generate()``'s prefill (limited at 8
    bits, printed at 4); and the dispatch that carries a chunk and the
    most decode slots, recorded with its pools and rerun from the same state
    with the kernels' plain versions patched into the model: logits within
    LOGITS_REL_TOL, the same rows written, layer 0's values and scales
    bit-equal (deeper layers' k/v come through attention, where kernel
    and plain round differently: their agreement is printed).  Returns
    the drains' launch counts by width."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving.block_allocator import (
        blocks_for_budget, kv_block_bytes)
    from deepspeed_tpu_torch.models import transformer as tt
    from deepspeed_tpu_torch.ops.quantizer import kv_dequantize
    from deepspeed_tpu_torch.ops.transformer import (
        paged_decode_attention as PA)
    base = {"dtype": "bfloat16", "temperature": 0.0}
    ref = init_inference(tt.TransformerLM(cfg), {**base, "serving": SERVING})
    _, _, lens, prompts = serving_prompts(np, cfg.vocab_size)
    L, hkv, hd = cfg.num_layers, cfg.kv_heads, cfg.hdim
    bf16_bytes = 512 * L * kv_block_bytes(16, hkv, hd, 0)
    # the reference: generate() streams and prefill logits on the dense
    # bf16 cache
    prefill = ref._prefill
    gen_first = []

    def recording_prefill(ids, true_len, cache_len):
        cache, last = prefill(ids, true_len, cache_len)
        gen_first.append(last[0].float().cpu())
        return cache, last
    ref._prefill = recording_prefill
    ref_streams = [ref.generate(np.asarray(p)[None], max_new_tokens=32)[0]
                   .tolist() for p in prompts]
    ref._prefill = prefill
    counts = {}
    for bits in (8, 4):
        tag = f"{label} kv_cache_bits {bits}"
        eng = init_inference(tt.TransformerLM(cfg), {
            **base, "serving": {**SERVING, "kv_cache_bits": bits}},
            params=ref.params)
        srv = eng.serving_engine()
        want_mib = {8: 2112, 4: 1088}[bits] * L // 32   # 66 / 34 a layer
        check(srv.kv_pool_bytes == want_mib * 2**20
              == 512 * L * kv_block_bytes(16, hkv, hd, bits),
              f"{tag}: pool {srv.kv_pool_bytes} bytes, not {want_mib} MiB")
        nblocks = blocks_for_budget(bf16_bytes // L, 16, hkv, hd, bits)
        first_logits, rec = {}, {}

        def record(mixed):
            def recording(params, cache, dec_tokens, dec_active, chunk_ids,
                          chunk_slot, chunk_start, chunk_len):
                args = (dec_tokens, dec_active, chunk_ids, chunk_slot,
                        chunk_start, chunk_len)
                pools = ("k", "v", "k_scale", "v_scale")
                # keep the dispatch with a chunk and the most decode slots
                ndec = int(dec_active.sum()) if dec_tokens.shape[0] else 0
                grab = bool(chunk_len) and ndec > rec.get("ndec", 0)
                if grab:
                    rec["before"] = {k: cache[k].clone() for k in pools}
                    rec["args"] = (params, cache["block_tables"].clone(),
                                   cache["lens"].clone(),
                                   *(a.clone() if torch.is_tensor(a) else a
                                     for a in args))
                res = mixed(params, cache, *args)
                if grab:
                    rec["logits"] = (res[0].float(), res[1].float())
                    rec["after"] = {k: cache[k].clone() for k in pools}
                    rec["ndec"] = ndec
                return res
            return first_step_recorder(srv, recording, first_logits)
        reqs, c, wall = drain(torch, srv, prompts, tag, bits, record)
        counts[bits] = c
        ntok = sum(len(r.output) for r in reqs)
        same = sum(int(a == b) for r, want in zip(reqs, ref_streams)
                   for a, b in zip(r.output, want))
        same_streams = sum(int(r.output == w)
                           for r, w in zip(reqs, ref_streams))
        worst = 0.0
        for i, r in enumerate(reqs[:4]):
            a, b = first_logits[r.req_id], gen_first[i]
            worst = max(worst, float((a - b).abs().max())
                        / float(b.abs().max()))
        print(f"{tag}: pool {srv.kv_pool_bytes / 2**20:.1f} MiB (bf16 "
              f"{bf16_bytes / 2**20:.1f} MiB); blocks_for_budget at the "
              f"bf16 pool's budget: {nblocks} blocks of 16 (bf16: 512); 16 "
              f"requests, {ntok} tokens in {wall:.2f} s = "
              f"{ntok / wall:.1f} tokens/s ({srv.counts['dispatches']} "
              f"dispatches, {srv.counts['preemptions']} preemptions); B6 "
              f"int{bits} launches "
              f"{c[f'paged_decode_attention_int{bits}']}, B7 int{bits} "
              f"launches {c[f'paged_prefill_attention_int{bits}']}, bf16 "
              f"B6/B7 {c['paged_decode_attention']}/"
              f"{c['paged_prefill_attention']}")
        print(f"  against generate() on the bf16 dense cache: {same_streams}"
              f" of 16 streams, {same} of {ntok} tokens "
              f"({100.0 * same / ntok:.1f} %) equal; first-step logits of 4 "
              f"requests within {worst:.4f} of max|logit|"
              + (f" (limit {LOGITS_REL_TOL})" if bits == 8
                 else " (not limited at 4 bits)"))
        if bits == 8:
            check(worst <= LOGITS_REL_TOL,
                  f"{tag}: first-step logits differ by {worst:.4f} of their "
                  f"scale")
        # the recorded mixed step again, from the same state, with the
        # kernels' plain versions
        check("args" in rec, f"{tag}: no dispatch carried a chunk and "
                             f"decode slots")
        params, tables, lens_t, *args = rec["args"]
        state = {k: v.clone() for k, v in rec["before"].items()}
        saved = (tt.paged_decode_attention, tt.paged_prefill_attention)
        tt.paged_decode_attention = PA.paged_decode_attention_plain
        tt.paged_prefill_attention = PA.paged_prefill_attention_plain
        try:
            res = srv.model._apply_paged_mixed(
                params, {**state, "block_tables": tables, "lens": lens_t},
                *args)
        finally:
            tt.paged_decode_attention, tt.paged_prefill_attention = saved
        torch.cuda.synchronize()
        act = args[1] > 0
        kd, kc = rec["logits"]
        pd, pc = res[0].float(), res[1].float()
        step_rel = max(float((kd[act] - pd[act]).abs().max())
                       / float(pd[act].abs().max()),
                       float((kc - pc).abs().max()) / float(pc.abs().max()))
        # a written row is one whose scales changed: [L, blocks, rows]
        before = rec["before"]["k_scale"]
        same_rows = torch.equal((rec["after"]["k_scale"] != before).any(-1),
                                (state["k_scale"] != before).any(-1))
        layer0 = all(torch.equal(rec["after"][k][0], state[k][0])
                     for k in state)
        one = torch.ones_like(state["k_scale"])
        # the integer values: kv_dequantize at unit scale
        diffs = {k: (kv_dequantize(rec["after"][k], one, bits)
                     - kv_dequantize(state[k], one, bits)).abs()
                 for k in ("k", "v")}
        eq_share = min(float((d == 0).float().mean()) for d in diffs.values())
        max_d = max(int(d.max()) for d in diffs.values())
        s_rel = max(float(((rec["after"][k] - state[k]).abs()
                           / state[k].abs().clamp_min(1e-30)).nan_to_num(
                               0.0).max()) for k in ("k_scale", "v_scale"))
        print(f"  one recorded mixed step ({int(act.sum())} decode slots + "
              f"a {args[5]}-token chunk) rerun with the plain versions: "
              f"logits within {step_rel:.4f} of max|logit| (limit "
              f"{LOGITS_REL_TOL}); same rows written: {same_rows}; layer 0 "
              f"values and scales bit-equal: {layer0}; all layers: "
              f"{100 * eq_share:.3f} % of pool values equal, largest "
              f"difference {max_d}, scales within {s_rel:.3g} relative")
        check(step_rel <= LOGITS_REL_TOL,
              f"{tag}: mixed step kernels vs plain logits differ by "
              f"{step_rel:.4f} of their scale")
        check(same_rows, f"{tag}: kernels and plain wrote different rows")
        check(layer0, f"{tag}: layer 0's written values or scales differ "
                      f"between kernels and plain")
        del rec, state, res
        drain_profile(torch, srv, lens, cfg.vocab_size,
                      np.random.default_rng(bits), tag)
        del srv, eng
        torch.cuda.empty_cache()
    del ref
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def int8_serve_phase(torch, np, label, cfg, bf16_prefill) -> dict:
    """Phase 12: ``quant.enabled`` (int8 weights, f32 group scales; the
    seed-0 weights of phases 4-5 quantized) with ``kv_cache_bits`` 8:
    parameter bytes against bf16; ``generate()`` on phase 4's 8 x 128
    prompts, 64 new (TTFT, decode ms/token; B5 on the dense bf16 cache,
    each layer dequantized as it runs); ``forward()``'s last-position
    logits against phase 4's bf16 prefill logits (``bf16_prefill``,
    within LOGITS_REL_TOL); the 16-request drain on the int8 B6/B7.
    Returns the drain's launch counts."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import transformer as tt
    from deepspeed_tpu_torch.ops import build
    eng = init_inference(tt.TransformerLM(cfg), {
        "dtype": "bfloat16", "temperature": 0.0, "quant": {"enabled": True},
        "serving": {**SERVING, "kv_cache_bits": 8}})
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for tree in (eng.params, eng._scales) for t in _leaves(tree))
    print(f"{label} int8 weights: parameters {nbytes / 1e9:.2f} GB (int8 "
          f"blocks + f32 group scales, bf16 embeddings) against "
          f"{cfg.num_params() * 2 / 1e9:.2f} GB bf16")
    _, prompts, lens, sprompts = serving_prompts(np, cfg.vocab_size)
    warm_up_at_kv_head_width(eng, prompts, label, cfg.kv_heads)
    build.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    gen_counts = dict(build.launch_counts)
    check(tuple(out.shape) == (8, 64)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{label} int8 generate tokens {tuple(out.shape)}")
    check(gen_counts["decode_attention"] == cfg.num_layers * 63,
          f"{label} int8 generate: B5 launches "
          f"{gen_counts['decode_attention']}")
    stats = eng.latency_stats()
    device_profile(torch, lambda: eng.generate(prompts, max_new_tokens=16),
                   f"{label} int8 weights generate 8 x 128 prompts, 16 new "
                   f"tokens")
    fwd = eng.forward(prompts)[:, -1]
    torch.cuda.synchronize()
    ref = bf16_prefill.to(fwd.device)
    err = float((fwd - ref).abs().max())
    rel = err / float(ref.abs().max())
    same = int((fwd.argmax(-1) == ref.argmax(-1)).sum())
    print(f"{label} int8 generate: 8 x 128-token prompts, 64 new tokens: "
          f"TTFT {stats['ttft_p50_ms']:.1f} ms, decode {stats['p50_ms']:.2f}"
          f" ms/token; B5 launches {gen_counts['decode_attention']}; "
          f"forward() last-position logits max|int8 - bf16 prefill| "
          f"{err:.4f} = {rel:.4f} of max|logit| (limit {LOGITS_REL_TOL}), "
          f"argmax equal on {same} of 8")
    check(rel <= LOGITS_REL_TOL,
          f"{label} int8 forward vs bf16 prefill logits differ by {rel:.4f} "
          f"of their scale")
    del fwd, ref
    srv = eng.serving_engine()
    reqs, c, wall = drain(torch, srv, sprompts, f"{label} int8", 8)
    ntok = sum(len(r.output) for r in reqs)
    print(f"{label} int8 weights + int8 KV serving: 16 requests, {ntok} "
          f"tokens in {wall:.2f} s = {ntok / wall:.1f} tokens/s "
          f"({srv.counts['dispatches']} dispatches); B6 int8 launches "
          f"{c['paged_decode_attention_int8']}, B7 int8 launches "
          f"{c['paged_prefill_attention_int8']}")
    del srv, eng
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return c


def gpt2_train_phase(torch, np) -> dict:
    """Phase 6: GPT-2 125M at ``bench.py``'s configuration, with 3 more
    steps under tracing and metrics."""
    from deepspeed_tpu_torch.models.transformer import gpt2_config

    def gpt2_model(attn_impl):
        return gpt2_config("125m", max_seq_len=TRAIN_SEQ, remat="full",
                           attn_impl=attn_impl, loss_chunk=256)
    tck = TENSOR_CORE_KERNELS
    # bench.py:171-180
    optimizer = {"type": "AdamW", "params": {"lr": 6e-4,
                                             "weight_decay": 0.1}}
    return train_phase(torch, np, "GPT-2 125M", gpt2_model, optimizer,
                       TRAIN_MICRO, TRAIN_SEQ, TRAIN_STEPS,
                       {"flash_attention_fwd": 24, "flash_attention_bwd": 12,
                        "flash_attention_bwd_dq": 0,
                        "flash_attention_bwd_dkv": 0}, check_micro=8,
                       profile_shares={"B1": (tck["flash_attention_fwd"],),
                                       "B2": (tck["flash_attention_bwd"],)},
                       observe=True)


def observed_steps(torch, eng, batch, off_ms, label) -> None:
    """3 more steps with tracing and metrics on: the trace holds the
    ``engine/*`` spans, ``dstpu_train_steps_total`` counts the steps;
    ms/step printed beside the unobserved warm steps'."""
    import tempfile
    from deepspeed_tpu_torch.observability import configure, get_registry
    tmp = tempfile.mkdtemp(prefix="dstpu_train_obs_")
    configure(_obs_config({
        "tracing": {"enabled": True, "output_dir": tmp},
        "metrics": {"enabled": True, "prometheus_dir": tmp}}))
    reg = get_registry()
    before = reg.counter("dstpu_train_steps_total").value
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.train_step(batch)
    torch.cuda.synchronize()
    on_ms = (time.perf_counter() - t0) / 3 * 1e3
    steps = reg.counter("dstpu_train_steps_total").value - before
    paths = eng.flush_observability()
    names = {e["name"] for e in json.load(open(paths[0]))["traceEvents"]}
    spans = ("engine/train_step", "engine/forward", "engine/backward",
             "engine/optimizer_step")
    for span in spans:
        check(span in names, f"{label}: no {span} span in the trace")
    check(steps == 3, f"{label}: dstpu_train_steps_total moved by {steps}, "
                      f"not 3")
    configure(None)
    reg.reset()
    print(f"  3 more steps with tracing and metrics on: {on_ms:.1f} ms/step"
          f" (off, the warm steps: {off_ms:.1f} ms/step); the trace holds "
          f"{', '.join(spans)} and engine/step_sync; "
          f"dstpu_train_steps_total {steps:.0f}")


def train_phase(torch, np, label, model_cfg, optimizer, micro, seq, steps,
                per_step, check_micro, plain_model=None,
                keys_per_query=None, profile_shares=None,
                observe=False) -> dict:
    """``initialize`` on ``model_cfg("flash")`` (bf16 over f32 masters,
    clipping 1.0, ZeRO 0, weights from seed 0) for ``steps`` steps on one
    seeded batch ``[micro, seq]``, re-fed: the loss must fall and each
    kernel must launch exactly ``per_step[name]`` times a step.  Then 3
    warm steps, the loss head alone, a profile, and the whole step with
    the kernels against plain attention (``plain_model`` of
    ``model_cfg("xla")``, default the model itself) at micro
    ``check_micro`` for 3 steps, each taken by both from the kernel
    trajectory's state.  MFU's attention term counts ``keys_per_query``
    keys (default ``seq``, as ``bench.py``); the profile prints the
    device-time share of each group of ``profile_shares``; with
    ``observe``, 3 more steps with tracing and metrics on
    (``observed_steps``).  Returns the launch counts over the ``steps``
    steps."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import TransformerLM
    from deepspeed_tpu_torch.ops import build

    def make(attn_impl, mb, loss_fn=None):
        cfg = model_cfg(attn_impl)
        config = {
            "train_micro_batch_size_per_gpu": mb,
            "gradient_accumulation_steps": 1,
            "optimizer": optimizer,
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 0},
            "gradient_clipping": 1.0,
            "steps_per_print": 0,
        }
        eng, _, _, _ = initialize(model=TransformerLM(cfg), config=config,
                                  loss_fn=loss_fn)
        return cfg, eng

    cfg, eng = make("flash", micro)
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size, (micro, seq),
                                     dtype=np.int32)}
    n_params = eng.num_parameters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [eng.train_step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{label} training: non-finite loss or grad norm {losses} "
          f"{gnorms}")
    check(losses[-1] < losses[0],
          f"{label} training: loss did not fall ({losses[0]} -> "
          f"{losses[-1]})")
    for name, n in per_step.items():
        check(counts[name] == n * steps,
              f"{label} training: {name} launches {counts[name]} != "
              f"{n * steps}")
    step_s = wall / steps
    tok_s = micro * seq / step_s
    # bench.py:212-215: 6 N per token plus the attention term
    flops_per_tok = 6 * n_params + 12 * cfg.num_layers * cfg.d_model * (
        keys_per_query or seq)
    mfu = tok_s * flops_per_tok / BF16_FLOPS
    print(f"training: {label} ({n_params / 1e6:.1f} M params), seq {seq}, "
          f"micro {micro}, remat full, {cfg.attn_impl}, fused head chunk "
          f"256, AdamW "
          f"bf16/f32: {steps} steps in {wall:.2f} s = "
          f"{step_s * 1e3:.1f} ms/step (the first step included), "
          f"{tok_s:.0f} tokens/s, MFU {100 * mfu:.2f} % of 989 TF/s; peak "
          f"memory {peak:.1f} GiB")
    print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f} (every step: "
          f"{' '.join(f'{x:.3f}' for x in losses)}); grad norm "
          f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f}")
    print(f"  launches over {steps} steps: " + ", ".join(
        f"{name} {counts[name]} ({counts[name] // steps} per step)"
        for name in per_step))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.train_step(batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    warm_tok_s = micro * seq / warm_ms * 1e3
    print(f"  3 more steps (warm): {warm_ms:.1f} ms/step = "
          f"{warm_tok_s:.0f} tokens/s, MFU "
          f"{100 * warm_tok_s * flops_per_tok / BF16_FLOPS:.2f} %")
    if observe:
        observed_steps(torch, eng, batch, warm_ms, label)
    head = loss_head_ms(torch, eng, batch, micro, seq)
    print(f"  loss head alone (fused, chunk 256, f32 logits from bf16 "
          f"operands, f32 backward products): forward {head['fwd']:.1f} "
          f"ms, forward + backward {head['both']:.1f} ms = "
          f"{100 * head['both'] / warm_ms:.1f} % of the warm step")
    device_profile(torch, lambda: [eng.train_step(batch) for _ in range(2)],
                   f"{label} training 2 steps", profile_shares)
    del eng, metrics
    torch.cuda.empty_cache()

    # the whole step with the kernels against plain attention: one engine
    # whose loss runs either model; a step leaves its input state
    # untouched (it builds a new one), so both take each step from it
    small = {"input_ids": batch["input_ids"][:check_micro]}
    models = {"flash": TransformerLM(model_cfg("flash")),
              "xla": (plain_model or TransformerLM)(model_cfg("xla"))}
    impl = {"now": "flash"}
    _, e = make("flash", check_micro,
                loss_fn=lambda p, b: models[impl["now"]].loss(p, b))
    for i in range(3):
        start = e.state
        impl["now"] = "xla"
        mx = e.train_step(small)
        lx, gx = float(mx["loss"]), float(mx["grad_norm"])
        e.state, impl["now"] = start, "flash"
        mf = e.train_step(small)
        lf, gf = float(mf["loss"]), float(mf["grad_norm"])
        del start, mx, mf
        loss_share = abs(lf - lx) / abs(lx) / STEP_LOSS_REL_TOL
        gnorm_share = abs(gf - gx) / abs(gx) / STEP_GNORM_REL_TOL
        print(f"  step {i} at micro {check_micro}, both from one state: "
              f"loss kernels {lf:.5f} plain {lx:.5f} ({loss_share:.3g} of "
              f"the limit); grad norm kernels {gf:.4f} plain {gx:.4f} "
              f"({gnorm_share:.3g} of the limit)")
        check(abs(lf - lx) <= STEP_LOSS_REL_TOL * abs(lx),
              f"{label} training step {i}: loss kernels {lf} vs plain {lx}")
        check(abs(gf - gx) <= STEP_GNORM_REL_TOL * abs(gx),
              f"{label} training step {i}: grad norm kernels {gf} vs plain "
              f"{gx}")
    del e
    torch.cuda.empty_cache()
    return {name: counts[name] for name in per_step}


#: the GPT-3 760M fp16 phase: seq 1024, micro 16, 10 steps; then 2 steps at
#: seq 2048 (GPT-3's context), where the sequence spans two 1024-row
#: blocks and the backward is B3 + B4
FP16_SEQ, FP16_MICRO, FP16_STEPS = 1024, 16, 10
FP16_LONG_SEQ = 2048
#: fp16 block of the phase: dynamic loss scaling from 2^16
FP16_CONFIG = {"enabled": True, "initial_scale_power": 16,
               "loss_scale_window": 1000, "hysteresis": 2,
               "min_loss_scale": 1}


def fp16_train_phase(torch, np, label, cfg, optimizer) -> dict:
    """``initialize`` on ``cfg`` (flash, remat full, fused head at chunk
    256) with ``fp16`` (``FP16_CONFIG``: the model runs in float16 over
    f32 masters, dynamic loss scaling), ``bench.py``'s AdamW and clipping
    1.0, weights from seed 0: ``FP16_STEPS`` steps on one seeded batch
    ``[FP16_MICRO, FP16_SEQ]``, each launching exactly 2 float16 B1 and 1
    float16 B2 per layer (remat full) and no bf16 flash kernel; the scale
    trajectory and the skipped steps printed; 3 warm steps, tokens/s and
    MFU; then an inf planted in one embedding entry, re-planted until the
    scale falls (the hysteresis): every such step must be skipped (step,
    params held, ``skipped`` counted) and the scale must fall by the
    factor once the hysteresis is spent; then 2 steps at seq
    ``FP16_LONG_SEQ`` (B1, B3 and B4 in float16).  Returns the float16
    launch counts of the 10 steps and of the long steps."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import TransformerLM
    from deepspeed_tpu_torch.ops import build
    config = {"train_micro_batch_size_per_gpu": FP16_MICRO,
              "gradient_accumulation_steps": 1, "optimizer": optimizer,
              "fp16": FP16_CONFIG, "zero_optimization": {"stage": 0},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    eng, _, _, _ = initialize(model=TransformerLM(cfg), config=config)
    check(eng.model.config.dtype == torch.float16,
          f"{label}: the fp16 engine's model runs in "
          f"{eng.model.config.dtype}")
    L = cfg.num_layers
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size,
                                     (FP16_MICRO, FP16_SEQ), dtype=np.int32)}
    n_params = eng.num_parameters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [eng.train_step(batch) for _ in range(FP16_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    per_step = {"flash_attention_fwd_f16": 2 * L,
                "flash_attention_bwd_f16": L}
    for name in build.COUNTERS:
        want = per_step.get(name, 0) * FP16_STEPS
        check(counts[name] == want, f"{label}: {name} launches "
                                    f"{counts[name]} != {want}")
    losses = [float(m["loss"]) for m in metrics]
    scales = [float(m["loss_scale"]) for m in metrics]
    skipped = [int(m["overflow"]) for m in metrics]
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    check(int(eng.state["step"]) == FP16_STEPS - sum(skipped),
          f"{label}: step {int(eng.state['step'])} after {sum(skipped)} "
          f"skipped of {FP16_STEPS}")
    taken = [x for x, s in zip(losses, skipped) if not s]
    check(len(taken) >= 2 and taken[-1] < taken[0],
          f"{label}: the loss over the steps taken did not fall {losses}")
    step_s = wall / FP16_STEPS
    tok_s = FP16_MICRO * FP16_SEQ / step_s
    flops_per_tok = 6 * n_params + 12 * L * cfg.d_model * FP16_SEQ
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"training: {label} ({n_params / 1e6:.1f} M params, {L} layers, "
          f"{cfg.num_heads} heads of {cfg.hdim}), seq {FP16_SEQ}, micro "
          f"{FP16_MICRO}, remat full, flash, fused head chunk 256, AdamW, "
          f"fp16 (float16 model over f32 masters, dynamic loss scale from "
          f"2^16): {FP16_STEPS} steps in {wall:.2f} s = "
          f"{step_s * 1e3:.1f} ms/step (the first included), "
          f"{tok_s:.0f} tokens/s, MFU {100 * tok_s * flops_per_tok / BF16_FLOPS:.2f} "
          f"% of 989 TF/s (f16 peak); peak memory {peak:.1f} GiB")
    print(f"  loss {' '.join(f'{x:.3f}' for x in losses)}; loss scale "
          f"{' '.join(f'{x:g}' for x in scales)}; skipped steps "
          f"{sum(skipped)} ({skipped})")
    print(f"  launches over {FP16_STEPS} steps: " + ", ".join(
        f"{n} {counts[n]} ({counts[n] // FP16_STEPS} per step)"
        for n in per_step) + "; every bf16 and f32 flash kernel 0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.train_step(batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    warm_tok_s = FP16_MICRO * FP16_SEQ / warm_ms * 1e3
    print(f"  3 more steps (warm): {warm_ms:.1f} ms/step = "
          f"{warm_tok_s:.0f} tokens/s, MFU "
          f"{100 * warm_tok_s * flops_per_tok / BF16_FLOPS:.2f} %")
    tck = TENSOR_CORE_KERNELS
    device_profile(torch, lambda: [eng.train_step(batch) for _ in range(2)],
                   f"{label} training 2 steps",
                   {"B1": (tck["flash_attention_fwd"],),
                    "B2": (tck["flash_attention_bwd"],)})

    # the planted overflow: inf in one embedding entry until the scale
    # falls; each such step skipped with step, params and moments held
    emb = eng.state["params"]["embed"]["embedding"]
    saved = emb[0, 0].clone()
    sc = eng.state["scaler"]
    scale0, hys0 = float(sc.scale), int(sc.hysteresis)
    trail = []
    for i in range(max(1, hys0)):
        step0 = int(eng.state["step"])
        skipped0 = int(eng.state["skipped"])
        eng.state["params"]["embed"]["embedding"][0, 0] = float("inf")
        probe = eng.state["params"]["blocks"]["ln1"]["scale"].clone()
        m = eng.train_step(batch)
        check(int(m["overflow"]) == 1,
              f"{label}: the planted inf was not seen as an overflow")
        check(int(eng.state["step"]) == step0 and
              int(eng.state["skipped"]) == skipped0 + 1,
              f"{label}: the overflow step moved step or skipped wrongly")
        check(torch.equal(probe,
                          eng.state["params"]["blocks"]["ln1"]["scale"]),
              f"{label}: the overflow step changed the parameters")
        trail.append((float(eng.state["scaler"].scale),
                      int(eng.state["scaler"].hysteresis)))
    want_scale = max(scale0 / 2, FP16_CONFIG["min_loss_scale"])
    check(trail[-1][0] == want_scale,
          f"{label}: the scale went {scale0:g} -> {trail} (want "
          f"{want_scale:g} once the hysteresis of {hys0} is spent)")
    eng.state["params"]["embed"]["embedding"][0, 0] = saved
    print(f"  planted inf in embed[0, 0]: {len(trail)} step(s) skipped "
          f"(step held at {int(eng.state['step'])}, skipped "
          f"{int(eng.state['skipped'])}); (scale, hysteresis) "
          f"{scale0:g}, {hys0} -> " + " -> ".join(
              f"{s:g}, {h}" for s, h in trail))

    # seq 2048: B1, and B3 + B4 (two 1024-row blocks), in float16
    long = {"input_ids": rs.randint(0, cfg.vocab_size,
                                    (FP16_MICRO, FP16_LONG_SEQ),
                                    dtype=np.int32)}
    eng.train_step(long)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    lm = [eng.train_step(long) for _ in range(2)]
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t0) / 2 * 1e3
    long_counts = dict(build.launch_counts)
    want = {"flash_attention_fwd_f16": 2 * L,
            "flash_attention_bwd_dq_f16": L,
            "flash_attention_bwd_dkv_f16": L}
    for name in build.COUNTERS:
        check(long_counts[name] == 2 * want.get(name, 0),
              f"{label} seq {FP16_LONG_SEQ}: {name} launches "
              f"{long_counts[name]} != {2 * want.get(name, 0)}")
    check(all(np.isfinite(float(m["loss"])) for m in lm),
          f"{label} seq {FP16_LONG_SEQ}: non-finite loss")
    print(f"  seq {FP16_LONG_SEQ}, micro {FP16_MICRO}: 2 steps at "
          f"{long_ms:.1f} ms/step, loss "
          + " ".join("%.3f" % float(m["loss"]) for m in lm)
          + "; launches per "
          f"step: " + ", ".join(f"{n} {long_counts[n] // 2}" for n in want))
    del eng, metrics, lm
    torch.cuda.empty_cache()
    return {"steps": {n: counts[n] for n in per_step},
            "long": {n: long_counts[n] for n in want},
            "ms": step_s * 1e3, "warm_ms": warm_ms}


# -- 15. fp16 serving at GPT-3 6.7B width ---------------------------------------
def fp16_serve_phase(torch, np, label, cfg) -> dict:
    """``init_inference(dtype="float16")`` on ``cfg`` with random weights
    from seed 0: ``generate()`` on phase 4's 8 x 128 prompts (64 new
    tokens, greedy) on the float16 B5 and no other B5; then phase 5's
    16-request drain at ``kv_cache_bits`` 0, 8 and 4 (engines sharing the
    float16 weights) on the float16 B6/B7 of that width and no other.  At
    kv_bits 0 the first-step logits of 4 requests must agree with
    ``generate()``'s within ``F16_LOGITS_REL_TOL`` of their scale, and every
    greedy server stream must equal ``generate()``'s up to its first near
    tie: where a stream parts, ``generate()``'s logits at that token
    (``divergence_gaps``) may favour its own token over the server's by
    at most twice that limit, the most two paths that each agree within
    it can differ by.  At 8 and 4 bits the token agreement is printed.
    Then int8 weights (``quant.enabled``) over the same float16 weights:
    ``forward()``'s logits within ``LOGITS_REL_TOL`` of the float16
    engine's and ``generate()`` on the float16 B5.  Returns the float16
    launch counts: B5 over ``generate()``, B6/B7 over each drain."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer import TransformerLM
    from deepspeed_tpu_torch.ops import build
    f16 = torch.float16
    t0 = time.perf_counter()
    eng = init_inference(TransformerLM(cfg), {
        "dtype": "float16", "temperature": 0.0, "serving": SERVING})
    torch.cuda.synchronize()
    check(eng.module.config.dtype == f16 and all(
        t.dtype == f16 for t in _leaves(eng.params)),
        f"{label} fp16: the engine's model or weights are not float16")
    print(f"{label} fp16 init: "
          f"{sum(t.numel() * t.element_size() for t in _leaves(eng.params)) / 1e9:.2f}"
          f" GB float16 in {time.perf_counter() - t0:.1f} s")
    rng, prompts, lens, sprompts = serving_prompts(np, cfg.vocab_size)
    warm_up_at_kv_head_width(eng, prompts, f"{label} fp16", cfg.kv_heads)
    build.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    gen = dict(build.launch_counts)
    check(tuple(out.shape) == (8, 64) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"{label} fp16 generate: tokens {tuple(out.shape)}")
    want = cfg.num_layers * 63
    for name, n in gen.items():
        expect = want if name == "decode_attention_f16" else 0
        if name.startswith("flash_attention_fwd"):
            continue     # generate()'s prefill runs plain attention
        check(n == expect, f"{label} fp16 generate: {name} launches {n} != "
                           f"{expect}")
    stats = eng.latency_stats()
    print(f"{label} fp16 generate: 8 x 128-token prompts, 64 new tokens: "
          f"TTFT {stats['ttft_p50_ms']:.1f} ms, decode "
          f"{stats['p50_ms']:.2f} ms/token "
          f"({8 * stats['tokens_per_sec']:.0f} tokens/s over the batch); "
          f"float16 B5 launches {gen['decode_attention_f16']}, bf16 B5 "
          f"{gen['decode_attention']}")
    device_profile(torch, lambda: eng.generate(prompts, max_new_tokens=16),
                   f"{label} fp16 generate 8 x 128 prompts, 16 new tokens",
                   shares={"B5": ("decode_cluster",)})
    refs = [eng.generate(np.asarray(p)[None], max_new_tokens=32)[0].tolist()
            for p in sprompts]
    counts = {}
    for bits in (0, 8, 4):
        e = eng if not bits else init_inference(
            TransformerLM(cfg), {"dtype": "float16", "temperature": 0.0,
                                 "serving": {**SERVING,
                                             "kv_cache_bits": bits}},
            params=eng.params)
        srv = e.serving_engine()
        first_logits = {}
        reqs, c, wall = drain(
            torch, srv, sprompts, f"{label} fp16 serving kv_bits {bits}",
            bits, None if bits else
            (lambda mixed: first_step_recorder(srv, mixed, first_logits)),
            dtype=f16)
        ntok = sum(len(r.output) for r in reqs)
        same_streams = sum(int(r.output == ref) for r, ref in
                           zip(reqs, refs))
        same = sum(int(a == b) for r, ref in zip(reqs, refs)
                   for a, b in zip(r.output, ref))
        b6 = build.counter("paged_decode_attention", bits, f16)
        b7 = build.counter("paged_prefill_attention", bits, f16)
        print(f"{label} fp16 serving, kv_bits {bits}: 16 requests, {ntok} "
              f"tokens in {wall:.2f} s = {ntok / wall:.1f} tokens/s; {b6} "
              f"{c[b6]}, {b7} {c[b7]} (every bf16 B6/B7 0); streams equal "
              f"to generate(): {same_streams} of 16, {same} of {ntok} "
              f"tokens")
        if not bits:
            worst = 0.0
            for r in reqs[:4]:
                want_l = prefill_logits(eng, r.prompt)
                got_l = first_logits[r.req_id]
                worst = max(worst, float((got_l - want_l).abs().max())
                            / float(want_l.abs().max()))
            print(f"  first-step logits of 4 requests within {worst!r} of "
                  f"max|logit| (limit {F16_LOGITS_REL_TOL})")
            check(worst <= F16_LOGITS_REL_TOL,
                  f"{label} fp16 serving: first-step logits differ by "
                  f"{worst:.4f} of their scale")
            gaps = divergence_gaps(np, eng, reqs, refs)
            for req_id, pos, gap in gaps:
                print(f"  {req_id} parts from generate() at token {pos}: "
                      f"generate()'s logit gap there {gap!r} of "
                      f"max|logit| (limit {2 * F16_LOGITS_REL_TOL})")
                check(gap <= 2 * F16_LOGITS_REL_TOL,
                      f"{label} fp16 serving: {req_id} parts from "
                      f"generate() at token {pos} where generate()'s gap is "
                      f"{gap:.4f} of max|logit|, not a near tie")
            drain_profile(torch, srv, lens, cfg.vocab_size, rng,
                          f"{label} fp16")
        counts[b6], counts[b7] = c[b6], c[b7]
        del srv, e
    counts["decode_attention_f16"] = gen["decode_attention_f16"]
    # int8 weights (quant.enabled) over the same f16 weights: forward()'s
    # last-position logits against the f16 engine's, generate() on f16 B5
    q8 = init_inference(TransformerLM(cfg), {
        "dtype": "float16", "temperature": 0.0, "quant": {"enabled": True}},
        params=eng.params)
    ref = eng.forward(prompts)[:, -1]
    got = q8.forward(prompts)[:, -1]
    rel = float((got - ref).abs().max()) / float(ref.abs().max())
    build.reset_launch_counts()
    out = q8.generate(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    n_b5 = build.launch_counts["decode_attention_f16"]
    print(f"{label} fp16 int8 weights: forward() last-position logits "
          f"within {rel:.4f} of max|logit| of the f16 engine's (limit "
          f"{LOGITS_REL_TOL}), argmax equal on "
          f"{int((got.argmax(-1) == ref.argmax(-1)).sum())} of 8; "
          f"generate() 16 new tokens on {n_b5} float16 B5 launches")
    check(rel <= LOGITS_REL_TOL and tuple(out.shape) == (8, 16)
          and n_b5 == cfg.num_layers * 15,
          f"{label} fp16 int8 weights: logits {rel:.4f} of their scale, "
          f"tokens {tuple(out.shape)}, float16 B5 {n_b5}")
    del q8, ref, got, eng
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def prefill_logits(eng, prompt):
    """``generate()``'s last-position logits (f32, on the host) after
    ``prompt``: its prefill, recorded."""
    import numpy as np
    prefill = eng._prefill
    out = {}

    def recording(ids, true_len, cache_len):
        cache, last = prefill(ids, true_len, cache_len)
        out["logits"] = last[0].float().cpu()
        return cache, last
    eng._prefill = recording
    try:
        eng.generate(np.asarray(list(prompt))[None], max_new_tokens=1)
    finally:
        eng._prefill = prefill
    return out["logits"]


def divergence_gaps(np, eng, reqs, refs):
    """For each server stream that parts from ``generate()``'s stream
    ``ref``: (request id, the first differing token's index, the gap
    between ``generate()``'s logit for its own token and for the server's
    there, as a share of max|logit|), from ``generate()``'s prefill over
    the prompt and the common prefix."""
    out = []
    for r, ref in zip(reqs, refs):
        if r.output == ref:
            continue
        pos = next(i for i, (a, b) in enumerate(zip(r.output, ref))
                   if a != b)
        lg = prefill_logits(eng, list(r.prompt) + list(ref[:pos]))
        gap = float(lg[ref[pos]] - lg[r.output[pos]]) / float(lg.abs().max())
        out.append((r.req_id, pos, gap))
    return out


# -- 16. fp16 block-sparse training of GPT-2 125M ----------------------------------
#: the fp16 block-sparse phase: phase 9's model, seq, micro and steps in
#: fp16 (on its one repeated batch both phases' losses spike at step 6
#: and fall again)
FP16_SPARSE_STEPS = SPARSE_STEPS


def fp16_sparse_train_phase(torch, np, model_cfg, keys) -> dict:
    """``initialize`` on phase 9's block-sparse GPT-2 125M (seq 8192,
    micro 8, remat full) with ``fp16`` (``FP16_CONFIG``: float16 model over
    f32 masters, dynamic loss scaling from 2^16), AdamW and clipping 1.0:
    ``FP16_SPARSE_STEPS`` steps each launching exactly 24 float16 B8, 12
    B9 and 12 B10 and no other attention kernel; ms/step, MFU (the
    layout's ``keys`` per query), the scale trajectory and the skipped
    steps; then one step at micro 1 from one state with the kernels and
    with plain attention masked by the layout: loss and grad norm within
    the step limits.  Returns the float16 launch counts."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import TransformerLM
    from deepspeed_tpu_torch.ops import build
    label = "fp16 block-sparse GPT-2 125M"
    optimizer = {"type": "AdamW", "params": {"lr": 6e-4,
                                             "weight_decay": 0.1}}

    def make(mb, loss_fn=None):
        config = {"train_micro_batch_size_per_gpu": mb,
                  "gradient_accumulation_steps": 1, "optimizer": optimizer,
                  "fp16": FP16_CONFIG, "zero_optimization": {"stage": 0},
                  "gradient_clipping": 1.0, "steps_per_print": 0}
        return initialize(model=TransformerLM(model_cfg("blocksparse")),
                          config=config, loss_fn=loss_fn)[0]
    eng = make(SPARSE_MICRO)
    cfg = eng.model.config
    check(cfg.dtype == torch.float16, f"{label}: model in {cfg.dtype}")
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size,
                                     (SPARSE_MICRO, SPARSE_SEQ),
                                     dtype=np.int32)}
    n_params = eng.num_parameters()
    L = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [eng.train_step(batch) for _ in range(FP16_SPARSE_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    per_step = {"blocksparse_flash_fwd_f16": 2 * L,
                "blocksparse_flash_bwd_dq_f16": L,
                "blocksparse_flash_bwd_dkv_f16": L}
    for name in build.COUNTERS:
        want = per_step.get(name, 0) * FP16_SPARSE_STEPS
        check(counts[name] == want,
              f"{label}: {name} launches {counts[name]} != {want}")
    losses = [float(m["loss"]) for m in metrics]
    scales = [float(m["loss_scale"]) for m in metrics]
    skipped = [int(m["overflow"]) for m in metrics]
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    taken = [x for x, sk in zip(losses, skipped) if not sk]
    check(len(taken) >= 2 and taken[-1] < taken[0],
          f"{label}: the loss over the steps taken did not fall {losses}")
    step_s = wall / FP16_SPARSE_STEPS
    tok_s = SPARSE_MICRO * SPARSE_SEQ / step_s
    flops_per_tok = 6 * n_params + 12 * L * cfg.d_model * keys
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    for _ in range(2):
        eng.train_step(batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) / 2 * 1e3
    warm_tok_s = SPARSE_MICRO * SPARSE_SEQ / warm_ms * 1e3
    print(f"training: {label} ({n_params / 1e6:.1f} M params), seq "
          f"{SPARSE_SEQ}, micro {SPARSE_MICRO}, remat full, blocksparse, "
          f"AdamW, fp16 (dynamic loss scale from 2^16): "
          f"{FP16_SPARSE_STEPS} steps in {wall:.2f} s = "
          f"{step_s * 1e3:.1f} ms/step (the first included), 2 warm steps "
          f"{warm_ms:.1f} ms/step = {warm_tok_s:.0f} tokens/s, MFU "
          f"{100 * warm_tok_s * flops_per_tok / BF16_FLOPS:.2f} % of 989 "
          f"TF/s; peak memory {peak:.1f} GiB")
    print(f"  loss {' '.join(f'{x:.3f}' for x in losses)}; loss scale "
          f"{' '.join(f'{x:g}' for x in scales)}; skipped steps "
          f"{sum(skipped)} ({skipped}); launches per step: " + ", ".join(
              f"{n} {counts[n] // FP16_SPARSE_STEPS}" for n in per_step)
          + "; every bf16 and f32 attention kernel 0")
    tck = TENSOR_CORE_KERNELS
    device_profile(torch, lambda: [eng.train_step(batch) for _ in range(2)],
                   f"{label} training 2 steps",
                   {"B8": (tck["blocksparse_flash_fwd"],),
                    "B9 + B10": (tck["blocksparse_flash_bwd_dq"],
                                 tck["blocksparse_flash_bwd_dkv"])})
    del eng, metrics
    torch.cuda.empty_cache()
    # one step at micro 1 from one state: kernels against masked plain
    import dataclasses
    models = {"kernels": TransformerLM(dataclasses.replace(
        model_cfg("blocksparse"), dtype=torch.float16)),
              "plain": masked_plain_model(dataclasses.replace(
                  model_cfg("xla"), dtype=torch.float16))}
    impl = {"now": "kernels"}
    e = make(1, loss_fn=lambda p, b: models[impl["now"]].loss(p, b))
    small = {"input_ids": batch["input_ids"][:1]}
    start = e.state
    impl["now"] = "plain"
    mp = e.train_step(small)
    lp, gp = float(mp["loss"]), float(mp["grad_norm"])
    e.state, impl["now"] = start, "kernels"
    mk = e.train_step(small)
    lk, gk = float(mk["loss"]), float(mk["grad_norm"])
    print(f"  step 1 at micro 1, both from one state: loss kernels "
          f"{lk:.5f} plain {lp:.5f} "
          f"({abs(lk - lp) / abs(lp) / STEP_LOSS_REL_TOL:.3g} of the "
          f"limit); grad norm kernels {gk:.4f} plain {gp:.4f} "
          f"({abs(gk - gp) / abs(gp) / STEP_GNORM_REL_TOL:.3g} of the "
          f"limit)")
    check(abs(lk - lp) <= STEP_LOSS_REL_TOL * abs(lp),
          f"{label}: loss kernels {lk} vs plain {lp}")
    check(abs(gk - gp) <= STEP_GNORM_REL_TOL * abs(gp),
          f"{label}: grad norm kernels {gk} vs plain {gp}")
    del e, start, models
    torch.cuda.empty_cache()
    return {n: counts[n] for n in per_step}


# -- 17. resume from a checkpoint ------------------------------------------------
#: the resume phase: GPT-2 125M at seq 1024, micro 16, LAMB, remat
#: dots_no_batch, fp16 with dynamic loss scaling; RESUME_STEPS straight
#: against half, a save, a fresh engine, a load and the other half
RESUME_STEPS, RESUME_MICRO = 6, 16


def resume_phase(torch, np) -> None:
    """Train straight for ``RESUME_STEPS`` steps; train another engine
    half of them, ``save_checkpoint`` into a temporary directory, build a
    fresh engine (another seed), ``load_checkpoint`` and take the other
    half: the later losses, the final params, optimizer state and loss
    scaler must be bit-equal to the straight run's.  Prints the save and
    load seconds and the bytes written; then ``init_inference(checkpoint=
    ...)`` serves the checkpoint: its weights equal the saved masters
    cast to float16, and ``generate()`` runs on the float16 B5."""
    import tempfile
    from deepspeed_tpu_torch import init_inference, initialize
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.ops import build
    label = "resume GPT-2 125M"
    cfg = gpt2_config("125m", max_seq_len=TRAIN_SEQ, remat="dots_no_batch",
                      attn_impl="flash", loss_chunk=256)
    config = {"train_micro_batch_size_per_gpu": RESUME_MICRO,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "Lamb", "params": {
                  "lr": 2e-3, "weight_decay": 0.01}},
              "fp16": {**FP16_CONFIG, "loss_scale_window": 2},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    rs = np.random.RandomState(5)
    batches = [{"input_ids": rs.randint(0, cfg.vocab_size,
                                        (RESUME_MICRO, TRAIN_SEQ),
                                        dtype=np.int32)}
               for _ in range(RESUME_STEPS)]
    half = RESUME_STEPS // 2

    def engine(seed):
        return initialize(model=TransformerLM(cfg), config=config,
                          seed=seed)[0]
    straight = engine(0)
    want = [float(straight.train_step(b)["loss"]) for b in batches]
    first = engine(0)
    got = [float(first.train_step(b)["loss"]) for b in batches[:half]]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = first.save_checkpoint(d, client_state={"half": half})
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).rglob("*")
                     if f.is_file())
        saved = [t.to(torch.float16) for t in _leaves(first.state["params"])]
        del first
        torch.cuda.empty_cache()
        second = engine(7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, client = second.load_checkpoint(d)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(client == {"half": half}, f"{label}: client_state {client}")
        build.reset_launch_counts()
        got += [float(second.train_step(b)["loss"])
                for b in batches[half:]]
        check(build.launch_counts["flash_attention_fwd_f16"] > 0,
              f"{label}: the fp16 steps ran no float16 B1")
        check(got == want, f"{label}: losses {got} != straight {want}")
        same = all(torch.equal(a, b) for a, b in zip(
            _leaves({k: v for k, v in second.state.items()
                     if k != "scaler"}),
            _leaves({k: v for k, v in straight.state.items()
                     if k != "scaler"})))
        same &= all(torch.equal(a, b) for a, b in zip(
            second.state["scaler"], straight.state["scaler"]))
        check(same, f"{label}: the resumed state differs from the straight "
                    f"run's")
        print(f"{label} (LAMB, remat dots_no_batch, fp16 dynamic scale): "
              f"{RESUME_STEPS} steps straight against {half}, save, fresh "
              f"engine, load, {half}: later losses and final params, "
              f"optimizer state and scaler bit-equal (losses "
              f"{' '.join(f'{x:.4f}' for x in got)}; scale "
              f"{second.loss_scale:g}); save {save_s:.2f} s, {nbytes} bytes "
              f"written ({nbytes / save_s / 1e9:.2f} GB/s), load "
              f"{load_s:.2f} s")
        del straight, second
        torch.cuda.empty_cache()
        ie = init_inference(TransformerLM(gpt2_config("125m")), {
            "dtype": "float16", "temperature": 0.0, "checkpoint": d})
        check(all(torch.equal(a, b) for a, b in zip(_leaves(ie.params),
                                                      saved)),
            f"{label}: init_inference(checkpoint=...) weights differ from "
            f"the saved masters")
        build.reset_launch_counts()
        out = ie.generate(batches[0]["input_ids"][:4, :64],
                          max_new_tokens=16)
        torch.cuda.synchronize()
        check(tuple(out.shape) == (4, 16) and
              build.launch_counts["decode_attention_f16"] ==
              cfg.num_layers * 15,
              f"{label}: serving the checkpoint: {tuple(out.shape)}, "
              f"float16 B5 {build.launch_counts['decode_attention_f16']}")
        print(f"{label}: init_inference(checkpoint=...) serves it in "
              f"float16: weights equal the saved masters cast, generate() "
              f"4 x 64 prompts, 16 new tokens on "
              f"{build.launch_counts['decode_attention_f16']} float16 B5 "
              f"launches")
        del ie, saved
    torch.cuda.empty_cache()


# -- 18. the remat policies --------------------------------------------------------
REMAT_MICRO, REMAT_STEPS = 16, 3


def remat_table_phase(torch, np) -> None:
    """GPT-2 125M at seq 1024, micro ``REMAT_MICRO``, flash, bf16, AdamW,
    under each remat policy: one warm step, then ``REMAT_STEPS`` timed;
    peak ``max_memory_allocated`` over the timed steps and ms/step.  A
    policy changes what is kept, not what is computed, so every policy's
    step-1 gradient norm must be ``none``'s within STEP_GNORM_REL_TOL and
    its step-2 loss (after an update from those gradients) within
    STEP_LOSS_REL_TOL: the backward recomputes B1 and feeds B2 from the
    recomputed o and lse.  The first-step losses (forward only) must be
    equal, and the kernels launch as the policy implies: B1 twice per
    layer and step under every policy but none."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.ops import build
    rs = np.random.RandomState(6)
    batch = {"input_ids": rs.randint(0, 50257, (REMAT_MICRO, TRAIN_SEQ),
                                     dtype=np.int32)}
    rows = []
    for policy in ("none", "full", "dots_saveable", "dots_no_batch",
                   "nothing_saveable"):
        cfg = gpt2_config("125m", max_seq_len=TRAIN_SEQ, remat=policy,
                          attn_impl="flash", loss_chunk=256)
        eng = initialize(model=TransformerLM(cfg), config={
            "train_micro_batch_size_per_gpu": REMAT_MICRO,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 6e-4}},
            "bf16": {"enabled": True}, "gradient_clipping": 1.0,
            "steps_per_print": 0})[0]
        m = eng.train_step(batch)
        first, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(REMAT_STEPS):
            m = eng.train_step(batch)
            if i == 0:
                second = m["loss"].clone()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / REMAT_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        b1 = build.launch_counts["flash_attention_fwd"] // REMAT_STEPS
        want = cfg.num_layers * (1 if policy == "none" else 2)
        check(b1 == want, f"remat {policy}: {b1} B1 launches a step, not "
                          f"{want}")
        rows.append((policy, first, gnorm, float(second), ms, peak, b1))
        del eng
        torch.cuda.empty_cache()
    _, first0, gnorm0, second0 = rows[0][:4]
    check(len({r[1] for r in rows}) == 1,
          f"remat policies: first-step losses differ {[r[1] for r in rows]}")
    for policy, _, gnorm, second, *_ in rows[1:]:
        g_rel = abs(gnorm - gnorm0) / gnorm0
        l_rel = abs(second - second0) / abs(second0)
        check(g_rel <= STEP_GNORM_REL_TOL and l_rel <= STEP_LOSS_REL_TOL,
              f"remat {policy}: step-1 grad norm {gnorm} against none's "
              f"{gnorm0} ({g_rel:.2e}, limit {STEP_GNORM_REL_TOL}), step-2 "
              f"loss {second} against {second0} ({l_rel:.2e}, limit "
              f"{STEP_LOSS_REL_TOL})")
    print(f"remat policies, GPT-2 125M seq {TRAIN_SEQ} micro {REMAT_MICRO} "
          f"flash bf16 AdamW (first-step loss {first0!r} under every "
          f"policy; none's step-1 grad norm {gnorm0!r}, step-2 loss "
          f"{second0!r}): " + "; ".join(
              f"{p}: grad norm {g!r}, step-2 loss {l2!r} ("
              + ("bit-equal to none" if (g, l2) == (gnorm0, second0)
                 else "differs from none")
              + f"), {ms:.1f} ms/step, peak {peak:.2f} GiB, {b1} B1 a step"
              for p, _, g, l2, ms, peak, b1 in rows))


def masked_plain_model(cfg):
    """The block-sparse model with plain attention masked by its layout
    (the JAX model's path for a T that the block does not divide) in
    place of B8-B10: the plain side of the block-sparse step check."""
    from deepspeed_tpu_torch.models import layers as L
    from deepspeed_tpu_torch.models.transformer import TransformerLM

    class MaskedPlain(TransformerLM):
        def _attend_full(self, q, k, v, window=None):
            del window                  # a block-sparse model has none
            b, t = q.shape[0], q.shape[1]
            mask = self._sparse_mask(0, t, t, q.device)
            return L.gqa_attention(q, k, v, mask=mask).reshape(b, t, -1)
    return MaskedPlain(cfg)


def step_time_phase(torch, np, label, cfg, optimizer, micro, seq, steps,
                    per_step) -> float:
    """``initialize`` on ``cfg`` as ``train_phase`` does, one step to warm
    up, then ``steps`` timed steps on one seeded batch: ms/step, tokens/s,
    MFU (``bench.py``'s formula), peak memory and the kernels' launches
    per step, which must equal ``per_step``.  Returns ms/step."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import TransformerLM
    from deepspeed_tpu_torch.ops import build
    eng, _, _, _ = initialize(model=TransformerLM(cfg), config={
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": 1, "optimizer": optimizer,
        "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
        "gradient_clipping": 1.0, "steps_per_print": 0})
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size, (micro, seq),
                                     dtype=np.int32)}
    n_params = eng.num_parameters()
    torch.cuda.reset_peak_memory_stats()
    eng.train_step(batch)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [float(eng.train_step(batch)["loss"]) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = dict(build.launch_counts)
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    for name, n in per_step.items():
        check(counts[name] == n * steps,
              f"{label}: {name} launches {counts[name]} != {n * steps}")
    tok_s = micro * seq / step_ms * 1e3
    flops_per_tok = 6 * n_params + 12 * cfg.num_layers * cfg.d_model * seq
    print(f"training: {label}, seq {seq}, micro {micro}, {cfg.attn_impl}: "
          f"{steps} warm steps at {step_ms:.1f} ms/step = {tok_s:.0f} "
          f"tokens/s, MFU {100 * tok_s * flops_per_tok / BF16_FLOPS:.2f} % "
          f"(bench.py's formula); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches "
          f"per step: " + ", ".join(f"{name} {counts[name] // steps}"
                                    for name in per_step))
    del eng
    torch.cuda.empty_cache()
    return step_ms


def sparse_serve_phase(torch, np, cfg) -> dict:
    """``init_inference`` on the block-sparse GPT-2 125M (bf16, random
    weights from seed 0, kernel injection on, which must keep
    ``blocksparse``): ``forward()`` on 2 prompts of 8192 tokens through
    B8 (one launch per layer, no other kernel); ``generate()`` on 2
    prompts of 4096 tokens, 16 new, greedy, on the dense cache with the
    layout as a mask (no kernel: B5 takes no layout), its prefill's
    last-position logits against ``forward()``'s on the same prompts;
    the server must refuse the model.  Returns B8's launches over the
    8192-token ``forward()``."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer import TransformerLM
    from deepspeed_tpu_torch.ops import build
    eng = init_inference(TransformerLM(cfg), {
        "dtype": "bfloat16", "temperature": 0.0,
        "max_out_tokens": cfg.max_seq_len, "serving": SERVING})
    check(eng.module.config.attn_impl == "blocksparse",
          f"init_inference rewrote attn_impl to "
          f"{eng.module.config.attn_impl!r}")
    rng = np.random.default_rng(1)
    V, L = cfg.vocab_size, cfg.num_layers
    long = rng.integers(0, V, (2, cfg.max_seq_len))
    eng.forward(long[:, :1024])                       # warm-up
    build.reset_launch_counts()
    t0 = time.perf_counter()
    fwd = eng.forward(long)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_counts = dict(build.launch_counts)
    check(tuple(fwd.shape) == (2, cfg.max_seq_len, V)
          and bool(fwd.isfinite().all()), f"forward logits {fwd.shape}")
    for name, n in fwd_counts.items():
        want = L if name == "blocksparse_flash_fwd" else 0
        check(n == want, f"block-sparse forward: {name} launches {n} != "
                         f"{want}")
    del fwd
    prompts = rng.integers(0, V, (2, cfg.max_seq_len // 2))
    prefill = eng._prefill
    gen_last = {}

    def recording_prefill(ids, true_len, cache_len):
        cache, last = prefill(ids, true_len, cache_len)
        gen_last["logits"] = last.float()
        return cache, last
    eng._prefill = recording_prefill
    build.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    eng._prefill = prefill
    gen_counts = dict(build.launch_counts)
    check(tuple(out.shape) == (2, 16)
          and bool(((out >= 0) & (out < V)).all()),
          f"generate tokens {tuple(out.shape)}")
    check(not any(gen_counts.values()),
          f"block-sparse generate() launched {gen_counts}")
    stats = eng.latency_stats()
    ref = gen_last["logits"]
    last = eng.forward(prompts)[:, -1]
    torch.cuda.synchronize()
    err = float((last - ref).abs().max())
    rel = err / float(ref.abs().max())
    same = int((last.argmax(-1) == ref.argmax(-1)).sum())
    print(f"block-sparse serving: forward() on 2 x {cfg.max_seq_len} "
          f"tokens in {fwd_ms:.1f} ms, B8 launches "
          f"{fwd_counts['blocksparse_flash_fwd']}; generate() on 2 x "
          f"{prompts.shape[1]} prompts, 16 new: TTFT "
          f"{stats['ttft_p50_ms']:.1f} ms, decode {stats['p50_ms']:.2f} "
          f"ms/token (plain attention masked by the layout; no kernel "
          f"launched); prefill last-position logits max|forward - "
          f"prefill| {err:.4f} = {rel:.4f} of max|logit| (limit "
          f"{LOGITS_REL_TOL}), argmax equal on {same} of 2")
    check(rel <= LOGITS_REL_TOL,
          f"block-sparse forward/generate logits differ by {rel:.4f} of "
          f"their scale")
    try:
        eng.serving_engine()
    except NotImplementedError as e:
        print(f"  serving_engine() refuses the model: {e}")
    else:
        fail("serving_engine() accepted a block-sparse model")
    del eng, last, ref
    torch.cuda.empty_cache()
    return fwd_counts


def loss_head_ms(torch, eng, batch, micro, seq) -> dict:
    """Device ms of the loss head alone (``nll_from_hidden`` on the
    engine's bf16 head weight: the tied embedding or the untied
    ``lm_head``), forward and forward + backward, at the step's shape:
    hidden states [micro, seq, d_model] from a seeded generator."""
    dev = eng.device
    g = torch.Generator(device=dev)
    g.manual_seed(99)
    params = eng.state["params"]
    path = (("embed", "embedding") if eng.model.config.tie_embeddings
            else ("lm_head", "kernel"))
    w = params[path[0]][path[1]].detach().requires_grad_(True)
    x = torch.randn((micro, seq, eng.model.config.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    x.requires_grad_(True)
    labels = torch.as_tensor(batch["input_ids"]).long().to(dev)

    def nll():
        return eng.model.nll_from_hidden(
            {path[0]: {path[1]: w.to(torch.bfloat16)}}, x, labels)

    def both():
        torch.autograd.grad(nll(), (x, w))
    out = {}
    for key, fn in (("fwd", nll), ("both", both)):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(3):
            fn()
        b.record()
        b.synchronize()
        out[key] = a.elapsed_time(b) / 3
    return out


def device_profile(torch, fn, label: str, shares=None) -> None:
    """Run ``fn`` once unprofiled for its wall time, then once under
    ``torch.profiler`` (CUDA activity only) for the kernel time, and
    print the card's busy share (kernel time over the unprofiled wall
    time), the kernels that took the most time and, for each entry of
    ``shares`` (label: kernel-name substrings), the share of device time
    of the kernels whose names hold one of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern)
    if not busy:
        print(f"profile {label}: device time not measured (no CUDA "
              f"events in the trace)")
        return
    print(f"profile {label}: device busy {busy / 1e3:.1f} ms of "
          f"{wall_us / 1e3:.1f} ms wall ({100 * busy / wall_us:.1f} %), "
          f"{sum(e.count for e in kern)} kernel launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {100 * e.self_device_time_total / busy:5.1f} %  "
              f"{e.count:6d} x  {e.key[:90]}")
    for name, keys in (shares or {}).items():
        hit = [e for e in kern if any(k in e.key for k in keys)]
        t = sum(e.self_device_time_total for e in hit)
        print(f"  {name}: {t / 1e3:.1f} ms = {100 * t / busy:.1f} % of "
              f"device time, {sum(e.count for e in hit)} launches")


def _leaves(tree):
    """The tensors of a params tree (nested dicts and lists)."""
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list)):
            yield from _leaves(v)
        else:
            yield v


# -- phases 21-23: MoE serving, MoE training, Stable Diffusion -------------
#: DeepSpeed-MoE 350M+MoE-128 (Rajbhandari et al., arXiv:2201.05596, its
#: table of model configurations; Megatron-DeepSpeed's
#: ds_pretrain_gpt_350M_MoE128.sh): GPT-3 350M's shape, 128 experts on
#: every other layer, top-1, capacity factor 1.0 in training and eval, min
#: capacity 4, aux coefficient 0.01, vocab 50257, positions to 2048
MOE_SERVE = dict(vocab_size=50257, max_seq_len=2048, moe_num_experts=128,
                 moe_freq=2, moe_k=1, moe_capacity_factor=1.0,
                 moe_eval_capacity_factor=1.0, moe_min_capacity=4,
                 moe_aux_loss_coef=0.01)
#: 125M+MoE-64 (ds_pretrain_gpt_125M_MoE64.sh): GPT-3 125M's shape, 64
#: experts on every other layer, the routing above, seq 2048
MOE_TRAIN = dict(MOE_SERVE, moe_num_experts=64)
#: the MoE training phase: seq 2048, micro 8 (the one size chosen for the
#: run's time), 10 steps; flash against plain attention at micro 2
MOE_SEQ, MOE_MICRO, MOE_STEPS, MOE_CHECK_MICRO = 2048, 8, 10, 2

#: Stable Diffusion v1.x (the JAX defaults UNetConfig(), VAEConfig(),
#: CLIPTextConfig()): 512x512 images (64x64 latents), batch 1 with
#: classifier-free guidance (the UNet sees batch 2), 20 DDIM steps, bf16
SD_STEPS, SD_GUIDANCE = 20, 7.5
#: the parameters of SD v1.x's published components (diffusers'
#: UNet2DConditionModel and AutoencoderKL, transformers' CLIPTextModel):
#: the trees must hold exactly these
SD_PARAMS = {"unet": 859_520_964, "vae": 83_653_863,
             "text_encoder": 123_060_480}
#: one UNet step's eps in bf16 against the same step in float32 (TF32
#: off) on the same weights: bf16 keeps 8 bits of mantissa, so each of the
#: step's ~70 rounded layers adds a relative error of about 2^-9, and
#: independent roundings grow as the square root of their number: about
#: 2^-9 x sqrt(70) = 1.6 % of the output's scale, held here to 3x that, as
#: a share of max|eps|
DIFFUSION_EPS_REL_TOL = 0.05


def moe_layer_report(stats, tokens, label) -> None:
    """Each MoE layer's routing from ``model.moe_stats``: the largest
    expert queue, the experts no token chose, and the tokens dropped
    (queued past the capacity), of ``tokens``."""
    for i, (counts, kept, cap) in enumerate(stats):
        c = counts.cpu()
        dropped = tokens - int(kept)
        print(f"  {label} MoE layer {i} (block {2 * i + 1}): capacity "
              f"{cap}, largest queue {int(c.max())}, experts chosen by no "
              f"token {int((c == 0).sum())} of {c.numel()}, dropped "
              f"{dropped} of {tokens} tokens; exp_counts "
              f"{' '.join(str(int(x)) for x in c)}")


def moe_serve_phase(torch, np) -> dict:
    """Phase 21: ``init_inference`` on 350M+MoE-128 (bf16, random weights
    from seed 0, ``moe.enabled`` with ``ep_size`` 1): the server refuses
    the model (the JAX reason); ``generate()`` of 8 x 128 prompts, 64 new
    tokens, greedy (B5 exactly 24 x 63 times, B1 never), TTFT and decode
    ms/token, the profile's busy share; ``forward()`` on the same prompts
    (B1 exactly 24 times), its last-position logits within
    ``LOGITS_REL_TOL`` of ``generate()``'s first step (the same S =
    1024 routed tokens); each MoE layer's exp_counts and dropped tokens
    for both; the peak memory."""
    import gc
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.ops import build
    label = "350M+MoE-128"
    cfg = gpt2_config("350m", **MOE_SERVE)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.hdim, cfg.ff_dim,
           cfg.moe_num_experts, cfg.scan_length) == (24, 1024, 16, 64, 4096,
                                                     128, 12),
          f"{label} config {cfg}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = init_inference(TransformerLM(cfg), {
        "dtype": "bfloat16", "temperature": 0.0,
        "moe": {"enabled": True, "ep_size": 1},
        "serving": {"enabled": True}})
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    print(f"{label} init: {cfg.num_params() / 1e9:.4f} B params "
          f"({cfg.num_params(active=True) / 1e9:.4f} B active a token), "
          f"{nbytes / 1e9:.2f} GB bf16, in {time.perf_counter() - t0:.1f} s")
    try:
        eng.serving_engine()
        fail(f"{label}: the server took an MoE model")
    except NotImplementedError as err:
        check("MoE block stacks" in str(err), f"{label}: server refused "
              f"with {err}")
        print(f"{label} server refused: {err}")
    rng, prompts, _, _ = serving_prompts(np, cfg.vocab_size)
    warm_up_at_kv_head_width(eng, prompts, label, cfg.kv_heads)
    build.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    gen_counts = dict(build.launch_counts)
    decode_stats = list(eng.module.moe_stats)
    check(tuple(out.shape) == (8, 64), f"generate shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generate tokens out of vocab range")
    want = cfg.num_layers * 63
    check(gen_counts["decode_attention"] == want
          and gen_counts["flash_attention_fwd"] == 0,
          f"{label} generate: B5 launches {gen_counts['decode_attention']} "
          f"(want {want}), B1 {gen_counts['flash_attention_fwd']} (want 0)")
    stats = eng.latency_stats()
    print(f"{label} generate: 8 x 128-token prompts, 64 new tokens: TTFT "
          f"{stats['ttft_p50_ms']:.1f} ms, decode {stats['p50_ms']:.2f} "
          f"ms/token ({8 * stats['tokens_per_sec']:.0f} tokens/s over the "
          f"batch); B5 launches {gen_counts['decode_attention']}; every "
          f"decode step reads all {cfg.moe_num_experts} experts of "
          f"{cfg.scan_length} layers (the batched product over [E, C, M])")
    device_profile(torch, lambda: eng.generate(prompts, max_new_tokens=16),
                   f"{label} generate 8 x 128 prompts, 16 new tokens",
                   shares={"B5": ("decode_cluster", "decode_attention")})

    prefill = eng._prefill
    gen = {}

    def recording_prefill(ids, true_len, cache_len):
        cache, last = prefill(ids, true_len, cache_len)
        gen["logits"] = last.float()
        gen["stats"] = list(eng.module.moe_stats)
        return cache, last
    eng._prefill = recording_prefill
    eng.generate(prompts, max_new_tokens=1)
    eng._prefill = prefill
    build.reset_launch_counts()
    t0 = time.perf_counter()
    fwd = eng.forward(prompts)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_counts = dict(build.launch_counts)
    fwd_stats = list(eng.module.moe_stats)
    check(tuple(fwd.shape) == (8, 128, cfg.vocab_size)
          and bool(fwd.isfinite().all()), f"forward logits {fwd.shape}")
    check(fwd_counts["flash_attention_fwd"] == cfg.num_layers,
          f"{label} forward: B1 launches "
          f"{fwd_counts['flash_attention_fwd']} != {cfg.num_layers}")
    ref = gen["logits"]
    err = float((fwd[:, -1] - ref).abs().max())
    rel = err / float(ref.abs().max())
    same = int((fwd[:, -1].argmax(-1) == ref.argmax(-1)).sum())
    same_layers = sum(bool(torch.equal(a[0], b[0]))
                      for a, b in zip(fwd_stats, gen["stats"]))
    print(f"{label} forward: 8 x 128 prompts in {fwd_s * 1e3:.1f} ms, B1 "
          f"launches {fwd_counts['flash_attention_fwd']}; last-position "
          f"logits max|forward - generate first step| {err:.4f} = "
          f"{rel:.4f} of max|logit| (limit {LOGITS_REL_TOL}), argmax equal "
          f"on {same} of 8; exp_counts equal to generate()'s prefill in "
          f"{same_layers} of {len(fwd_stats)} MoE layers")
    check(rel <= LOGITS_REL_TOL, f"{label}: forward/generate logits differ "
                                 f"by {rel:.4f} of their scale")
    moe_layer_report(fwd_stats, 8 * 128, "forward()")
    moe_layer_report(gen["stats"], 8 * 128, "generate() prefill")
    moe_layer_report(decode_stats, 8, "generate() last decode step")
    print(f"{label}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated)")
    del eng, fwd, ref, gen
    gc.collect()
    torch.cuda.empty_cache()
    return {"decode_attention": gen_counts["decode_attention"],
            "flash_attention_fwd": fwd_counts["flash_attention_fwd"]}


def moe_train_phase(torch, np) -> dict:
    """Phase 22: ``initialize`` on 125M+MoE-64 (seq 2048, micro 8, remat
    full, flash, fused loss head at chunk 256, AdamW, bf16 over f32
    masters, clipping 1.0, weights from seed 0), 10 steps with
    ``batch["moe_rng"]`` = the step's number (RTS runs): exactly 24 B1,
    12 B3, 12 B4 and no B2 a step (seq 2048 spans two of the flash
    backward's 1024-row blocks: the JAX dispatch rule takes B3 + B4), a
    falling loss, ms/step and MFU on the active parameters; the
    same-state step check against plain attention at micro 2 with the
    same routing seed; remat none against full at step 1: equal routing
    in every MoE layer and the grad norm within the step check's
    limit."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.ops import build
    label = "125M+MoE-64"
    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd": 0,
                "flash_attention_bwd_dq": 12, "flash_attention_bwd_dkv": 12}
    opt = {"type": "AdamW", "params": {"lr": 6e-4, "weight_decay": 0.1}}

    def model_cfg(attn_impl, remat="full"):
        return gpt2_config("125m", attn_impl=attn_impl, remat=remat,
                           loss_chunk=256, **MOE_TRAIN)

    def make(attn_impl, mb, remat="full", loss_fn=None):
        cfg = model_cfg(attn_impl, remat)
        eng, _, _, _ = initialize(model=TransformerLM(cfg), config={
            "train_micro_batch_size_per_gpu": mb,
            "gradient_accumulation_steps": 1, "optimizer": opt,
            "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
            "gradient_clipping": 1.0, "steps_per_print": 0},
            loss_fn=loss_fn)
        return cfg, eng

    cfg, eng = make("flash", MOE_MICRO)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.moe_num_experts,
           cfg.scan_length) == (12, 768, 12, 64, 6), f"{label} config {cfg}")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (MOE_MICRO, MOE_SEQ), dtype=np.int32)
    n_params = eng.num_parameters()
    n_active = cfg.num_params(active=True)
    check(n_params == cfg.num_params(), f"{label}: {n_params} parameters, "
          f"the config counts {cfg.num_params()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [eng.train_step({"input_ids": ids, "moe_rng": i})
               for i in range(MOE_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{label} training: non-finite loss or grad norm {losses} {gnorms}")
    check(losses[-1] < losses[0], f"{label} training: loss did not fall "
                                  f"({losses[0]} -> {losses[-1]})")
    for name, n in per_step.items():
        check(counts[name] == n * MOE_STEPS,
              f"{label} training: {name} launches {counts[name]} != "
              f"{n * MOE_STEPS}")
    # bench.py:212-215 with N the active parameters (non-expert ones,
    # the gate and k = 1 expert per MoE layer), not all 64 experts
    flops_per_tok = 6 * n_active + 12 * cfg.num_layers * cfg.d_model * MOE_SEQ
    tok_s = MOE_MICRO * MOE_SEQ / (wall / MOE_STEPS)
    print(f"training: {label} ({n_params / 1e9:.4f} B params, "
          f"{n_active / 1e6:.1f} M active a token), seq {MOE_SEQ}, micro "
          f"{MOE_MICRO}, remat full, flash, fused head chunk 256, AdamW "
          f"bf16/f32, moe_rng per step: {MOE_STEPS} steps in {wall:.2f} s = "
          f"{wall / MOE_STEPS * 1e3:.1f} ms/step (the first included), "
          f"{tok_s:.0f} tokens/s, MFU on active params "
          f"{100 * tok_s * flops_per_tok / BF16_FLOPS:.2f} %; peak memory "
          f"{peak:.1f} GiB")
    print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f} (every step: "
          f"{' '.join(f'{x:.3f}' for x in losses)}); grad norm "
          f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f}")
    print(f"  launches over {MOE_STEPS} steps: " + ", ".join(
        f"{name} {counts[name]} ({counts[name] // MOE_STEPS} per step)"
        for name in per_step))
    moe_layer_report(eng.model.moe_stats, MOE_MICRO * MOE_SEQ,
                     f"step {MOE_STEPS}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        eng.train_step({"input_ids": ids, "moe_rng": MOE_STEPS + i})
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    warm_tok_s = MOE_MICRO * MOE_SEQ / warm_ms * 1e3
    print(f"  3 more steps (warm): {warm_ms:.1f} ms/step = {warm_tok_s:.0f} "
          f"tokens/s, MFU on active params "
          f"{100 * warm_tok_s * flops_per_tok / BF16_FLOPS:.2f} % (on all "
          f"{n_params / 1e9:.2f} B params it would read "
          f"{100 * warm_tok_s * 6 * n_params / BF16_FLOPS:.1f} %, which no "
          f"token runs)")
    head = loss_head_ms(torch, eng, {"input_ids": ids}, MOE_MICRO, MOE_SEQ)
    print(f"  loss head alone: forward {head['fwd']:.1f} ms, forward + "
          f"backward {head['both']:.1f} ms = "
          f"{100 * head['both'] / warm_ms:.1f} % of the warm step")
    tck = TENSOR_CORE_KERNELS
    device_profile(torch, lambda: [eng.train_step(
        {"input_ids": ids, "moe_rng": 20 + i}) for i in range(2)],
        f"{label} training 2 steps",
        {"B1": (tck["flash_attention_fwd"],),
         "B3 + B4": (tck["flash_attention_bwd_dq"],
                     tck["flash_attention_bwd_dkv"])})
    del eng, metrics
    torch.cuda.empty_cache()

    # the same-state step check: kernels against plain attention, one
    # engine whose loss runs either model, both from each step's state
    # with the same routing seed
    small = {"input_ids": ids[:MOE_CHECK_MICRO]}
    models = {k: TransformerLM(model_cfg(k)) for k in ("flash", "xla")}
    impl = {"now": "flash"}
    _, e = make("flash", MOE_CHECK_MICRO,
                loss_fn=lambda p, b: models[impl["now"]].loss(p, b))
    for i in range(3):
        batch = {**small, "moe_rng": 100 + i}
        start = e.state
        impl["now"] = "xla"
        mx = e.train_step(batch)
        lx, gx = float(mx["loss"]), float(mx["grad_norm"])
        e.state, impl["now"] = start, "flash"
        mf = e.train_step(batch)
        lf, gf = float(mf["loss"]), float(mf["grad_norm"])
        del start, mx, mf
        print(f"  step {i} at micro {MOE_CHECK_MICRO}, both from one state "
              f"and routing seed: loss kernels {lf:.5f} plain {lx:.5f} "
              f"({abs(lf - lx) / abs(lx) / STEP_LOSS_REL_TOL:.3g} of the "
              f"limit); grad norm kernels {gf:.4f} plain {gx:.4f} "
              f"({abs(gf - gx) / abs(gx) / STEP_GNORM_REL_TOL:.3g} of the "
              f"limit)")
        check(abs(lf - lx) <= STEP_LOSS_REL_TOL * abs(lx),
              f"{label} step {i}: loss kernels {lf} vs plain {lx}")
        check(abs(gf - gx) <= STEP_GNORM_REL_TOL * abs(gx),
              f"{label} step {i}: grad norm kernels {gf} vs plain {gx}")
    del e, models
    torch.cuda.empty_cache()

    # remat none against full at step 1, one routing seed
    rec = {}
    for remat in ("none", "full"):
        _, e = make("flash", MOE_MICRO, remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = e.train_step({"input_ids": ids, "moe_rng": 0})
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        rec[remat] = (loss, gnorm, [(c.tolist(), int(k))
                                    for c, k, _ in e.model.moe_stats],
                      time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated() / 2**30)
        del e, m
        torch.cuda.empty_cache()
    (ln, gn, rn, sn, pn), (lf, gf, rf, sf, pf) = rec["none"], rec["full"]
    same = sum(a == b for a, b in zip(rn, rf))
    print(f"  remat none vs full at step 1 (seed 0): routing equal in "
          f"{same} of {len(rn)} MoE layers; loss {ln:.6f} / {lf:.6f}; grad "
          f"norm {gn:.5f} / {gf:.5f} ({abs(gf - gn) / abs(gn) / STEP_GNORM_REL_TOL:.3g}"
          f" of the limit); first step {sn:.2f} / {sf:.2f} s, peak "
          f"{pn:.1f} / {pf:.1f} GiB")
    check(rn == rf, f"{label}: remat none and full routed differently")
    check(abs(gf - gn) <= STEP_GNORM_REL_TOL * abs(gn),
          f"{label}: remat full grad norm {gf} vs none {gn}")
    return {name: counts[name] for name in per_step}


def diffusion_phase(torch, np) -> None:
    """Phase 23: ``init_diffusion`` with SD v1.x's configurations (random
    weights from seed 0, bf16, on the card): each component's parameter
    count exactly the published one; one UNet step (batch 2, 64x64
    latents, t 981) in bf16 against the same weights in float32 (TF32
    off), within ``DIFFUSION_EPS_REL_TOL`` of max|eps|; seconds per
    guided UNet step and its profile; the pipeline (20 DDIM steps,
    guidance 7.5, batch 1) to a finite 512x512 image in [0, 1] launching
    no attention kernel; seconds per image and the peak memory."""
    import gc
    from deepspeed_tpu_torch import init_diffusion
    from deepspeed_tpu_torch.models.diffusion import prepare
    from deepspeed_tpu_torch.ops import build
    label = "Stable Diffusion v1.x"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe, params = init_diffusion(dtype=torch.bfloat16)
    torch.cuda.synchronize()
    dev = pipe.device
    sizes = {k: sum(t.numel() for t in _leaves(v))
             for k, v in params.items()}
    print(f"{label} init: " + ", ".join(
        f"{k} {n / 1e6:.3f} M" for k, n in sizes.items())
        + f" params in bf16, in {time.perf_counter() - t0:.1f} s")
    check(sizes == SD_PARAMS, f"{label}: parameters {sizes}, want "
                              f"{SD_PARAMS}")
    rs = np.random.RandomState(0)
    prompt = np.concatenate([[[49406]], rs.randint(0, 49406, (1, 20)),
                             np.full((1, 56), 49407)], axis=1)
    uncond = np.concatenate([[[49406]], np.full((1, 76), 49407)], axis=1)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    lat = torch.randn((2, 64, 64, 4), generator=g, device=dev)
    tt = torch.full((2,), 981, dtype=torch.int32, device=dev)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        p32 = prepare(params, dev, torch.float32)
        ctx = pipe.encode_text(p32["text_encoder"], prompt, uncond)
        eps32 = pipe.unet.apply(p32["unet"], lat, tt, ctx)
        eps16 = pipe.unet.apply(params["unet"], lat.bfloat16(), tt,
                                ctx.bfloat16()).float()
        torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    err = float((eps16 - eps32).abs().max())
    rel = err / float(eps32.abs().max())
    l2 = float((eps16 - eps32).norm() / eps32.norm())
    check(bool(eps16.isfinite().all()) and tuple(eps16.shape) == (2, 64, 64, 4),
          f"{label}: UNet eps {tuple(eps16.shape)}")
    print(f"{label} UNet step (batch 2, 64x64 latents, t 981): bf16 eps "
          f"against float32 (TF32 off) max|err| {err:.4f} = {rel:.4f} of "
          f"max|eps| {float(eps32.abs().max()):.3f} (limit "
          f"{DIFFUSION_EPS_REL_TOL}), relative L2 {l2:.4f}")
    check(rel <= DIFFUSION_EPS_REL_TOL, f"{label}: bf16 UNet eps differs "
                                        f"from f32 by {rel:.4f} of max|eps|")
    del p32, eps32, eps16
    gc.collect()
    torch.cuda.empty_cache()

    with torch.inference_mode():
        ctx = pipe.encode_text(params["text_encoder"], prompt, uncond)
        lat1 = lat[:1].contiguous()

        def step():
            pipe.unet_step(params["unet"], lat1, 981, 931, ctx, SD_GUIDANCE)
        for _ in range(2):
            step()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(5):
            step()
        b.record()
        b.synchronize()
        step_ms = a.elapsed_time(b) / 5
    print(f"{label} guided UNet step (batch 2 through the UNet): "
          f"{step_ms:.1f} ms")
    device_profile(torch, lambda: torch.inference_mode()(step)(),
                   f"{label} one guided UNet step")
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = pipe(params, prompt, uncond, num_steps=SD_STEPS,
               guidance=SD_GUIDANCE, generator=g)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    check(tuple(img.shape) == (1, 512, 512, 3) and bool(img.isfinite().all())
          and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
          f"{label}: image {tuple(img.shape)} in "
          f"[{float(img.min())}, {float(img.max())}]")
    check(not any(counts.values()), f"{label}: the pipeline launched "
          f"{ {k: v for k, v in counts.items() if v} }")
    print(f"{label} pipeline: {SD_STEPS} DDIM steps, guidance {SD_GUIDANCE},"
          f" 512x512, batch 1: {image_s:.2f} s per image "
          f"({image_s / SD_STEPS * 1e3:.1f} ms a step with CLIP and the VAE "
          f"decode), image in [{float(img.min()):.3f}, "
          f"{float(img.max()):.3f}], mean {float(img.mean()):.3f}; no "
          f"kernel of the port launched (none lies on this path); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del pipe, params, img
    gc.collect()
    torch.cuda.empty_cache()


#: the phases ``--only`` runs after the build: "3" is phase 3's cases at
#: the MoE shapes (B1, B3, B4, B5, B6, B7)
# -- 24-25. the speculative lane, the front end and observability ----------
#: phase 24's spec depth: spec_k proposals, S = spec_k + 1 verify rows a slot
SPEC_K = 3


def _obs_config(block):
    from deepspeed_tpu_torch.runtime.config import ObservabilityConfig
    from deepspeed_tpu_torch.runtime.config_utils import from_dict
    return from_dict(ObservabilityConfig, block, "observability")


def overlap_split(torch):
    """The overlap profiler's records so far as (iterations, enqueue
    share, device-wait share, host-plan share) of their summed wall time,
    read from its Chrome events (its public export)."""
    from deepspeed_tpu_torch.observability import get_overlap_profiler
    its = [e for e in get_overlap_profiler().chrome_events(0, 0)
           if e["ph"] == "X"]
    wall = sum(e["dur"] for e in its) / 1e3 or 1.0
    return (len(its),
            sum(e["args"]["enqueue_ms"] for e in its) / wall,
            sum(e["args"]["device_wait_ms"] for e in its) / wall,
            sum(e["args"]["host_plan_ms"] for e in its) / wall)


def spec_drain(torch, srv, prompts, label):
    """Phase 5's requests (32 new tokens each) through ``srv``, every
    dispatch logged (which lanes it had, each speculating slot's output
    length before it, and the draft's proposals, kept on the card until
    the drain ends): every request OK with 32 tokens, the allocator
    empty, and B6/B7 launched exactly as the log says (target layers x
    (a decode lane + S x a spec lane) B6 and x a chunk B7; with a draft,
    its layers x (feed 0 + spec_k x a spec lane) B6 and x a chunk B7).
    Returns (requests, log, seconds, launch counts, peak bytes)."""
    from deepspeed_tpu_torch.observability import get_overlap_profiler
    from deepspeed_tpu_torch.ops import build
    log = []
    dispatch, propose = srv._dispatch, srv._draft_propose

    def proposing(*args):
        out = propose(*args)
        log[-1]["props"] = out
        return out

    def logged(dec, chunk, spec=()):
        log.append({"spec": [(slot, r, len(r.output)) for slot, r in spec]})
        out = dispatch(dec, chunk, spec)
        if out is None:
            log.pop()
        else:
            log[-1].update(dec=bool(dec), chunk=chunk is not None,
                           after=[len(r.output) for _, r in spec])
        return out
    srv._dispatch, srv._draft_propose = logged, proposing
    get_overlap_profiler().reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    srv._dispatch, srv._draft_propose = dispatch, propose
    for r in reqs:
        check(r.status is not None and r.status.value == "ok"
              and len(r.output) == 32,
              f"{label} {r.req_id}: status {r.status}, {len(r.output)} "
              f"tokens")
    check(srv.allocator.num_used == 0,
          f"{label}: allocator holds {srv.allocator.num_used} blocks after "
          f"drain")
    lt, S = srv.model.config.num_layers, SPEC_K + 1
    draft_layers = (srv._draft_model.config.num_layers
                    if srv._draft_model is not None else 0)
    n_dec = sum(e["dec"] for e in log)
    n_spec = sum(bool(e["spec"]) for e in log)
    n_any = sum(e["dec"] or bool(e["spec"]) for e in log)
    n_chunk = sum(e["chunk"] for e in log)
    want6 = lt * (n_dec + S * n_spec) + draft_layers * (
        n_any + SPEC_K * n_spec if draft_layers else 0)
    want7 = (lt + draft_layers) * n_chunk
    check(counts["paged_decode_attention"] == want6
          and counts["paged_prefill_attention"] == want7,
          f"{label}: B6 {counts['paged_decode_attention']} (want {want6}), "
          f"B7 {counts['paged_prefill_attention']} (want {want7}) over "
          f"{len(log)} dispatches ({n_dec} decode lanes, {n_spec} spec "
          f"lanes, {n_chunk} chunks)")
    return reqs, log, wall, counts, peak


def rejections(log):
    """(request, output index, rejected proposal, the target's token
    there) for every rejected proposal in ``log``: a speculating slot
    that emitted n < S tokens without finishing had d_n != s_{n-1}."""
    out = []
    for e in log:
        if not e["spec"]:
            continue
        props = e["props"].cpu().tolist()
        for (slot, r, before), after in zip(e["spec"], e["after"]):
            n = after - before
            if n <= 0 or n >= SPEC_K + 1 or after >= r.max_new_tokens:
                continue
            out.append((r, before + n - 1, props[slot][n],
                        r.output[before + n - 1]))
    return out


def b6_spec_timing(torch, srv, capture, flush):
    """B6 at the spec lane's depth 4 (lengths ``lens + 4`` of the
    dispatch of phase 24 (b) with the most speculating slots, on layer
    0's pool) against its plain version: device ms each, the bound (the
    rows read once and q / out, or the products), max |err|."""
    from deepspeed_tpu_torch.ops.transformer import (
        paged_decode_attention as PA)
    tables, lens, sact = capture["tables"], capture["lens"], capture["sact"]
    c = srv.model.config
    dev = tables.device
    g = torch.Generator(device=dev)
    g.manual_seed(24)
    pk, pv = srv._pool_k[0], srv._pool_v[0]
    q = torch.randn((tables.shape[0], c.num_heads, c.hdim), generator=g,
                    device=dev).to(pk.dtype)
    ln = torch.where(sact > 0, lens + SPEC_K + 1, torch.zeros_like(lens))
    got = PA.paged_decode_attention(q, pk, pv, ln, tables)
    want = PA.paged_decode_attention_plain(q, pk, pv, ln, tables)
    ms = time_ms(lambda: PA.paged_decode_attention(q, pk, pv, ln, tables),
                 torch, flush)
    plain_ms = time_ms(
        lambda: PA.paged_decode_attention_plain(q, pk, pv, ln, tables),
        torch, flush, n_timed=N_TIMED_PLAIN, n_warm=1)
    rows = int(ln.sum())
    nbytes = (2 * rows * c.kv_heads * c.hdim + 2 * int((sact > 0).sum())
              * c.num_heads * c.hdim) * pk.element_size()
    flops = 4 * rows * c.num_heads * c.hdim
    bound, by = bound_ms(nbytes, flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=max_err(got, want),
                limit_share=margin(got, want), slots=int((sact > 0).sum()),
                rows=rows)


def spec_phase(torch, np, eng, label) -> dict:
    """Phase 24: phase 5's 16 requests (prompts 16-512, 32 new tokens,
    greedy) on phase 5's GPT-3 6.7B engine (bf16, phase 5's ``SERVING``,
    spec_k 3) three ways: (a) no draft, (b) the GPT-3 Small draft (12
    layers, d_model 768, 12 heads of 64, vocab 50257; an untrained draft
    from seed 1), (c) the target as its own draft (its module and params,
    no copy).  Streams of (b) and (c) equal (a)'s up to the first near
    tie, every proposal (c) rejects at a near tie, B6/B7 launches exact
    against the dispatch log, the pool empty after each drain; prints
    tokens/s, iterations, acceptance, peak memory and the overlap
    profiler's enqueue and device-wait shares; times B6 at depth 4."""
    import dataclasses
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.observability import configure
    cfg = eng.module.config
    check(eng.config.serving.spec_k == SPEC_K,
          f"phase 5's serving block has spec_k {eng.config.serving.spec_k}")
    _, _, lens, prompts = serving_prompts(np, cfg.vocab_size)
    configure(_obs_config({"overlap": {"enabled": True}}))
    draft = TransformerLM(gpt2_config("125m", vocab_size=cfg.vocab_size))
    runs, out = {}, {}
    capture = {}
    for way, make in (
            ("a", lambda: ServingEngine(eng)),
            ("b", lambda: ServingEngine(eng, draft_model=draft)),
            ("c", lambda: ServingEngine(eng, draft_model=eng.module,
                                        draft_params=eng.params))):
        srv = make()
        if way == "b":
            mixed = srv.model._apply_paged_mixed

            def capturing(*args, **kw):
                sa = kw.get("spec_active")
                if sa is not None and int(sa.sum()) > capture.get("n", 0):
                    capture.update(n=int(sa.sum()), sact=sa.clone(),
                                   tables=args[1]["block_tables"].clone(),
                                   lens=args[1]["lens"].clone())
                return mixed(*args, **kw)
            srv.model._apply_paged_mixed = capturing
        reqs, log, wall, counts, peak = spec_drain(
            torch, srv, prompts, f"{label} spec ({way})")
        if way == "b":
            del srv.model._apply_paged_mixed
            flush = torch.empty(128 * 2**20, dtype=torch.uint8,
                                device="cuda")
            out["b6_spec"] = b6_spec_timing(torch, srv, capture, flush)
            del flush
        iters, enq, wait, plan = overlap_split(torch)
        sc = dict(srv.spec_counts)
        ntok = sum(len(r.output) for r in reqs)
        rate = sc["accepted"] / max(sc["proposed"], 1)
        runs[way] = dict(reqs=reqs, log=log, sc=sc)
        out[way] = dict(tok_s=ntok / wall, iters=iters, dispatches=len(log),
                        rate=rate, peak=peak, enq=enq, wait=wait,
                        b6=counts["paged_decode_attention"],
                        b7=counts["paged_prefill_attention"])
        print(f"{label} spec ({way}{', GPT-3 Small draft' if way == 'b' else ', self-draft' if way == 'c' else ', no draft'}): "
              f"{ntok} tokens in {wall:.2f} s = {ntok / wall:.1f} tokens/s, "
              f"{iters} iterations, {len(log)} dispatches; proposed "
              f"{sc['proposed']}, accepted {sc['accepted']} (rate "
              f"{rate:.4f}); peak {peak / 1e9:.2f} GB; overlap: enqueue "
              f"{100 * enq:.1f} %, device wait {100 * wait:.1f} %, host plan "
              f"{100 * plan:.1f} % of {iters} iterations' wall time; B6 "
              f"{counts['paged_decode_attention']}, B7 "
              f"{counts['paged_prefill_attention']} launches, exact")
        if way == "c":
            rej = rejections(log)
            for r, pos, d, s in rej:
                lg = prefill_logits(eng, list(r.prompt) + r.output[:pos])
                gap = float(lg[s] - lg[d]) / float(lg.abs().max())
                print(f"  (c) {r.req_id} rejects {d} for {s} at output "
                      f"{pos}: the target's gap {gap!r} of max|logit|")
                check(gap <= 2 * LOGITS_REL_TOL,
                      f"{label} self-draft rejects at output {pos} of "
                      f"{r.req_id} where the gap is {gap:.4f}, not a near "
                      f"tie")
            out["c"]["rejected"] = len(rej)
            print(f"  (c): {len(rej)} rejected proposals, each at a near "
                  f"tie (gap within {2 * LOGITS_REL_TOL} of max|logit|)")
        del srv
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    refs = [r.output for r in runs["a"]["reqs"]]
    for way in ("b", "c"):
        same = sum(r.output == ref for r, ref in zip(runs[way]["reqs"],
                                                      refs))
        print(f"{label} spec ({way}) streams equal to (a): {same} of 16")
        for req_id, pos, gap in divergence_gaps(np, eng, runs[way]["reqs"],
                                                refs):
            print(f"  ({way}) {req_id} parts from (a) at token {pos}: gap "
                  f"{gap!r} of max|logit|")
            check(gap <= 2 * LOGITS_REL_TOL,
                  f"{label} spec ({way}): {req_id} parts from (a) at "
                  f"{pos} where the gap is {gap:.4f}, not a near tie")
    b6 = out["b6_spec"]
    print(f"kernel paged_decode_attention [spec depth {SPEC_K + 1}, "
          f"{b6['slots']} of 8 slots, {b6['rows']} rows]: max|err| "
          f"{b6['max_abs_err']:.3g} = {b6['limit_share']:.3g} of the limit; "
          f"{b6['ms']:.4f} ms, plain "
          f"{b6['plain_ms']:.4f} ms, library - ms, bound "
          f"{b6['bound_ms']:.4f} ms ({b6['bound_by']}); launches in (b)'s "
          f"drain {out['b']['b6']}, (c)'s {out['c']['b6']}")
    check(b6["limit_share"] <= 1.0,
          f"B6 at spec depth {SPEC_K + 1}: max|err| {b6['max_abs_err']} "
          f"({b6['limit_share']:.3g} of the limit)")
    configure(None)
    return out


#: phase 25's tenants (bench_all.py multi_tenant_replay_bench)
TENANTS = (("interactive", dict(weight=4.0, ttft_slo_s=0.5)),
           ("standard", dict(weight=1.0)),
           ("batch", dict(weight=1.0, max_queue_share=0.5, ttft_slo_s=0.3)))


def frontend_phase(torch, np, eng, label) -> dict:
    """Phase 25: ``bench_all.py``'s multi-tenant replay on phase 5's GPT-3
    6.7B engine with the GPT-3 Small draft at spec_k 1 (4 slots,
    max_queue_depth 6, 60 rounds, 16 new tokens; interactive sampled at
    temperature 0.7, top-k 16, seeded; two batch bursts of 5), its
    ``SloMonitor`` windows, tracing, metrics, request tracing, overlap and
    the flight recorder on into a temporary directory and
    ``DSTPU_HEARTBEAT_FILE`` set: every delivered stream in order and
    exactly once, the trace holding the serving spans and per-request
    tracks, the textfile every ported ``dstpu_serving_*`` series, the
    heartbeat stamped.  Then phase 5's drain with observability on and
    off: equal greedy streams, tokens/s of both."""
    import copy
    import dataclasses
    import os
    import tempfile
    from deepspeed_tpu_torch.inference.serving import (ServingFrontend,
                                                       SloMonitor,
                                                       StreamCollector,
                                                       TenantSpec)
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.observability import (configure, flush_all,
                                                   get_registry)
    cfg = eng.module.config
    tmp = tempfile.mkdtemp(prefix="dstpu_obs_")
    hb = os.path.join(tmp, "serving.hb")
    os.environ["DSTPU_HEARTBEAT_FILE"] = hb
    configure(_obs_config({
        "tracing": {"enabled": True, "output_dir": tmp},
        "request_tracing": {"enabled": True},
        "metrics": {"enabled": True, "prometheus_dir": tmp},
        "overlap": {"enabled": True},
        "flight": {"enabled": True, "output_dir": tmp}}))
    fe_eng = copy.copy(eng)
    fe_eng.config = dataclasses.replace(eng.config, serving=dataclasses.replace(
        eng.config.serving, max_batch_slots=4, max_queue_depth=6, spec_k=1))
    fe_eng._serving = None
    draft = TransformerLM(gpt2_config("125m", vocab_size=cfg.vocab_size))
    srv = ServingEngine(fe_eng, draft_model=draft)
    slo = SloMonitor(objective=0.9, fast_window_s=2.0, slow_window_s=8.0,
                     burn_threshold=1.0, min_samples=3)
    alerts = []
    slo.subscribe(lambda a: alerts.append(a))
    fe = ServingFrontend(srv, slo=slo)
    for name, kw in TENANTS:
        fe.register(TenantSpec(name, **kw))
    tenants = [n for n, _ in TENANTS]
    ttft = {t: [] for t in tenants}
    itl = {t: [] for t in tenants}

    def hook(ev):
        if ev.token is None or ev.tenant not in ttft:
            return
        if ev.index == 0:
            ttft[ev.tenant].append(ev.time_s - ev.request.submit_time)
        elif ev.prev_time_s is not None:
            itl[ev.tenant].append(ev.time_s - ev.prev_time_s)
    srv.token_hooks.append(hook)
    fe.submit([1, 2, 3], max_new_tokens=4)      # warm the path
    srv.run()
    rs = np.random.RandomState(7)
    reqs = {t: [] for t in tenants}
    pairs = []

    def sub(tenant, plen, **kw):
        col = StreamCollector()
        p = rs.randint(0, cfg.vocab_size, (plen,)).tolist()
        req = fe.submit(p, tenant=tenant, max_new_tokens=16, on_token=col,
                        **kw)
        reqs[tenant].append(req)
        pairs.append((req, col))
    t0 = time.perf_counter()
    rounds = 60
    for r in range(rounds):
        if r % 3 == 0:
            sub("interactive", int(rs.randint(4, 9)), temperature=0.7,
                top_k=16, seed=100 + r)
        if r % 5 == 0:
            sub("standard", int(rs.randint(10, 14)))
        if r in (2, rounds // 2):
            for _ in range(5):
                sub("batch", int(rs.randint(20, 25)))
        srv.step()
    srv.run()
    wall = time.perf_counter() - t0
    quiet = time.perf_counter() + 2.5 * slo.fast_window_s
    while (any(v["state"] == "firing" for v in slo.snapshot().values())
           and time.perf_counter() < quiet):
        time.sleep(0.1)
        slo.evaluate()
    every = [r for r, _ in pairs]
    for r, col in pairs:
        check(col.finished and col.tokens == r.output
              and [e.index for e in col.events if e.token is not None]
              == list(range(len(r.output))),
              f"{label} front end: {r.req_id}'s stream is not its output "
              f"in order, exactly once")
    paths = flush_all()
    events = json.load(open(paths[0]))["traceEvents"]
    names = {e["name"] for e in events}
    for span in ("serving/decode", "serving/spec_decode",
                 "serving/prefill_chunk"):
        check(span in names, f"{label} front end: no {span} span in the "
                             f"trace")
    tracks = [e for e in events if e.get("name") == "thread_name"
              and 1000 <= e["pid"] < 2000]
    check(len(tracks) >= len(every),
          f"{label} front end: {len(tracks)} request tracks for "
          f"{len(every)} requests")
    prom = open(paths[1]).read()
    missing = [s for s in SERVING_SERIES if f"dstpu_serving_{s}" not in prom]
    check(not missing, f"{label} front end: the textfile lacks {missing}")
    check(os.path.exists(hb), f"{label}: heartbeat file {hb} not stamped")
    sc = srv.spec_counts
    ntok = sum(len(r.output) for r in every)
    print(f"{label} front end (spec_k 1, GPT-3 Small draft): {len(every)} "
          f"requests over {rounds} rounds, {ntok} tokens in {wall:.2f} s = "
          f"{ntok / wall:.1f} tokens/s; acceptance {sc['accepted']}/"
          f"{sc['proposed']}; trace {len(events)} events ({len(tracks)} "
          f"request tracks), textfile {len(prom.splitlines())} lines, "
          f"heartbeat stamped")
    for t in tenants:
        rs_t = reqs[t]
        pct = lambda xs, q: (f"{1e3 * float(np.percentile(xs, q)):.1f}"
                             if xs else "-")
        shed = sum(r.status.value == "shed" for r in rs_t)
        timed = sum(r.status.value == "timed_out" for r in rs_t)
        fired = sum(a.state == "firing" and a.tenant == t for a in alerts)
        resolved = sum(a.state == "resolved" and a.tenant == t
                       for a in alerts)
        print(f"  {t}: {len(rs_t)} requests, TTFT p50/p99 {pct(ttft[t], 50)}"
              f"/{pct(ttft[t], 99)} ms, ITL p50/p99 {pct(itl[t], 50)}/"
              f"{pct(itl[t], 99)} ms, shed {shed / max(len(rs_t), 1):.3f}, "
              f"timed out {timed / max(len(rs_t), 1):.3f}, alerts fired "
              f"{fired}, resolved {resolved}")
    iters, enq, wait, plan = overlap_split(torch)
    print(f"  overlap over {iters} iterations: enqueue {100 * enq:.1f} %, "
          f"device wait {100 * wait:.1f} %, host plan {100 * plan:.1f} %")
    result = {"tok_s": ntok / wall, "requests": len(every)}
    del srv, fe
    # observability on and off over phase 5's drain: the same streams
    _, _, _, prompts = serving_prompts(np, cfg.vocab_size)
    streams, rates = {}, {}
    for on in (True, False):
        if not on:
            configure(None)
        s2 = ServingEngine(eng)
        t0 = time.perf_counter()
        rr = [s2.submit(p, max_new_tokens=32) for p in prompts]
        s2.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        streams[on] = [r.output for r in rr]
        rates[on] = sum(len(r.output) for r in rr) / wall
        del s2
    check(streams[True] == streams[False],
          f"{label}: observability changed the greedy streams")
    print(f"{label} drain with observability on: {rates[True]:.1f} tokens/s,"
          f" off: {rates[False]:.1f} tokens/s; the 16 greedy streams equal")
    os.environ.pop("DSTPU_HEARTBEAT_FILE", None)
    get_registry().reset()
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return result


# -- 27. the replica fleet ------------------------------------------------------
#: phase 27's shared-prefix requests: FLEET_SHARED requests over one
#: FLEET_PREFIX-token prefix
FLEET_PREFIX, FLEET_SHARED = 512, 8


def fleet_prompts(np, vocab):
    """Phase 5's 16 request prompts and phase 27's 8 over one shared
    512-token prefix (tails of 8-63 tokens, seed 27)."""
    _, _, _, base = serving_prompts(np, vocab)
    rng = np.random.default_rng(27)
    prefix = rng.integers(0, vocab, FLEET_PREFIX).tolist()
    return base, [prefix + rng.integers(0, vocab, int(n)).tolist()
                  for n in rng.integers(8, 64, FLEET_SHARED)]


def fleet_run(torch, np, eng, label, base, shared, fleet_kw, kill=False,
              plan=None, threaded=False) -> dict:
    """One pumped fleet (``router.pump()`` until no replica has work) over
    ``eng``'s weights and one host tier at wire 0: phase 5's requests, the
    first shared-prefix request, then (once its first token is out, so its
    prefix is registered) the other shared-prefix requests, 32 new tokens
    each.  Every stream is checked delivered exactly once, in order.
    ``kill`` arms a fatal ``serving.fleet.replica_step`` plan for r1 once
    it streams and a quarter of the tokens are out; a replay that parts
    from the delivered stream raises ``StreamReplayError`` in the router
    and is logged (request, index, delivered token, replayed token).
    ``plan`` (site, kind, at, count) is installed for the whole run.
    B6/B7 launches, summed over the replicas, are checked against the
    dispatch log, but for ``threaded`` replicas (``ReplicaHandle.start()``:
    each steps on its own thread, the pump only sweeps health and places;
    the launch counters are plain ints bumped from both threads)."""
    import gc
    from deepspeed_tpu_torch.inference.serving import (FleetRouter,
                                                       ReplicaState,
                                                       StreamCollector,
                                                       StreamDeduper,
                                                       host_block_bytes)
    from deepspeed_tpu_torch.inference.serving.frontend.streaming import \
        StreamReplayError
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.runtime.resilience import (
        FaultInjector, install_fault_injector)
    c = eng.module.config
    bs = eng.config.serving.kv_block_size
    raw = host_block_bytes(c.num_layers, bs, c.kv_heads, c.hdim, 0, 0)
    fe = serving_copy(eng, fleet={"enabled": True, **fleet_kw},
                      host_cache={"enabled": True, "wire_bits": 0,
                                  "dram_budget_bytes": FLEET_ENTRIES * raw})
    check(FLEET_ENTRIES * raw <= 6 * 2**30, "phase 27 budget over 6 GiB")
    fleet = FleetRouter.from_engine(fe)
    hc = fleet.shared_host_cache
    # fabric entries a device hit makes redundant (dropped, not claimed)
    dropped = [0]

    def discard(digest, real=hc.discard):
        gone = real(digest)
        dropped[0] += int(gone)
        return gone
    hc.discard = discard
    fi = install_fault_injector(FaultInjector())
    if plan is not None:
        fi.add_plan(plan[0], plan[1], at=plan[2], count=plan[3])
    partings, chunks = [], []

    class Parting(StreamDeduper):
        def admit(self, ev):
            try:
                return super().admit(ev)
            except StreamReplayError:
                partings.append((self.freq, ev.index,
                                 self.delivered[ev.index], ev.token))
                raise
    for r in fleet.replicas:
        if threaded:
            break

        def logged(dec, chunk, spec=(), real=r.srv._dispatch,
                   rid=r.replica_id):
            out = real(dec, chunk, spec)
            if out is not None and chunk is not None:
                chunks.append((rid, tuple(chunk[1].prompt), chunk[2],
                               chunk[3]))
            return out
        r.srv._dispatch = logged
    model = eng.module
    mixed = model._apply_paged_mixed
    lanes = {"decode": 0, "chunk": 0}

    def counted(params, cache, dec_tokens, dec_active, chunk_ids, *rest,
                **kw):
        lanes["decode"] += int(dec_tokens.shape[0] > 0)
        lanes["chunk"] += int(chunk_ids.shape[0] > 0)
        return mixed(params, cache, dec_tokens, dec_active, chunk_ids,
                     *rest, **kw)
    if not threaded:
        model._apply_paged_mixed = counted
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if threaded:
        for r in fleet.replicas:
            r.start()
    reqs, cols = [], []

    def sub(prompt):
        col = StreamCollector()
        f = fleet.submit(prompt, max_new_tokens=32, on_token=col)
        f.deduper = Parting()
        f.deduper.freq = f
        reqs.append(f)
        cols.append(col)
        return f

    def pump_until(cond, what):
        deadline = time.perf_counter() + 600
        while time.perf_counter() < deadline:
            if cond():
                return
            fleet.pump()
            if threaded:
                time.sleep(0.001)
        fail(f"{label}: {what} never happened")
    for p in base:
        sub(p)
    first = sub(shared[0])
    pump_until(lambda: first.deduper.high_water > 0 or first.done,
               "the first shared-prefix token")
    warm = first.replica
    placed = [sub(p).replica for p in shared[1:]]
    total = 32 * len(reqs)
    killed = None
    if kill:
        r1 = fleet.replica("r1")
        pump_until(lambda: sum(f.deduper.high_water for f in reqs)
                   >= total // 4 and any(f.replica is r1 and f.status is None
                                         and f.deduper.high_water
                                         for f in reqs),
                   "r1 streaming with a quarter of the tokens out")
        stepping = [r for r in fleet.replicas
                    if r.state in (ReplicaState.HEALTHY,
                                   ReplicaState.DRAINING)]
        killed = [f for f in reqs if f.replica is r1 and f.status is None]
        fi.add_plan("serving.fleet.replica_step", "fatal",
                    at=fi.calls.get("serving.fleet.replica_step", 0)
                    + stepping.index(r1) + 1)
    pump_until(lambda: not fleet.has_work or not (
        fleet._pending or any(r.has_work() for r in fleet.replicas
                              if r.alive)), "the drain")
    if threaded:
        for r in fleet.replicas:
            r.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    model._apply_paged_mixed = mixed
    fires = {site: fi.fire_count(site) for site in ("serving.fleet.route",
                                                    "serving.fleet.replica_step")}
    install_fault_injector(FaultInjector())
    parted = {id(f) for f, *_ in partings}
    for f, col in zip(reqs, cols):
        toks = [e for e in col.events if e.token is not None]
        check(col.tokens == f.output
              and [e.index for e in toks] == list(range(len(f.output))),
              f"{label}: {f.req_id}'s stream is not delivered exactly once, "
              f"in order")
        if id(f) not in parted:
            check(f.status is not None and f.status.value == "ok"
                  and len(f.output) == 32 and col.finished,
                  f"{label}: {f.req_id} status {f.status}, "
                  f"{len(f.output)} tokens")
    layers = c.num_layers
    check(threaded or (
          counts["paged_decode_attention"] == layers * lanes["decode"]
          and counts["paged_prefill_attention"] == layers * lanes["chunk"]),
          f"{label}: B6 {counts['paged_decode_attention']} (want {layers} x "
          f"{lanes['decode']}), B7 {counts['paged_prefill_attention']} "
          f"(want {layers} x {lanes['chunk']})")
    live = [r for r in fleet.replicas if r.state is not ReplicaState.DEAD]
    device = set()
    for r in live:
        r.srv.allocator.assert_consistent()
        check(r.srv.allocator.num_used == 0,
              f"{label}: {r.replica_id} holds {r.srv.allocator.num_used} "
              f"blocks after the drain")
        device |= set(r.srv.allocator._hash_to_block)
    # what the phase reads of its requests' replicas, kept as ids: a fleet
    # request refers to its replica, and so to its pool, until cut loose
    rids = [f.replica.replica_id if f.replica is not None else None
            for f in reqs]
    out = {"reqs": reqs, "rids": rids, "wall": wall, "lanes": dict(lanes),
           "tokens": sum(len(f.output) for f in reqs),
           "counts": dict(fleet.fleet_counts), "partings": partings,
           "killed": killed, "fires": fires, "chunks": chunks,
           "placed": [r.replica_id if r is not None else None
                      for r in placed],
           "warm": warm.replica_id if warm is not None else None,
           "replicas": {r.replica_id: (r.role, r.state.value,
                                       dict(r.srv.host_counts),
                                       dict(r.srv.fabric_counts),
                                       r.srv.counts["prefill_tokens"])
                        for r in fleet.replicas},
           "orphans": fleet.reap_orphans(),
           "published": hc.published_total, "dropped": dropped[0]}
    hc.assert_consistent(device_digests=device)
    hc.close()
    for f in reqs:
        f.replica = f.engine_req = None
    del fleet, fe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fleet_phase(torch, np, eng, label) -> dict:
    """Phase 27: the replica fleet on phase 5's GPT-3 6.7B engine and
    weights, pumped (``router.pump()``), each replica with phase 5's pool,
    all sharing one host tier at wire 0: (a) a uniform fleet of 2 over
    phase 5's 16 requests and 8 over a shared 512-token prefix, every
    stream exactly once and equal to one ``ServingEngine``'s (run in the
    same call) up to a near tie, the later shared-prefix requests placed
    on the replica that computed the prefix, B6/B7 exact against the
    dispatch logs, tokens/s beside the single engine's; (b) (a) again
    with a fatal ``serving.fleet.replica_step`` plan killing r1 mid-drain:
    every stream exactly once, the replayed tokens counted, every replay
    that parts from the delivered stream (``StreamReplayError``) at a near
    tie of ``generate()``'s logits there; (c) disaggregated
    (``prefill_replicas`` 1 of 2) over the shared tier: streams equal
    (a)'s up to a near tie, the fabric's published blocks equal to the
    decode replica's promoted ones, every handed-off request's prefill on
    the decode replica its tail alone, no orphan after the drain; (d) a
    transient ``serving.fleet.route`` plan (two placements degrade to
    queue depth): every stream exactly once, equal to (a)'s up to a near
    tie; (e) (a) with each replica on its own thread
    (``ReplicaHandle.start()``): every stream exactly once, equal to (a)'s
    up to a near tie, no launch-count check."""
    import gc
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
    torch.cuda.reset_peak_memory_stats()
    c = eng.module.config
    bs = eng.config.serving.kv_block_size
    base, shared = fleet_prompts(np, c.vocab_size)
    single = ServingEngine(serving_copy(eng))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sreqs = [single.submit(p, max_new_tokens=32) for p in base + shared]
    single.run()
    torch.cuda.synchronize()
    s_wall = time.perf_counter() - t0
    refs = [r.output for r in sreqs]
    s_tok = sum(len(r) for r in refs)
    del single
    gc.collect()
    torch.cuda.empty_cache()
    uniform = {"replicas": 2}
    runs = {"a": fleet_run(torch, np, eng, f"{label} fleet (a)", base,
                           shared, uniform),
            "b": fleet_run(torch, np, eng, f"{label} fleet (b) failover",
                           base, shared, uniform, kill=True),
            "c": fleet_run(torch, np, eng, f"{label} fleet (c) disaggregated",
                           base, shared, {"replicas": 2,
                                          "prefill_replicas": 1}),
            "d": fleet_run(torch, np, eng, f"{label} fleet (d) route plan",
                           base, shared, uniform,
                           plan=("serving.fleet.route", "fail", 2, 2)),
            "e": fleet_run(torch, np, eng, f"{label} fleet (e) threaded",
                           base, shared, uniform, threaded=True)}
    a = runs["a"]
    parted = near_tie_partings(np, eng, a["reqs"], refs, f"{label} fleet (a)")
    check(a["placed"] == [a["warm"]] * (FLEET_SHARED - 1),
          f"{label} fleet (a): the later shared-prefix requests went to "
          f"{a['placed']}, not the warm replica {a['warm']}")
    place = {}
    for rid in a["rids"]:
        place[rid] = place.get(rid, 0) + 1
    print(f"{label} fleet (a): 2 replicas, {len(a['reqs'])} requests, "
          f"{a['tokens']} tokens in {a['wall']:.2f} s = "
          f"{a['tokens'] / a['wall']:.1f} tokens/s (one ServingEngine in the "
          f"same call: {s_tok / s_wall:.1f} tokens/s); placements {place}; "
          f"the {FLEET_SHARED - 1} later shared-prefix requests on the warm "
          f"replica {a['warm']}: {a['placed']}; {parted} of "
          f"{len(refs)} streams part from the single engine's at a near "
          f"tie; B6/B7 over {a['lanes']['decode']} decode lanes and "
          f"{a['lanes']['chunk']} chunks")
    a_refs = [f.output for f in a["reqs"]]
    b = runs["b"]
    check(b["counts"]["dead_replicas"] == 1 and b["fires"][
        "serving.fleet.replica_step"] == 1 and b["killed"],
          f"{label} fleet (b): the kill did not land mid-drain "
          f"({b['counts']}, {b['fires']})")
    for f, index, delivered, replay in b["partings"]:
        lg = prefill_logits(eng, list(f.prompt) + f.output[:index])
        gap = abs(float(lg[delivered] - lg[replay])) / float(lg.abs().max())
        print(f"  {label} fleet (b): {f.req_id}'s replay parts at token "
              f"{index} (delivered {delivered}, replay {replay}): logit gap "
              f"{gap!r} of max|logit| (limit {2 * LOGITS_REL_TOL})")
        check(gap <= 2 * LOGITS_REL_TOL,
              f"{label} fleet (b): {f.req_id}'s replay parts at token "
              f"{index} where the gap is {gap:.4f}, not a near tie")
    done_b = [f for f in b["reqs"] if f not in {p[0] for p in b["partings"]}]
    near_tie_partings(np, eng, done_b,
                      [r for f, r in zip(b["reqs"], refs) if f in done_b],
                      f"{label} fleet (b)")
    print(f"{label} fleet (b): r1 killed with {len(b['killed'])} requests in "
          f"flight; {b['counts']['failovers']} failovers, "
          f"{b['counts']['replayed_tokens']} replayed tokens dropped at the "
          f"high-water mark, {len(b['partings'])} of "
          f"{len(b['killed'])} replays parted; {b['tokens']} tokens in "
          f"{b['wall']:.2f} s")
    cr = runs["c"]
    p0, d0 = cr["replicas"]["p0"], cr["replicas"]["d0"]
    # every entry the fabric took in was promoted on d0 or, published
    # again for a chain d0 already held, dropped as redundant: none is
    # left for the orphan sweep
    check(cr["counts"]["handoffs"] > 0 and d0[2]["promoted_blocks"] > 0
          and cr["published"] == d0[2]["promoted_blocks"] + cr["dropped"]
          and cr["orphans"] == 0,
          f"{label} fleet (c): {cr['counts']['handoffs']} handoffs, "
          f"{cr['published']} entries published, {d0[2]['promoted_blocks']}"
          f" promoted, {cr['dropped']} dropped as redundant, orphans "
          f"{cr['orphans']}")
    starts = {}
    for rid, prompt, start, n in cr["chunks"]:
        if rid == "d0":
            starts.setdefault(prompt, start)
    for f in cr["reqs"]:
        if not f.prefill_done:
            continue
        start = starts.get(tuple(f.prompt))
        want = (len(f.prompt) - 1) // bs * bs
        check(start == want, f"{label} fleet (c): {f.req_id}'s prefill on "
              f"d0 starts at {start}, not at its tail {want}")
    parted_c = near_tie_partings(np, eng, cr["reqs"], a_refs,
                                 f"{label} fleet (c)")
    print(f"{label} fleet (c): p0 prefill, d0 decode: "
          f"{cr['counts']['handoffs']} handoffs; p0 published "
          f"{p0[3]['published_blocks']} blocks, {cr['published']} entries "
          f"into the fabric = {d0[2]['promoted_blocks']} promoted on d0 + "
          f"{cr['dropped']} dropped there as redundant (a shared prefix "
          f"published again once d0 held it); d0 computed "
          f"{d0[4]} prompt tokens (every handed-off request's tail alone) "
          f"of {sum(len(p) for p in base + shared)}; orphans after the "
          f"drain {cr['orphans']}; {parted_c} streams part from (a)'s at a "
          f"near tie; {cr['tokens']} tokens in {cr['wall']:.2f} s = "
          f"{cr['tokens'] / cr['wall']:.1f} tokens/s")
    d = runs["d"]
    check(d["fires"]["serving.fleet.route"] == 2,
          f"{label} fleet (d): the route plan fired "
          f"{d['fires']['serving.fleet.route']} times")
    parted_d = near_tie_partings(np, eng, d["reqs"], a_refs,
                                 f"{label} fleet (d)")
    print(f"{label} fleet (d): a transient serving.fleet.route plan fired "
          f"twice (two placements by queue depth alone); every stream "
          f"exactly once, {parted_d} part from (a)'s at a near tie")
    th = runs["e"]
    parted_e = near_tie_partings(np, eng, th["reqs"], a_refs,
                                 f"{label} fleet (e)")
    print(f"{label} fleet (e): the replicas on their own threads "
          f"(ReplicaHandle.start()): every stream exactly once, {parted_e} "
          f"part from (a)'s at a near tie; {th['tokens']} tokens in "
          f"{th['wall']:.2f} s = {th['tokens'] / th['wall']:.1f} tokens/s "
          f"(launch counts not checked: both threads bump them)")
    peak_memory(torch, f"{label} fleet")
    return {"tok_s": a["tokens"] / a["wall"], "single_tok_s": s_tok / s_wall,
            "replays_parted": len(b["partings"]),
            "replayed_tokens": b["counts"]["replayed_tokens"]}


#: every dstpu_serving_* series of the port (not the serving mesh's)
SERVING_SERIES = (
    "queue_depth", "active_slots", "kv_blocks_in_use", "cached_kv_blocks",
    "kv_pool_bytes", "kv_bits", "ttft_seconds", "inter_token_seconds",
    "tokens_total", "preemptions_total", "prefix_cache_hit_tokens_total",
    "prefill_tokens_total", "prefix_cache_evictions_total",
    "cancelled_total", "timed_out_total", "shed_total", "failed_total",
    "quarantined_total", "spec_proposed_tokens_total",
    "spec_accepted_tokens_total", "spec_k", "host_plan_seconds",
    "device_wait_seconds", "overlap_frac_dist", "host_spills_total",
    "host_dram_hits_total", "host_nvme_hits_total", "host_demotions_total",
    "host_evictions_total", "host_hit_tokens_total",
    "promoted_blocks_total", "promote_failures_total",
    "spill_failures_total", "fabric_published_total",
    "fabric_publish_failures_total", "host_dram_bytes", "host_nvme_bytes",
    "promote_queue_depth")


def spec_front_phases(torch, np, eng, elapsed) -> dict:
    """Phases 24-27 on phase 5's GPT-3 6.7B engine."""
    spec = spec_phase(torch, np, eng, "GPT-3 6.7B")
    elapsed("phase 24")
    front = frontend_phase(torch, np, eng, "GPT-3 6.7B")
    elapsed("phase 25")
    host = host_cache_phase(torch, np, eng, "GPT-3 6.7B")
    elapsed("phase 26")
    fleet = fleet_phase(torch, np, eng, "GPT-3 6.7B")
    elapsed("phase 27")
    return {"spec": spec, "front": front, "host": host, "fleet": fleet}


# -- 26. the tiered host KV cache ---------------------------------------------
#: phase 26's shared prefix P (58 blocks of 16), the tails of A and B and
#: the new tokens of every request: A and B end at 1024 tokens, the
#: context of ``gpt2_config("6.7b")`` (its learned positions stop there)
HC_PREFIX, HC_TAIL, HC_NEW = 928, 64, 32
#: phase 26's filler prompts (63 full blocks; with their one new token
#: each takes 64 blocks) and how many a wave
HC_FILLER, HC_WAVE = 1008, 4
#: every host budget of phases 26-27 in encoded entries: 128 (1 GiB at
#: 8 MiB a raw bf16 entry, 0.55 GB at wire 8) holds every spilled entry
#: of phase 26; phase 27's fleet tier holds 512 raw entries (4 GiB)
HC_ENTRIES, FLEET_ENTRIES = 128, 512


def serving_copy(eng, **serving):
    """A shallow copy of ``eng`` (the same module and weights) whose
    ``serving`` block is ``dataclasses.replace``d with ``serving`` (a
    ``host_cache`` or ``fleet`` given as a dict replaces its fields)."""
    import copy
    import dataclasses
    sv = eng.config.serving
    for block in ("host_cache", "fleet"):
        if isinstance(serving.get(block), dict):
            serving[block] = dataclasses.replace(getattr(sv, block),
                                                 **serving[block])
    out = copy.copy(eng)
    out.config = dataclasses.replace(
        eng.config, serving=dataclasses.replace(sv, **serving))
    out._serving = None
    return out


#: the most device memory phases 26 and 27 may hold: the weights (13.4
#: GB) and a 4.3 GB pool for each of two replicas, with room to spare
HOST_FLEET_PEAK_BYTES = 40e9


def peak_memory(torch, label) -> None:
    """Print the peak device memory since the phase began and fail past
    ``HOST_FLEET_PEAK_BYTES``."""
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: peak device memory {peak / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated; limit "
          f"{HOST_FLEET_PEAK_BYTES / 1e9:.0f} GB)")
    check(peak < HOST_FLEET_PEAK_BYTES,
          f"{label}: peak device memory {peak} bytes")


def chain_digests(prompt, block_size):
    """The allocator's chained content digests of ``prompt``'s full
    blocks."""
    from deepspeed_tpu_torch.inference.serving.block_allocator import (
        ROOT_HASH, _chain_hash)
    h, out = ROOT_HASH, []
    for i in range(len(prompt) // block_size):
        h = _chain_hash(h, tuple(prompt[i * block_size:(i + 1) * block_size]))
        out.append(h)
    return out


def fs_type(path) -> str:
    out = subprocess.run(["stat", "-f", "-c", "%T", str(path)],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or "unknown"


def near_tie_partings(np, eng, reqs, refs, label) -> int:
    """Check every stream of ``reqs`` that parts from its ``refs`` stream
    at a near tie of ``generate()``'s logits there (within twice
    ``LOGITS_REL_TOL`` of max|logit|); print each parting.  A stream that
    is a prefix of its reference does not part.  Returns how many
    parted."""
    pairs = [(r, ref) for r, ref in zip(reqs, refs)
             if list(r.output) != list(ref)[:len(r.output)]]
    gaps = divergence_gaps(np, eng, [r for r, _ in pairs],
                           [ref for _, ref in pairs])
    for req_id, pos, gap in gaps:
        print(f"  {label}: {req_id} parts at token {pos}: generate()'s logit "
              f"gap there {gap!r} of max|logit| (limit "
              f"{2 * LOGITS_REL_TOL})")
        check(gap <= 2 * LOGITS_REL_TOL,
              f"{label}: {req_id} parts at token {pos} where the gap is "
              f"{gap:.4f} of max|logit|, not a near tie")
    return len(gaps)


def host_cache_case(torch, np, eng, label, kv_bits, host_cache, fillers,
                    prompts, record=False, nvme_dir=None) -> dict:
    """One run of phase 26 on a fresh server over ``eng``'s weights: A,
    then (``fillers``) filler waves until every block of A's prefix P has
    been evicted (spilled into the host tier, checked there), then B.
    A and B go through ``drain`` (B6/B7 exact against the dispatch log);
    B's B7 launches must be a tail's when P is resident (HBM or host) and
    a full prefill's when not; every promoted block of P must hold the
    bytes gathered at its spill when ``record``.  Returns B's request,
    TTFT, first logits, counts and the host tier's timings."""
    import gc
    from deepspeed_tpu_torch.inference.serving import host_block_bytes
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.aio import odirect_fallbacks
    A, B, filler_prompts = prompts
    bs = eng.config.serving.kv_block_size
    layers = eng.module.config.num_layers
    e = serving_copy(eng, kv_cache_bits=kv_bits,
                     host_cache=host_cache or {"enabled": False})
    srv = ServingEngine(e)
    hc = srv.host_cache
    fallbacks0 = odirect_fallbacks() if nvme_dir else 0
    out = {"label": label}
    if A is not None:
        drain(torch, srv, [A], f"{label} A", kv_bits)
    p_digests = chain_digests(B[:HC_PREFIX], bs)
    # spills timed apart while the fillers evict P and while B's claims
    # take pool blocks (each evicting, so spilling, an LRU filler block)
    saved, spill, spill_b = {}, {"n": 0, "s": 0.0}, {"n": 0, "s": 0.0}
    if fillers:
        real = srv.allocator._spill_fn
        into = [spill]

        def spilling(block, digest):
            if record and digest in p_digests:
                saved[digest] = [t.clone()
                                 for t in srv._gather_block(block)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real(block, digest)
            torch.cuda.synchronize()
            into[0]["s"] += time.perf_counter() - t0
            into[0]["n"] += 1
        srv.allocator._spill_fn = spilling
        waves = iter(filler_prompts)
        while any(d in srv.allocator._hash_to_block for d in p_digests):
            wave = next(waves, None)
            check(wave is not None,
                  f"{label}: the filler waves never evicted P")
            for p in wave:
                srv.submit(p, max_new_tokens=1)
            srv.run()
        into[0] = spill_b
        check(hc.spills_total >= len(p_digests)
              and all(hc.contains(d) for d in p_digests),
              f"{label}: {hc.spills_total} spills; P's digests resident in "
              f"the host tier: {sum(hc.contains(d) for d in p_digests)} of "
              f"{len(p_digests)}")
        srv.allocator.assert_consistent()
    promoted0 = srv.host_counts["promoted_blocks"]
    seconds0 = srv.promote_seconds
    first = {}
    reqs, counts, wall = drain(
        torch, srv, [B], f"{label} B", kv_bits,
        lambda mixed: first_step_recorder(srv, mixed, first))
    r = reqs[0]
    if fillers:
        srv.allocator._spill_fn = real
    srv.allocator.assert_consistent()
    resident = HC_PREFIX if A is not None else 0
    b6 = counts[build.counter("paged_decode_attention", kv_bits)]
    b7 = counts[build.counter("paged_prefill_attention", kv_bits)]
    computed = len(B) - resident
    chunks = -(-computed // eng.config.serving.prefill_chunk_tokens)
    check(b7 == layers * chunks and b6 == layers * (HC_NEW - 1),
          f"{label} B: B7 {b7} (want {layers} x {chunks} chunks of the "
          f"{computed} tokens past the resident prefix), B6 {b6} (want "
          f"{layers} x {HC_NEW - 1})")
    promoted = srv.host_counts["promoted_blocks"] - promoted0
    check(promoted == (len(p_digests) if fillers else 0)
          and srv.host_counts["promote_failures"] == 0
          and (hc is None or hc.hits_total.get("dram", 0)
               + hc.hits_total.get("nvme", 0) == promoted),
          f"{label} B: {promoted} blocks promoted, host counts "
          f"{srv.host_counts}")
    same = None
    if record:
        same = 0
        for d in p_digests:
            now = srv._gather_block(srv.allocator._hash_to_block[d])
            same += all(torch.equal(a, b) for a, b in zip(now, saved[d]))
        check(same == len(p_digests),
              f"{label}: {same} of {len(p_digests)} promoted blocks hold "
              f"the bytes gathered before their spill")
    out.update(req=r, ttft=r.first_token_time - r.submit_time, wall=wall,
               first=first[r.req_id], b6=b6, b7=b7, promoted=promoted,
               promote_s=srv.promote_seconds - seconds0,
               spills=spill["n"], spill_s=spill["s"],
               spills_b=spill_b["n"], spill_b_s=spill_b["s"], same=same,
               entry=srv._hc_codec.nbytes if hc is not None else None,
               raw=host_block_bytes(layers, bs, eng.module.config.kv_heads,
                                    eng.module.config.hdim, kv_bits, 0))
    if hc is not None:
        out["resident"] = {t: hc.resident_bytes(t) for t in hc.tier_names}
        if nvme_dir:
            out["fallbacks"] = odirect_fallbacks() - fallbacks0
        hc.close()
    del srv, e
    gc.collect()
    torch.cuda.empty_cache()
    return out


def host_cache_phase(torch, np, eng, label) -> dict:
    """Phase 26: the tiered host KV cache on phase 5's GPT-3 6.7B engine
    (bf16, random weights from seed 0, phase 5's ``SERVING``): a shared
    prefix P of ``HC_PREFIX`` tokens (A and B fill the model's 1024-token
    context with their new tokens), A = P + a tail, B = P + another tail
    (``HC_TAIL`` tokens each, ``HC_NEW`` new tokens, greedy), B served
    five ways: (i) an HBM hit (A then B), (ii) a DRAM hit after filler
    waves evicted P, at wire 0 and at wire 8, (iii) an NVMe hit (no DRAM
    tier, the slot file in a ``tempfile.mkdtemp()`` directory removed
    afterwards), (iv) cold (a fresh server, host cache off) and (v) a
    kv_bits 8 pool through DRAM, held to its own HBM hit.  B's stream in
    (ii) at wire 0, in (iii) and in (v) equals its HBM hit's exactly; at
    wire 8 and cold it equals (i)'s up to a near tie, with B's first
    logits within ``LOGITS_REL_TOL`` of (i)'s; promoted blocks hold the
    bytes gathered before their spill (wire 0, kv_bits 8); B7 runs the
    tail only on every hit and the whole prompt cold.  Prints B's TTFT
    each way, the promote's blocks, seconds, share of B's drain and
    GB/s, the spill's GB/s, resident bytes per tier, and the NVMe
    directory's filesystem and whether O_DIRECT held there."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.inference.serving import (BlockCodec,
                                                       host_block_bytes)
    torch.cuda.reset_peak_memory_stats()
    cfg = eng.module.config
    V = cfg.vocab_size
    check(HC_PREFIX + HC_TAIL + HC_NEW <= min(cfg.max_seq_len,
                                              eng.config.max_out_tokens)
          and HC_FILLER + 1 <= cfg.max_seq_len,
          f"phase 26's requests outgrow the {cfg.max_seq_len}-token context")
    rng = np.random.default_rng(26)
    P = rng.integers(0, V, HC_PREFIX).tolist()
    A = P + rng.integers(0, V, HC_TAIL).tolist()
    B = P + rng.integers(0, V, HC_TAIL).tolist()
    fill = [[rng.integers(0, V, HC_FILLER).tolist() for _ in range(HC_WAVE)]
            for _ in range(4)]
    geo = (cfg.num_layers, eng.config.serving.kv_block_size, cfg.kv_heads,
           cfg.hdim)
    raw, w8 = (BlockCodec(*geo, wire_bits=bits, dtype=torch.bfloat16).nbytes
               for bits in (0, 8))
    check((raw, w8) == (host_block_bytes(*geo, 0, 0),
                        host_block_bytes(*geo, 0, 8)),
          f"entry sizes {raw}, {w8} differ from host_block_bytes")
    budget = {"enabled": True, "wire_bits": 0,
              "dram_budget_bytes": HC_ENTRIES * raw}
    check(HC_ENTRIES * raw <= 6 * 2**30, "phase 26 budgets over 6 GiB")
    print(f"{label} host cache: one entry is {w8} bytes at 8 bits, {raw} "
          f"raw ({geo[0]} layers x {geo[1]} tokens x {geo[2]} kv heads x "
          f"{geo[3]}); budgets {HC_ENTRIES} entries")
    runs = {}
    runs["hbm"] = host_cache_case(torch, np, eng, f"{label} (i) HBM hit", 0,
                                  None, False, (A, B, fill))
    runs["dram0"] = host_cache_case(torch, np, eng,
                                    f"{label} (ii) DRAM hit, wire 0", 0,
                                    budget, True, (A, B, fill), record=True)
    runs["dram8"] = host_cache_case(
        torch, np, eng, f"{label} (ii) DRAM hit, wire 8", 0,
        dict(budget, wire_bits=8, dram_budget_bytes=HC_ENTRIES * w8), True,
        (A, B, fill))
    nvme = tempfile.mkdtemp(prefix="dstpu_nvme_")
    try:
        runs["nvme"] = host_cache_case(
            torch, np, eng, f"{label} (iii) NVMe hit, wire 0", 0,
            dict(budget, dram_budget_bytes=0,
                 nvme_budget_bytes=HC_ENTRIES * raw, nvme_path=nvme),
            True, (A, B, fill), nvme_dir=nvme)
        fs = fs_type(nvme)
    finally:
        shutil.rmtree(nvme, ignore_errors=True)
    runs["cold"] = host_cache_case(torch, np, eng, f"{label} (iv) cold", 0,
                                   None, False, (None, B, fill))
    runs["hbm8"] = host_cache_case(torch, np, eng,
                                   f"{label} (v) kv_bits 8, HBM hit", 8,
                                   None, False, (A, B, fill))
    runs["dram_kv8"] = host_cache_case(
        torch, np, eng, f"{label} (v) kv_bits 8, DRAM hit", 8,
        dict(budget, wire_bits=8, dram_budget_bytes=HC_ENTRIES * w8), True,
        (A, B, fill), record=True)
    ref = runs["hbm"]["req"].output
    for key in ("dram0", "nvme"):
        check(runs[key]["req"].output == ref,
              f"{runs[key]['label']}: B's stream differs from the HBM hit's")
    check(runs["dram_kv8"]["req"].output == runs["hbm8"]["req"].output,
          f"{label} (v): the kv_bits 8 DRAM hit's stream differs from the "
          f"kv_bits 8 HBM hit's")
    scale = float(runs["hbm"]["first"].abs().max())
    for key in ("dram8", "cold"):
        run = runs[key]
        rel = float((run["first"] - runs["hbm"]["first"]).abs().max()) \
            / scale
        print(f"  {run['label']}: B's first logits within {rel:.4g} of "
              f"max|logit| of (i)'s (limit {LOGITS_REL_TOL})")
        check(rel <= LOGITS_REL_TOL,
              f"{run['label']}: first logits {rel:.4f} of max|logit| from "
              f"(i)'s")
        near_tie_partings(np, eng, [run["req"]], [ref], run["label"])
    for run in runs.values():
        line = (f"{run['label']}: B's TTFT {1e3 * run['ttft']:.1f} ms, drain "
                f"{run['wall']:.3f} s; B7 {run['b7']}, B6 {run['b6']}")
        if run["promoted"]:
            line += (f"; promoted {run['promoted']} blocks in "
                     f"{run['promote_s']:.4f} s ({100 * run['promote_s'] / run['wall']:.1f} % "
                     f"of B's drain; {run['promoted'] * run['raw'] / run['promote_s'] / 1e9:.2f} GB/s "
                     f"of pool bytes, {run['promoted'] * run['entry'] / run['promote_s'] / 1e9:.2f} "
                     f"GB/s of entries); spilled {run['spills']} blocks in "
                     f"{run['spill_s']:.3f} s ({run['spills'] * run['raw'] / run['spill_s'] / 1e9:.2f} "
                     f"GB/s of pool bytes) under the fillers, and "
                     f"{run['spills_b']} LRU blocks in "
                     f"{run['spill_b_s']:.3f} s to make room for B's claims "
                     f"({100 * run['spill_b_s'] / run['ttft']:.1f} % of its "
                     f"TTFT); resident "
                     + ", ".join(f"{t} {b} bytes"
                                 for t, b in run["resident"].items()))
        if run["same"] is not None:
            line += (f"; {run['same']} promoted blocks equal to their "
                     f"spilled bytes")
        print(line)
    print(f"  NVMe directory: {fs} filesystem; O_DIRECT "
          + ("held" if not runs["nvme"]["fallbacks"] else
             f"refused ({runs['nvme']['fallbacks']} chunks ran buffered)"))
    peak_memory(torch, f"{label} host cache")
    return {k: {kk: vv for kk, vv in v.items() if kk not in ("req", "first")}
            for k, v in runs.items()}


ONLY_PHASES = {"3", "6", "21", "22", "23", "24", "28", "29", "30", "31",
               "32", "33"}


def partial_run(torch, np, dev, only, elapsed) -> int:
    """``--only``: the listed phases after the build, and no result
    lines (a probe of new work, not the smoke run)."""
    if "3" in only:
        flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
        res = c1_flash_checks(torch, dev, flush, [
            c for c in C1_FLASH_CASES if "MoE" in c[0]])
        for name, cases in c1_decode_checks(
                torch, dev, flush, [c for c in C1_DECODE_CASES
                                    if "MoE" in c[0]]).items():
            res.setdefault(name, []).extend(cases)
        for name, cases in res.items():
            for c in cases:
                print(f"kernel {name} [{c['case']}]: max|err| "
                      f"{c['max_abs_err']:.3g} = {c['limit_share']:.3g} of "
                      f"the limit; planted fault {c['fault_limit_share']:.3g}"
                      f" of it; {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} "
                      f"ms, library {c['library_ms']} ms, bound "
                      f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
        del flush
        elapsed("phase 3 (MoE shapes)")
    if "6" in only:
        gpt2_train_phase(torch, np)
        elapsed("phase 6")
    if "24" in only:
        from deepspeed_tpu_torch import init_inference
        from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                            gpt2_config)
        eng = init_inference(TransformerLM(gpt2_config("6.7b")), {
            "dtype": "bfloat16", "temperature": 0.0, "serving": SERVING})
        spec_front_phases(torch, np, eng, elapsed)
        del eng
    res = {}
    for n, run in (("21", moe_serve_phase), ("22", moe_train_phase),
                   ("23", diffusion_phase), ("28", offload_phase),
                   ("29", infinity_phase), ("30", host_offload_phase)):
        if n in only:
            free_card(torch, f"phase {n}")
            res[n] = run(torch, np)
            elapsed(f"phase {n}")
    if "31" in only:
        # phase 33 runs in phase 31's world
        free_card(torch, "phase 31")
        res["31"] = zero_phase(torch, np, pipe="33" in only)
        elapsed("phase 31")
    if "32" in only:
        # (b) reads phase 31's world: without "31", (a) alone
        free_card(torch, "phase 32")
        tp_phase(torch, np, res.get("31"))
        elapsed("phase 32")
    if "33" in only:
        from deepspeed_tpu_torch.accelerator import nvidia_smi_line
        check("31" in only, "phase 33 runs in phase 31's world: --only 31 33")
        pipe_report(res["31"], nvidia_smi_line(0))
        elapsed("phase 33")
    print("chip_smoke: partial run (--only): no result lines")
    return 0


def new_phases(torch, np, elapsed) -> dict:
    """Phases 21-23, after every earlier engine is freed."""
    free_card(torch, "350M+MoE-128 serving")
    moe_served = moe_serve_phase(torch, np)
    elapsed("phase 21")
    free_card(torch, "125M+MoE-64 training")
    moe_trained = moe_train_phase(torch, np)
    elapsed("phase 22")
    free_card(torch, "Stable Diffusion")
    diffusion_phase(torch, np)
    elapsed("phase 23")
    return {"served": moe_served, "trained": moe_trained}



# -- 28-30. offload: ZeRO-Offload, ZeRO-Infinity, host_offload remat ----------
#: phase 28: the tier-1 parity model (phase 6's GPT-2 125M) at seq 1024,
#: micro 4, 3 steps; the full-width run at GPT-3 6.7B, seq 1024, micro 4,
#: 1 step at wire 0 then 1 at offload_wire_bits 8 (3 and 2 until phase 31
#: came: cut for the run's time)
OFFLOAD_67_STEPS, OFFLOAD_67_WIRE0 = 2, 1
#: (b)'s depth: GPT-3 6.7B's width at 8 of its 32 layers (all 32, with
#: 80 GB of host Adam state, until phase 32 came; 16 until phase 33 came,
#: which takes ~21 s on an H100 80GB HBM3 at 700 W: each cut for the run's
#: time; 20 GB of host state still holds the path)
OFFLOAD_67_LAYERS = 8
OFFLOAD_PARITY_MICRO, OFFLOAD_SEQ, OFFLOAD_67_MICRO = 4, 1024, 4
#: the JAX tests' bounds for an offload engine against the in-HBM one
#: (tests/unit/test_infinity.py:468-480): losses within 5e-3, grad norms
#: within 5 % of max(1, norm)
OFFLOAD_LOSS_TOL, OFFLOAD_GNORM_REL = 5e-3, 5e-2
#: the parity runs' learning rate (phases 28 (a) and 29 (a))
PARITY_LR = 1e-4
#: phase 29: GPT-NeoX-20B's width at seq 2048, micro 1; 2 layers for the
#: parity and NVMe checks, INFINITY_LAYERS (cut to the host's memory at
#: run time) for (c)'s longer stream: 4 (12 until phase 32 came, cut for
#: the run's time; the host held 10 of them, 82 GB of Adam state)
INFINITY_SEQ, INFINITY_PARITY_LAYERS, INFINITY_LAYERS = 2048, 2, 4
#: (c)'s steps: pure stream, then clip-gated at gas 2 (3 and 2 until
#: phase 31 came: cut for the run's time)
INFINITY_PURE, INFINITY_CLIP = 2, 1
#: host bytes a parameter of a streamed layer holds in DRAM/DRAM with the
#: clip-gated accumulator: master, m, v (12), the bf16 slot (2), the
#: float32 gradient sum (4)
INFINITY_HOST_BYTES_PER_PARAM = 18


def host_report() -> dict:
    """The host's memory, cores and temporary directory (free space and
    filesystem type): what the offload phases are cut to."""
    import os
    import shutil
    import tempfile
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k in ("MemTotal", "MemAvailable"):
                info[k] = int(v.split()[0]) * 1024
    tmp = tempfile.gettempdir()
    info["cpus"] = os.cpu_count()
    info["tmp"] = tmp
    info["tmp_free"] = shutil.disk_usage(tmp).free
    info["tmp_fs"] = fs_type(tmp)
    print(f"host: MemTotal {info['MemTotal'] / 1e9:.2f} GB, MemAvailable "
          f"{info['MemAvailable'] / 1e9:.2f} GB, {info['cpus']} CPUs; "
          f"temporary directory {tmp}: {info['tmp_free'] / 1e9:.1f} GB "
          f"free, filesystem {info['tmp_fs']}")
    return info


def mem_available(field: str = "MemAvailable") -> int:
    """A /proc/meminfo field in bytes.  MemAvailable lags a large free
    on the card's machine (an earlier phase's 80 GB of host state shows
    as taken until the next large allocation reclaims it), so the offload
    phases size themselves by MemTotal and print MemAvailable beside."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) * 1024
    return 0


def copy_rates(torch) -> dict:
    """Device-to-host and host-to-device GB/s of 1 GiB between the card
    and pinned host memory on a side stream (the offload wire's copies),
    timed with CUDA events, median of 3."""
    dev = torch.device("cuda", 0)
    n = 2**30
    d = torch.empty(n, dtype=torch.uint8, device=dev)
    h = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    s = torch.cuda.Stream(dev)
    out = {}
    for name, fn in (("d2h", lambda: h.copy_(d, non_blocking=True)),
                     ("h2d", lambda: d.copy_(h, non_blocking=True))):
        times = []
        for _ in range(4):
            with torch.cuda.stream(s):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record(s)
                fn()
                b.record(s)
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        out[name] = n / statistics.median(times[1:]) / 1e9
    del d, h
    return out


def offload_config(micro, gas=1, clip=1.0, zero=None, lr=6e-4):
    """bench.py's AdamW (lr 6e-4, weight decay 0.1), bf16, ``zero``."""
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {
               "lr": lr, "weight_decay": 0.1}},
           "bf16": {"enabled": True}, "gradient_clipping": clip,
           "steps_per_print": 0, "zero_optimization": zero or {"stage": 0}}
    return cfg


def close_parity(label, i, a, b) -> None:
    """Hold an offload engine's step metrics to the in-HBM engine's within
    the JAX tests' bounds."""
    la, lb = float(a["loss"]), float(b["loss"])
    ga, gb = float(a["grad_norm"]), float(b["grad_norm"])
    print(f"  {label} step {i}: loss {la:.5f} against {lb:.5f} (|diff| "
          f"{abs(la - lb):.2e}, limit {OFFLOAD_LOSS_TOL}); grad norm "
          f"{ga:.4f} against {gb:.4f} ({abs(ga - gb) / max(1.0, gb):.2e} "
          f"of max(1, norm), limit {OFFLOAD_GNORM_REL})")
    check(abs(la - lb) < OFFLOAD_LOSS_TOL,
          f"{label} step {i}: loss {la} vs {lb}")
    check(abs(ga - gb) < OFFLOAD_GNORM_REL * max(1.0, gb),
          f"{label} step {i}: grad norm {ga} vs {gb}")


def offload_phase(torch, np) -> dict:
    """Phase 28, ZeRO-Offload (tier 1): (a) GPT-2 125M with
    ``offload_optimizer: {device: cpu}`` against the in-HBM engine from
    the same params on the same batch (3 steps, the JAX tests' bounds);
    (b) GPT-3 6.7B's width (d_model 4096) at ``OFFLOAD_67_LAYERS`` of its
    32 layers,
    seq 1024, micro 4, remat full, flash, AdamW, bf16 over f32 masters on
    the host, clipping 1.0, ZeRO stage 2 with ``offload_optimizer:
    {device: cpu, pin_memory: true}``: ``OFFLOAD_67_WIRE0`` steps at wire
    0, then the same engine's ``offload_wire_bits`` set to 8 for the rest
    of ``OFFLOAD_67_STEPS`` (a second engine would need a second 80 GB of
    host state).  Width and depth are not cut."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.ops import build
    dev = torch.device("cuda", 0)
    rates = copy_rates(torch)
    print(f"offload wire, 1 GiB to/from pinned host memory on a side "
          f"stream: D2H {rates['d2h']:.2f} GB/s, H2D {rates['h2d']:.2f} "
          f"GB/s")
    zero = {"stage": 2, "offload_optimizer": {"device": "cpu",
                                              "pin_memory": True}}
    # (a) parity at GPT-2 125M
    cfg = gpt2_config("125m", remat="full", attn_impl="flash",
                      loss_chunk=256)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = TransformerLM(cfg).init(g, dev, torch.float32)
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size,
                                     (OFFLOAD_PARITY_MICRO, OFFLOAD_SEQ),
                                     dtype=np.int32)}

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}
    # lr 1e-4: at bench.py's 6e-4 a random GPT-2 125M's third step on one
    # batch overshoots (grad norm 91), where rounding-level differences
    # between two correct engines grow to most of the bound
    base, _, _, _ = initialize(model=TransformerLM(cfg), config=offload_config(
        OFFLOAD_PARITY_MICRO, lr=PARITY_LR), params=copy(params))
    off, _, _, _ = initialize(model=TransformerLM(cfg), config=offload_config(
        OFFLOAD_PARITY_MICRO, zero=zero, lr=PARITY_LR), params=params)
    del params
    build.reset_launch_counts()
    for i in range(3):
        close_parity("(a) GPT-2 125M offload", i, off.train_step(batch),
                     base.train_step(batch))
    del base, off
    free_card(torch, "phase 28 (b)")

    # (b) GPT-3 6.7B at full width, OFFLOAD_67_LAYERS deep
    cfg = gpt2_config("6.7b", num_layers=OFFLOAD_67_LAYERS, remat="full",
                      attn_impl="flash", loss_chunk=256)
    m0 = mem_available()
    need, total = 12 * cfg.num_params(), mem_available("MemTotal")
    check(total > 1.15 * need, f"6.7B offload needs {need / 1e9:.1f} GB "
                               f"of host optimizer state; MemTotal is "
                               f"{total / 1e9:.1f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, _, _, _ = initialize(model=TransformerLM(cfg), config=offload_config(
        OFFLOAD_67_MICRO, zero=zero))
    init_s = time.perf_counter() - t0
    n = eng._host_opt.opt.master
    n_params = sum(a.size for a in n)
    host_state = eng._host_opt.host_bytes
    print(f"(b) GPT-3 6.7B offload: {n_params / 1e9:.3f} B params, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}; init {init_s:.1f}"
          f" s; host optimizer state {host_state / 1e9:.2f} GB (MemAvailable"
          f" {m0 / 1e9:.1f} GB before, {mem_available() / 1e9:.1f} after); "
          f"device after init {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size,
                                     (OFFLOAD_67_MICRO, OFFLOAD_SEQ),
                                     dtype=np.int32)}
    build.reset_launch_counts()
    losses, rows = [], []
    for i in range(OFFLOAD_67_STEPS):
        if i == OFFLOAD_67_WIRE0:
            eng._config.zero_config.offload_wire_bits = 8
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(batch)
        step_s = time.perf_counter() - t0
        t = dict(eng.offload_timing)
        losses.append(float(m["loss"]))
        sweep_gbs = 30 * n_params / max(t["sweep_s"], 1e-9) / 1e9
        rows.append((step_s, t))
        print(f"  step {i} (wire {8 if i >= OFFLOAD_67_WIRE0 else 0}): "
              f"{step_s:.2f} s; "
              f"offload/grads {t['grads_s']:.2f} s, offload/host_sweep "
              f"{t['wall_s']:.2f} s (fetch lane {t['fetch_s']:.2f}, sweep "
              f"{t['sweep_s']:.2f} = {sweep_gbs:.1f} GB/s of the 30 bytes "
              f"a parameter it reads and writes, upload lane "
              f"{t['upload_s']:.2f}; {t['pieces']} pieces), D2H "
              f"{t['d2h_bytes'] / 1e9:.2f} GB, H2D {t['h2d_bytes'] / 1e9:.2f}"
              f" GB; loss {losses[-1]:.4f}, grad norm "
              f"{float(m['grad_norm']):.3f}")
        check(np.isfinite(losses[-1]), f"6.7B offload step {i}: loss "
                                       f"{losses[-1]}")
    counts = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    print(f"  loss on the repeated batch {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; peak device memory {peak / 1e9:.2f} GB; host "
          f"bytes {host_state / 1e9:.2f} GB of optimizer state; launches "
          f"over {OFFLOAD_67_STEPS} steps: B1 "
          f"{counts['flash_attention_fwd']}, B2 "
          f"{counts['flash_attention_bwd']}")
    check(losses[-1] < losses[0], f"6.7B offload: loss did not fall "
                                 f"{losses}")
    L = cfg.num_layers
    check(counts["flash_attention_fwd"] == OFFLOAD_67_STEPS * 2 * L
          and counts["flash_attention_bwd"] == OFFLOAD_67_STEPS * L,
          f"6.7B offload launches {counts}")
    eng._host_opt.close()
    del eng
    free_card(torch, "phase 28 done")
    return {"flash_attention_fwd": counts["flash_attention_fwd"],
            "flash_attention_bwd": counts["flash_attention_bwd"],
            "rows": rows}


def infinity_phase(torch, np) -> dict:
    """Phase 29, ZeRO-Infinity at GPT-NeoX-20B's width (the published
    config.json: d_model 6144, 64 heads of 96, rotary, parallel residual,
    vocab 50432, seq 2048), micro 1, flash, AdamW, bf16, ZeRO stage 3
    with ``offload_param`` and ``offload_optimizer``.  First, while the
    host's memory is freshest, (c) the longer stream:
    ``INFINITY_LAYERS`` layers, cut to what 80 % of the host's MemTotal
    holds at ``INFINITY_HOST_BYTES_PER_PARAM`` a streamed parameter (the
    width is never cut), DRAM/DRAM, streamed init, ``INFINITY_PURE`` steps
    pure stream, then the same engine at gas 2 with clipping 1.0
    (clip-gated) for ``INFINITY_CLIP`` steps.
    Then (a) 2 layers (1.53 B params) against the in-HBM engine from the
    same params, 3 steps (pure stream, lr ``PARITY_LR``), the JAX tests'
    bounds, B1 twice and B3/B4 once a layer (seq 2048 spans two 1024-row
    blocks, so the backward is the two-pass one); (b) the NVMe tier at 2
    layers (both stores in a temporary directory), 2 steps: its f32
    masters bit-equal to (a)'s DRAM run after 2 steps."""
    import tempfile
    from deepspeed_tpu_torch import hf_neox_config, initialize
    from deepspeed_tpu_torch.models.transformer import TransformerLM
    from deepspeed_tpu_torch.module_inject.policies import GPT_NEOX_20B
    from deepspeed_tpu_torch.ops import build
    dev = torch.device("cuda", 0)

    def model_cfg(layers):
        # the published config.json with its depth cut; max_seq_len is
        # its 2048 already
        return hf_neox_config(dict(GPT_NEOX_20B, num_hidden_layers=layers),
                              remat="full", attn_impl="flash",
                              loss_chunk=256)

    def zero(param="cpu", opt="cpu", path=None):
        return {"stage": 3,
                "offload_param": {"device": param, "nvme_path": path},
                "offload_optimizer": {"device": opt, "nvme_path": path}}
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, GPT_NEOX_20B["vocab_size"],
                                     (1, INFINITY_SEQ), dtype=np.int32)}

    # (c) the longer stream
    m = TransformerLM(model_cfg(2))
    n_layer = sum(int(np.prod(s)) for s in _leaves(m.superblock_shapes()))
    res_params = sum(int(np.prod(s)) for s in _leaves(m.resident_shapes()))
    mem = mem_available("MemTotal")
    fit = int(0.8 * mem // (n_layer * INFINITY_HOST_BYTES_PER_PARAM))
    layers = max(2, min(INFINITY_LAYERS, fit))
    total = layers * n_layer + res_params
    print(f"(c) depth: {layers} layers of {n_layer / 1e6:.1f} M params "
          f"({INFINITY_LAYERS} wanted; 80 % of MemTotal {mem / 1e9:.1f} GB "
          f"holds {fit} at {INFINITY_HOST_BYTES_PER_PARAM} bytes a streamed "
          f"param; MemAvailable {mem_available() / 1e9:.1f} GB): "
          f"{total / 1e9:.3f} B params, Adam state at 16 bytes a param "
          f"{16 * total / 1e9:.1f} GB")
    cfg = model_cfg(layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, _, _, _ = initialize(model=TransformerLM(cfg), config=
                              offload_config(1, clip=0.0, zero=zero()))
    st = eng._infinity
    print(f"  init {time.perf_counter() - t0:.1f} s; host stores "
          f"{(st.param_store.host_bytes + st.opt.host_bytes) / 1e9:.2f} GB "
          f"(MemAvailable after {mem_available() / 1e9:.1f} GB); device "
          f"layer cache {st.max_live_layers} layers; device after init "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    rows, losses = [], []
    for i in range(INFINITY_PURE + INFINITY_CLIP):
        b = batch
        if i >= INFINITY_PURE:
            # the same engine at gas 2 with clipping: the clip-gated mode
            st.gas = eng.gradient_accumulation_steps = 2
            st.clip = 1.0
            b = {"input_ids": np.concatenate([batch["input_ids"]] * 2)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mt = eng.train_step(b)
        step_s = time.perf_counter() - t0
        t = dict(st.timing)
        losses.append(float(mt["loss"]))
        hidden = 1.0 - t["join_s"] / max(t["sweep_s"], 1e-9)
        rows.append((step_s, t))
        print(f"  step {i} ({'clip-gated, gas 2' if i >= INFINITY_PURE else 'pure stream'}"
              f"): {step_s:.2f} s; walk {t['walk_s']:.2f} s, device tail "
              f"{t['device_tail_s']:.2f}, exposed sweep {t['join_s']:.2f}, "
              f"clip sweep {t['clip_sweep_s']:.2f}; host sweep "
              f"{t['sweep_s']:.2f} s summed over the workers, "
              f"{100 * max(hidden, 0.0):.1f} % of it inside the backward; "
              f"H2D {t['h2d_bytes'] / 1e9:.2f} GB "
              f"({t['h2d_bytes'] / step_s / 1e9:.2f} GB/s of the step), D2H "
              f"{t['d2h_bytes'] / 1e9:.2f} GB "
              f"({t['d2h_bytes'] / step_s / 1e9:.2f} GB/s); loss "
              f"{losses[-1]:.4f}, grad norm {float(mt['grad_norm']):.3f}")
        check(np.isfinite(losses[-1]), f"Infinity step {i}: {losses[-1]}")
    peak = torch.cuda.max_memory_allocated()
    # the resident params' float32 masters, m, v and summed grads (16
    # bytes a param), and at their step the head's and the embedding's
    # grad trees and the optimizer's fresh params and moments (20 more)
    res_bytes, res_step = 16 * res_params, 20 * res_params
    layer_bytes = st.max_live_layers * st.n_pad * 2
    stash = layers * INFINITY_SEQ * cfg.d_model * 2
    host = (st.param_store.host_bytes + st.opt.host_bytes
            + (st._grad_accum.nbytes if st._grad_accum is not None else 0))
    budget = res_bytes + res_step + layer_bytes + stash
    print(f"  peak device memory {peak / 1e9:.2f} GB against the budget's "
          f"{budget / 1e9:.2f} GB (resident masters, moments and grads "
          f"{res_bytes / 1e9:.2f}, the resident step's transients "
          f"{res_step / 1e9:.2f}, {st.max_live_layers} layer buffers "
          f"{layer_bytes / 1e9:.2f}, {layers} stashes {stash / 1e9:.3f}) "
          f"plus one layer's recompute; host bytes {host / 1e9:.2f} GB; "
          f"loss {losses[0]:.4f} -> {losses[INFINITY_PURE - 1]:.4f} over "
          f"the pure-stream "
          f"steps")
    check(losses[INFINITY_PURE - 1] < losses[0],
          f"Infinity loss did not fall {losses}")
    st.close()
    del eng, st
    free_card(torch, "phase 29 (a)")

    # (a) parity at 2 layers
    cfg = model_cfg(INFINITY_PARITY_LAYERS)
    per_step = {"flash_attention_fwd": 2 * cfg.num_layers,
                "flash_attention_bwd": 0,
                "flash_attention_bwd_dq": cfg.num_layers,
                "flash_attention_bwd_dkv": cfg.num_layers}
    params = TransformerLM(cfg).init_streamed(0, dev, torch.float32)
    base, _, _, _ = initialize(model=TransformerLM(cfg), config=offload_config(
        1, clip=0.0, lr=PARITY_LR), params=_clone(params))
    inf, _, _, _ = initialize(model=TransformerLM(cfg), config=offload_config(
        1, clip=0.0, zero=zero(), lr=PARITY_LR), params=params)
    host_params = inf._infinity.gather_params()
    del params
    counts = {}
    masters2 = None
    for i in range(3):
        build.reset_launch_counts()
        mi = inf.train_step(batch)
        step_counts = dict(build.launch_counts)
        for k, v in per_step.items():
            counts[k] = counts.get(k, 0) + step_counts[k]
            check(step_counts[k] == v, f"Infinity step {i}: {k} launches "
                                       f"{step_counts[k]} != {v}")
        close_parity("(a) NeoX-20B width, 2 layers, Infinity", i, mi,
                     base.train_step(batch))
        if i == 1:
            masters2 = inf._infinity.gather_params()["blocks"]
    del base
    inf._infinity.close()
    del inf
    free_card(torch, "phase 29 (b)")

    # (b) the NVMe tier, bit for bit against the DRAM run's masters
    with tempfile.TemporaryDirectory(prefix="dstt_infinity_") as tmp:
        nv, _, _, _ = initialize(model=TransformerLM(cfg), config=
                                 offload_config(1, clip=0.0, zero=zero(
                                     "nvme", "nvme", tmp), lr=PARITY_LR),
                                 params=host_params)
        t0 = time.perf_counter()
        for _ in range(2):
            nv.train_step(batch)
        nvme_s = (time.perf_counter() - t0) / 2
        got = nv._infinity.gather_params()["blocks"]
        disk = nv._infinity.opt.disk_bytes + nv._infinity.param_store \
            .disk_bytes
        nv._infinity.close()
        del nv
    diffs = [int((a != b).sum()) for a, b in zip(_leaves(got),
                                                 _leaves(masters2))]
    print(f"(b) NVMe tier, 2 layers, {fs_type(tempfile.gettempdir())}: "
          f"{nvme_s:.2f} s/step, {disk / 1e9:.2f} GB of slot files; f32 "
          f"masters after 2 steps differ from the DRAM run's in "
          f"{sum(diffs)} elements (must be 0)")
    check(sum(diffs) == 0, "NVMe masters differ from DRAM's")
    del got, masters2, host_params
    free_card(torch, "phase 29 done")
    return {**counts, "rows": rows, "layers": layers}


def host_offload_phase(torch, np) -> dict:
    """Phase 30, ``remat="host_offload"``: phase 20's GPT-NeoX 1.3B (24
    layers, seq 1024, micro 8, flash, AdamW, bf16) for 3 steps against
    ``remat="full"`` from the same params on the same batch: the same
    arithmetic, so the losses agree to the step check's limit; peak
    device memory of both and the step-time ratio."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        neox_config)
    from deepspeed_tpu_torch.ops import build
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(0)
    out = {}
    params = None
    for remat in ("full", "host_offload"):
        cfg = neox_config("1.3b", max_seq_len=NEOX_SEQ, remat=remat,
                          attn_impl="flash", loss_chunk=256)
        if params is None:
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            params = TransformerLM(cfg).init(g, dev, torch.float32)
            batch = {"input_ids": rs.randint(0, cfg.vocab_size,
                                             (NEOX_MICRO, NEOX_SEQ),
                                             dtype=np.int32)}
        eng, _, _, _ = initialize(
            model=TransformerLM(cfg), config=offload_config(NEOX_MICRO),
            params={k: _clone(v) for k, v in params.items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [float(eng.train_step(batch)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        out[remat] = (losses, (time.perf_counter() - t0) / 3,
                      torch.cuda.max_memory_allocated(),
                      dict(build.launch_counts))
        del eng
        torch.cuda.empty_cache()
    (lf, sf, pf, _), (lh, sh, ph, ch) = out["full"], out["host_offload"]
    for i, (a, b) in enumerate(zip(lh, lf)):
        print(f"  step {i}: loss host_offload {a:.6f}, full {b:.6f} "
              f"(|diff| {abs(a - b):.2e})")
        check(abs(a - b) <= STEP_LOSS_REL_TOL * abs(b),
              f"host_offload step {i}: loss {a} vs full {b}")
    print(f"remat host_offload (GPT-NeoX 1.3B, seq {NEOX_SEQ}, micro "
          f"{NEOX_MICRO}): peak device memory {ph / 1e9:.2f} GB against "
          f"full's {pf / 1e9:.2f} GB; {sh * 1e3:.1f} ms/step against "
          f"{sf * 1e3:.1f} (ratio {sh / sf:.3f}); B1 "
          f"{ch['flash_attention_fwd']}, B2 {ch['flash_attention_bwd']} "
          f"over 3 steps")
    check(ph < pf, f"host_offload peak {ph} not below full's {pf}")
    return {"flash_attention_fwd": ch["flash_attention_fwd"],
            "flash_attention_bwd": ch["flash_attention_bwd"]}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def offload_phases(torch, np, elapsed) -> dict:
    """Phases 28-30, after every earlier engine is freed."""
    free_card(torch, "ZeRO-Offload")
    off = offload_phase(torch, np)
    elapsed("phase 28")
    free_card(torch, "ZeRO-Infinity")
    inf = infinity_phase(torch, np)
    elapsed("phase 29")
    free_card(torch, "host_offload remat")
    ho = host_offload_phase(torch, np)
    elapsed("phase 30")
    return {"offload": off, "infinity": inf, "host_offload": ho}


# -- 31. data parallelism and ZeRO stages 0-3 ---------------------------------
#: phase 6's model and batch: GPT-2 125M at seq 1024, global batch 64
#: (micro 16 on each of 4 ranks), 2 steps a run (3 until phase 32 came:
#: cut for the run's time)
ZERO_SEQ, ZERO_GLOBAL, ZERO_STEPS, ZERO_WORLD = 1024, 64, 2, 4
#: each world's deadline (seconds): a rank that fails or hangs fails it
ZERO_DEADLINE = 300

#: phase 32 (b), tensor parallelism in phase 31's worlds: the meshes
#: (mesh, ZeRO stage), its global batch (8: micro 8 a rank at {data 1,
#: model 4}, 4 at {data 2, model 2}; phase 6 trains micro 64, cut for
#: the time gloo takes with each layer's activations: 72 all-reduces of
#: micro x 1024 x 768 bf16 a step) and steps (2 of phase 31 (a)'s
#: states)
TP_TRAIN_MESHES = (({"data": 1, "model": 4}, 0), ({"data": 2, "model": 2}, 2))
TP_TRAIN_GLOBAL, TP_TRAIN_STEPS = 8, 2

#: phase 33, the pipeline in phase 31's world: (key, mesh, ZeRO stage,
#: schedule) at phase 32 (b)'s global batch of 8 and steps (micro 1, so
#: 8 micro batches a step, 4 a data rank at {pipe 2, data 2}), each step
#: from phase 31 (a)'s state of that step, held to phase 32 (b)'s
#: reference (the engine without a mesh at that state and batch); the
#: four meshes and the bubble fits take 21-31 s of phase 31's world on an
#: H100 80GB HBM3 at 700 W, paid for by phase 28 (b)'s depth
PIPE_TRAIN_MESHES = (("pipe4_1f1b", {"pipe": 4}, 0, "1f1b"),
                     ("pipe4_gpipe", {"pipe": 4}, 0, "gpipe"),
                     ("pipe2_data2", {"pipe": 2, "data": 2}, 1, "1f1b"),
                     ("pipe2_model2", {"pipe": 2, "model": 2}, 0, "1f1b"))
#: the bubble fit's two micro-batch counts, at {pipe 4}, each schedule
PIPE_BUBBLE_MICROS = (4, 8)

#: the ranks' program: mode "a" is world 1 on NCCL (stage 3 against the
#: engine without ZeRO, each step from the same state; and, for phase 32
#: (b), the engine without ZeRO at phase 32's batch from that state),
#: mode "b" one rank of world 4 over gloo, all sharing card 0, stages 0-3
#: in turn, then phase 32 (b)'s tensor-parallel meshes; the result is one
#: "P31RESULT" JSON line
ZERO_WORKER = r'''
import gc, json, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.transformer import TransformerLM, gpt2_config
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.runtime.dataloader import rank_slice
from deepspeed_tpu_torch.runtime.optimizers import tree_leaves, tree_map

mode, steps = os.environ["P31_MODE"], int(os.environ["P31_STEPS"])
states = os.environ["P31_STATES"]
tp_meshes = json.loads(os.environ["P32_MESHES"])
tp_glob, tp_steps = int(os.environ["P32_GLOBAL"]), int(os.environ["P32_STEPS"])
pp_meshes = json.loads(os.environ["P33_MESHES"])
pp_bubble = json.loads(os.environ["P33_BUBBLE"])
seq, glob = int(os.environ["P31_SEQ"]), int(os.environ["P31_GLOBAL"])
dt.init_distributed("nccl" if mode == "a" else "gloo",
                    timeout=float(os.environ["P31_TIMEOUT"]))
rank, world = comm.get_rank(), comm.get_world_size()
# the ranks share the host's cores as they share the card
torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
dev = torch.device("cuda", 0)
cfg = gpt2_config("125m", max_seq_len=seq, remat="full", attn_impl="flash",
                  loss_chunk=256)
KERNELS = ("flash_attention_fwd", "flash_attention_bwd")

def engine(stage, micro=None, mesh=None, gas=1, schedule="auto"):
    config = {"train_micro_batch_size_per_gpu": micro or glob // world,
              "gradient_accumulation_steps": gas,
              "pipeline": {"schedule": schedule},
              "optimizer": {"type": "AdamW", "params": {
                  "lr": 6e-4, "weight_decay": 0.1}},
              "bf16": {"enabled": True}, "gradient_clipping": 1.0,
              "steps_per_print": 0, "zero_optimization": {"stage": stage}}
    if mesh is not None:
        config["mesh"] = mesh
    return dt.initialize(model=TransformerLM(cfg), config=config,
                         device=dev)[0]

rs = np.random.RandomState(0)
batch = {"input_ids": rs.randint(0, cfg.vocab_size, (glob, seq),
                                 dtype=np.int32)}
local = rank_slice(batch, 1, world, rank)
# phase 32 (b)'s global batch
tp_batch = {"input_ids": np.random.RandomState(1).randint(
    0, cfg.vocab_size, (tp_glob, seq), dtype=np.int32)}
out = {}
if mode == "a":
    z, p = engine(3), engine(0)
    t = engine(0, micro=tp_glob)
    rows, counts, tp_ref = [], {k: 0 for k in KERNELS}, []
    for i in range(steps):
        if i < tp_steps:
            t.state = tree_map(lambda x: x.clone(), z.state)
            m = t.train_step(tp_batch)
            tp_ref.append([float(m["loss"]), float(m["grad_norm"])])
        p.state = tree_map(lambda t: t.clone(), z.state)
        # the step's starting state, for world 4 to take the step from
        torch.save(tree_map(lambda t: t.cpu(), z.state),
                   os.path.join(states, f"state{i}.pt"))
        build.reset_launch_counts()
        mz = z.train_step(local)
        mz = {k: float(v) for k, v in mz.items()}
        for k in KERNELS:
            counts[k] += build.launch_counts[k]
        mp = {k: float(v) for k, v in p.train_step(local).items()}
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(z.state["params"]), tree_leaves(p.state["params"])))
        rows.append({"zero": [mz["loss"], mz["grad_norm"]],
                     "plain": [mp["loss"], mp["grad_norm"]],
                     "params_equal": same})
    out = {"rows": rows, "launches": counts, "tp_ref": tp_ref,
           "backend": comm.get_backend(), "zero_stage": z.zero_stage,
           "dp": z.dp_world_size}
else:
    cl = comm.configure(enabled=False)
    for stage in (0, 1, 2, 3):
        eng = engine(stage)
        cl.reset()
        cl.configure(enabled=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        rows, ms = [], []
        for i in range(steps):
            # (a)'s state at this step, each rank keeping its shards
            eng.adopt_state(torch.load(os.path.join(states, f"state{i}.pt"),
                                       map_location=dev, weights_only=True),
                            partial=False)
            comm.barrier()
            t0 = time.perf_counter()
            m = eng.train_step(local)
            rows.append([float(m["loss"]), float(m["grad_norm"])])
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        log = cl.totals()
        cl.configure(enabled=False)
        z = eng._zero
        resident = sum(int(np.prod(s)) for s, d in zip(
            tree_leaves(eng._param_shapes), tree_leaves(z.master_dims))
            if d is None)
        out[str(stage)] = {
            "rows": rows, "ms": ms,
            "launches": {k: build.launch_counts[k] for k in KERNELS},
            "bytes": eng.zero_state_bytes(),
            "planned": z.planned_bytes(eng._param_shapes, 2),
            "resident_params": resident,
            "n_params": eng.num_parameters(),
            "peak": torch.cuda.max_memory_allocated(), "log": log}
        del eng, z
        gc.collect()
        torch.cuda.empty_cache()
    # phase 32 (b): Megatron tensor parallelism, each step from (a)'s
    # state of that step (each rank keeps its model slice's shards)
    t_tp = time.perf_counter()
    out["tp"] = {}
    for mesh, stage in tp_meshes:
        eng = engine(stage, micro=tp_glob // mesh["data"], mesh=mesh)
        cl.reset()
        cl.configure(enabled=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        rows, ms = [], []
        for i in range(tp_steps):
            eng.adopt_state(torch.load(os.path.join(states, f"state{i}.pt"),
                                       map_location=dev, weights_only=True),
                            partial=False)
            comm.barrier()
            t0 = time.perf_counter()
            m = eng.train_step(rank_slice(tp_batch, 1, eng.dp_world_size,
                                          eng.dp_rank))
            rows.append([float(m["loss"]), float(m["grad_norm"])])
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        log = cl.totals()
        cl.configure(enabled=False)
        out["tp"]["x".join(str(mesh[a]) for a in ("data", "model"))] = {
            "rows": rows, "ms": ms, "stage": stage,
            "launches": {k: build.launch_counts[k] for k in KERNELS},
            "bytes": eng.zero_state_bytes(),
            "planned": eng._zero.planned_bytes(eng._param_shapes, 2),
            "mp": eng.mp_world_size, "dp_rank": eng.dp_rank,
            "n_params": eng.num_parameters(),
            "peak": torch.cuda.max_memory_allocated(), "log": log}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    out["tp_seconds"] = time.perf_counter() - t_tp
    # phase 33: the pipeline, each step from (a)'s state of that step,
    # stage-stacked and cut to each rank's stage, model slice and shard
    t_pp = time.perf_counter()
    out["pipe"] = {}
    host = [torch.load(os.path.join(states, f"state{i}.pt"),
                       map_location="cpu", weights_only=True)
            for i in range(tp_steps)] if pp_meshes else []

    def stacked(st, eng):
        st = dict(st, params=eng.adapter.stack(st["params"]))
        st["opt"] = {k: eng.adapter.stack(v) if isinstance(v, dict) else v
                     for k, v in st["opt"].items()}
        return tree_map(lambda t: t.to(dev), st)

    for key, mesh, stage, schedule in pp_meshes:
        dp = mesh.get("data", 1)
        eng = engine(stage, micro=1, mesh=mesh, gas=tp_glob // dp,
                     schedule=schedule)
        real, act = eng._interpret, []

        def spied(*a, **k):
            # the schedule's peak above what was allocated at its start
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            r = real(*a, **k)
            torch.cuda.synchronize()
            act.append(torch.cuda.max_memory_allocated() - base)
            return r
        eng._interpret = spied
        cl.reset()
        cl.configure(enabled=True)
        build.reset_launch_counts()
        rows, ms, peak = [], [], 0
        for i in range(tp_steps):
            eng.adopt_state(stacked(host[i], eng), partial=False)
            comm.barrier()
            t0 = time.perf_counter()
            m = eng.train_step(rank_slice(
                tp_batch, eng.gradient_accumulation_steps, eng.dp_world_size,
                eng.dp_rank))
            rows.append([float(m["loss"]), float(m["grad_norm"])])
            ms.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated())
        torch.cuda.synchronize()
        log, log_pipe = cl.totals(), cl.totals(axis="pipe")
        cl.configure(enabled=False)
        launches = {k: build.launch_counts[k] for k in KERNELS}
        eng._interpret = real
        res = {"rows": rows, "ms": ms, "stage": stage,
               "schedule": eng.schedule,
               "stage_id": eng.stage_id, "lps": eng.adapter.layers_per_stage,
               "micro_batches": eng.micro_batches, "launches": launches,
               "bytes": eng.zero_state_bytes(),
               "planned": eng._zero.planned_bytes(eng._param_shapes, 2),
               "n_params": eng.num_parameters(), "peak": peak,
               "act_peak": max(act), "log": log, "log_pipe": log_pipe}
        if mesh == {"pipe": 4}:
            t0 = time.perf_counter()
            res["bubble"] = eng.measure_bubble_fraction(
                micro_counts=tuple(pp_bubble), repeats=2)
            res["bubble_s"] = time.perf_counter() - t0
        out["pipe"][key] = res
        del eng, real, spied
        gc.collect()
        torch.cuda.empty_cache()
    out["pipe_seconds"] = time.perf_counter() - t_pp
print("P31RESULT " + json.dumps(out), flush=True)
comm.destroy_process_group()
'''


def _rank_result(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith("P31RESULT ")]
    check(bool(lines), "phase 31: a rank printed no result:\n" + text[-2000:])
    return json.loads(lines[-1][len("P31RESULT "):])


def zero_phase(torch, np, pipe: bool = True) -> dict:
    """Phase 31: data parallelism with ZeRO stages 0-3 at phase 6's GPT-2
    125M configuration, each world in child processes
    (``comm/local_ranks.py``, deadline ``ZERO_DEADLINE``): (a) world 1 on
    NCCL, (b) world 4 over gloo with four ranks sharing the card (see the
    module docstring); with ``pipe``, (b) also runs phase 33's meshes.
    Returns the B1/B2 launches of (a) and of each rank of (b) (every
    rank's are checked equal) and phases 32 (b)'s and 33's results."""
    from deepspeed_tpu_torch.accelerator import nvidia_smi_line
    import shutil
    import tempfile
    card = nvidia_smi_line(0)
    # (a)'s starting state of each step (1.5 GB each) for (b): in shared
    # memory where it has the room, else the temporary directory
    shm = "/dev/shm"
    base = shm if (Path(shm).is_dir() and shutil.disk_usage(shm).free
                   > 4 * ZERO_STEPS * 2**30) else None
    states = tempfile.mkdtemp(prefix="dstpu_zero_", dir=base)
    env = {"P31_STEPS": str(ZERO_STEPS), "P31_SEQ": str(ZERO_SEQ),
           "P31_GLOBAL": str(ZERO_GLOBAL), "P31_STATES": states,
           "P31_TIMEOUT": str(ZERO_DEADLINE),
           "P32_MESHES": json.dumps(TP_TRAIN_MESHES),
           "P32_GLOBAL": str(TP_TRAIN_GLOBAL),
           "P32_STEPS": str(TP_TRAIN_STEPS),
           "P33_MESHES": json.dumps(PIPE_TRAIN_MESHES if pipe else ()),
           "P33_BUBBLE": json.dumps(PIPE_BUBBLE_MICROS)}
    try:
        return _zero_runs(torch, np, card, env, states)
    finally:
        shutil.rmtree(states, ignore_errors=True)


def _zero_runs(torch, np, card, env, states) -> dict:
    """Phase 31's two worlds (see ``zero_phase``)."""
    from deepspeed_tpu_torch.comm.local_ranks import run_ranks
    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd": 12}

    def within(label, got, want):
        (lz, gz), (lp, gp) = got, want
        ls = abs(lz - lp) / abs(lp) / STEP_LOSS_REL_TOL
        gs = abs(gz - gp) / abs(gp) / STEP_GNORM_REL_TOL
        check(ls <= 1 and gs <= 1, f"{label}: loss {lz} vs {lp}, grad norm "
                                   f"{gz} vs {gp}")
        return ls, gs

    # (a) world 1 on NCCL
    t0 = time.perf_counter()
    (out,) = run_ranks(ZERO_WORKER, 1, ZERO_DEADLINE, cwd=str(REPO),
                       env={**env, "P31_MODE": "a"})
    a = _rank_result(out)
    check(a["backend"] == "nccl" and a["zero_stage"] == 3 and a["dp"] == 1,
          f"phase 31 (a): {a['backend']}, stage {a['zero_stage']}, dp "
          f"{a['dp']}")
    bit_equal = True
    print(f"ZeRO (a) world 1 on NCCL, GPT-2 125M stage 3 against the engine "
          f"without ZeRO, each step from the same state (seq {ZERO_SEQ}, "
          f"micro {ZERO_GLOBAL}; {card}); {time.perf_counter() - t0:.1f} s "
          f"with the child's start:")
    for i, r in enumerate(a["rows"]):
        same = r["zero"] == r["plain"] and r["params_equal"]
        bit_equal &= same
        ls, gs = within(f"phase 31 (a) step {i}", r["zero"], r["plain"])
        print(f"  step {i}: loss {r['zero'][0]:.6f} against "
              f"{r['plain'][0]:.6f}, grad norm {r['zero'][1]:.5f} against "
              f"{r['plain'][1]:.5f} ({ls:.3g} / {gs:.3g} of the limits); "
              + ("loss, grad norm and updated params bit-equal" if same else
                 "not bit-equal, within the same-state check"))
    print("  (a) held: " + ("bit-equal at every step" if bit_equal else
                            "the same-state check (not bit-equal)"))
    for k, n in per_step.items():
        check(a["launches"][k] == n * ZERO_STEPS,
              f"phase 31 (a): {k} launches {a['launches'][k]}")
    plain = [r["plain"] for r in a["rows"]]

    # (b) world 4 over gloo, sharing card 0
    t0 = time.perf_counter()
    outs = run_ranks(ZERO_WORKER, ZERO_WORLD, ZERO_DEADLINE, cwd=str(REPO),
                     env={**env, "P31_MODE": "b"})
    wall = time.perf_counter() - t0
    ranks = [_rank_result(o) for o in outs]
    micro = ZERO_GLOBAL // ZERO_WORLD
    print(f"ZeRO (b) world {ZERO_WORLD} over gloo, the ranks sharing the "
          f"card (NCCL takes one card a rank; each collective staged "
          f"through pinned host memory), micro {micro} a rank, global batch "
          f"{ZERO_GLOBAL}, {ZERO_STEPS} steps a stage, each from (a)'s "
          f"state of that step (in {states}) ({card}); {wall:.1f} s with "
          f"the children's start:")
    totals = {}
    for stage in ("0", "1", "2", "3"):
        for r, res in enumerate(ranks):
            st = res[stage]
            for i, row in enumerate(st["rows"]):
                within(f"phase 31 (b) stage {stage} rank {r} step {i}", row,
                       plain[i])
            for k, n in per_step.items():
                check(st["launches"][k] == n * ZERO_STEPS,
                      f"phase 31 (b) stage {stage} rank {r}: {k} launches "
                      f"{st['launches'][k]}")
            check(st["bytes"] == st["planned"],
                  f"phase 31 (b) stage {stage} rank {r}: state bytes "
                  f"{st['bytes']} against the plan's {st['planned']}")
        r0 = ranks[0][stage]
        n = r0["n_params"]
        total = sum(r0["bytes"].values())
        totals[stage] = (total, r0["resident_params"])
        lshare = max(abs(res[stage]["rows"][i][0] - plain[i][0])
                     / abs(plain[i][0]) / STEP_LOSS_REL_TOL
                     for res in ranks for i in range(ZERO_STEPS))
        gshare = max(abs(res[stage]["rows"][i][1] - plain[i][1])
                     / abs(plain[i][1]) / STEP_GNORM_REL_TOL
                     for res in ranks for i in range(ZERO_STEPS))
        print(f"  stage {stage}: state "
              + "/".join(f"{sum(res[stage]['bytes'].values()) / 1e9:.3f}"
                         for res in ranks)
              + f" GB (ranks 0-3) = {total / n:.2f} bytes a parameter ("
              + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                          r0["bytes"].items())
              + f" GB; the plan's count on every rank), whole on every "
              f"rank {r0['resident_params'] / 1e6:.3f} M params; peak memory "
              + "/".join(f"{res[stage]['peak'] / 2**30:.2f}" for res in ranks)
              + " GiB (ranks 0-3); ms/step "
              + "/".join(f"{max(res[stage]['ms'][i] for res in ranks):.0f}"
                         for i in range(ZERO_STEPS))
              + " (slowest rank, the first step included); loss "
              + " ".join(f"{row[0]:.5f}" for row in r0["rows"])
              + f"; at most {lshare:.3g} (loss) and {gshare:.3g} (grad norm)"
              f" of the step check's limits on any rank")
        for op, lg in sorted(r0["log"].items()):
            print(f"    {op}: {lg['count'] // ZERO_STEPS} calls, "
                  f"{lg['bytes'] / ZERO_STEPS / 1e6:.2f} MB a step a rank, "
                  f"{lg['seconds'] / ZERO_STEPS * 1e3:.1f} ms a step; "
                  f"algbw {lg['algbw_GBps']:.3f} GB/s, busbw "
                  f"{lg['busbw_GBps']:.3f} GB/s")
    s0, s3 = totals["0"][0], totals["3"][0]
    res_bytes = 16 * totals["3"][1]
    print(f"  stage 3 holds {s3 / 1e9:.3f} GB a rank against stage 0's "
          f"{s0 / 1e9:.3f} / 4 + its resident leaves' {res_bytes / 1e9:.4f}")
    check(s3 <= s0 / 4 + res_bytes,
          f"phase 31: stage 3's {s3} bytes above {s0} / 4 + {res_bytes}")
    return {"world1": a["launches"],
            "world4": {k: sum(ranks[0][s]["launches"][k]
                              for s in ("0", "1", "2", "3"))
                       for k in per_step},
            "tp_ref": a["tp_ref"], "tp": [r["tp"] for r in ranks],
            "tp_seconds": max(r["tp_seconds"] for r in ranks),
            "pipe": [r["pipe"] for r in ranks],
            "pipe_seconds": max(r["pipe_seconds"] for r in ranks)}



# -- 32. tensor parallelism -------------------------------------------------
#: phase 32 (a): GPT-3 6.7B's width (32 heads of 128, d 4096, vocab 50304)
#: at 8 of its 32 layers, as phases 11 and 15 cut it; 4 ranks over gloo
#: sharing the card; each world's deadline (seconds)
TP_SERVE_LAYERS, TP_WORLD, TP_DEADLINE = 8, 4, 300
#: the serving meshes of (a), then generate() at tensor_parallel.tp_size 4
#: (phase 4's 8 x 128 prompts, TP_GEN_NEW new tokens: 64 in phase 4, cut
#: for the run's time: each decode step is 18 staged collectives a rank)
TP_SERVE_MESHES = ({"data": 1, "model": 4}, {"data": 2, "model": 2})
TP_GEN_NEW = 32

#: phase 32 (a)'s ranks: mode "one" is world 1 on NCCL serving at mesh
#: 1 x 1, mode "mesh" one rank of world 4 over gloo serving each of
#: TP_SERVE_MESHES, then generate() at tp_size 4; one "P32RESULT" line
#: (the tokens, counts and bytes) and each rank's first-step logits in a
#: .pt file
TP_WORKER = r"""
import gc, json, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference.serving.block_allocator import (
    kv_block_bytes)
from deepspeed_tpu_torch.models import transformer as model_mod
from deepspeed_tpu_torch.models.convert import tp_dims
from deepspeed_tpu_torch.models.transformer import TransformerLM, gpt2_config
from deepspeed_tpu_torch.ops import build

mode, out_dir = os.environ["P32_MODE"], os.environ["P32_OUT"]
dt.init_distributed("nccl" if mode == "one" else "gloo",
                    timeout=float(os.environ["P32_TIMEOUT"]))
rank, world = comm.get_rank(), comm.get_world_size()
torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
dev = torch.device("cuda", 0)
cfg = gpt2_config("6.7b", num_layers=int(os.environ["P32_LAYERS"]))
new = int(os.environ["P32_NEW"])
rng, prompts, lens, sprompts = cs.serving_prompts(np, cfg.vocab_size)
cl = comm.configure(enabled=False)

def planned_weight_bytes(shapes, dims, mp):
    # sharded leaves at 1/mp, replicated ones whole, bf16
    if isinstance(shapes, dict):
        return sum(planned_weight_bytes(shapes[k], dims[k], mp)
                   for k in shapes)
    return int(np.prod(shapes)) // (mp if dims is not None else 1) * 2

def held(tree):
    if isinstance(tree, dict):
        return sum(held(v) for v in tree.values())
    return tree.numel() * tree.element_size()

def spied(name, seen):
    real = getattr(model_mod, name)
    def spy(*a, **k):
        seen.add(int(a[1].shape[-2]))
        return real(*a, **k)
    setattr(model_mod, name, spy)
    return real

def weights(eng):
    mp = eng.tp_model_size
    shapes = eng.module.param_shapes()
    return held(eng.params), planned_weight_bytes(
        shapes, tp_dims(eng.module.partition_specs()), mp)

out, logits = {}, {}
meshes = ([{"data": 1, "model": 1}] if mode == "one"
          else json.loads(os.environ["P32_MESHES"]))
for mesh in meshes:
    key = f"{mesh['data']}x{mesh['model']}"
    eng = dt.init_inference(TransformerLM(cfg), {
        "dtype": "bfloat16", "temperature": 0.0,
        "serving": {**cs.SERVING, "mesh": mesh}}, device=dev)
    got_w, plan_w = weights(eng)
    srv = eng.serving_engine()
    seen, first = set(), {}
    reals = {n: spied(n, seen) for n in ("paged_decode_attention",
                                         "paged_prefill_attention")}
    cl.reset()
    cl.configure(enabled=True)
    reqs, counts, wall = cs.drain(
        torch, srv, sprompts, f"phase 32 (a) {key} rank {rank}", 0,
        lambda mixed: cs.first_step_recorder(srv, mixed, first))
    log = cl.totals()
    cl.configure(enabled=False)
    for n, real in reals.items():
        setattr(model_mod, n, real)
    pool_plan = (kv_block_bytes(cs.SERVING["kv_block_size"], cfg.kv_heads,
                                cfg.hdim, 0, 2,
                                model_shards=eng.tp_model_size)
                 * cs.SERVING["num_kv_blocks"] * cfg.num_layers)
    logits[key] = [first[r.req_id] for r in reqs[:4]]
    out[key] = {"streams": [r.output for r in reqs],
                "ids": [r.req_id for r in reqs],
                "tokens": sum(len(r.output) for r in reqs), "wall": wall,
                "dispatches": srv.counts["dispatches"],
                "b6": counts["paged_decode_attention"],
                "b7": counts["paged_prefill_attention"],
                "kv_heads": sorted(seen), "pool": srv.kv_pool_bytes,
                "pool_plan": pool_plan, "weights": got_w,
                "weights_plan": plan_w,
                "psum": srv.tp_psum_bytes_per_token_layer, "log": log}
    del srv, reqs
    eng._serving = None
    if mode == "one":
        out["gen"] = eng.generate(prompts, max_new_tokens=new).tolist()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
if mode == "mesh":
    # generate() at tensor_parallel.tp_size 4: B5 at 32 / 4 kv heads
    eng = dt.init_inference(TransformerLM(cfg), {
        "dtype": "bfloat16", "temperature": 0.0,
        "tensor_parallel": {"tp_size": world}}, device=dev)
    got_w, plan_w = weights(eng)
    cs.warm_up_at_kv_head_width(eng, prompts, f"phase 32 (a) tp_size "
                                f"{world} rank {rank}",
                                cfg.kv_heads // world)
    build.reset_launch_counts()
    cl.reset()
    cl.configure(enabled=True)
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log = cl.totals()
    cl.configure(enabled=False)
    out["gen"] = gen.tolist()
    out["gen_stats"] = {"wall": wall, "b5": build.launch_counts[
        "decode_attention"], "weights": got_w, "weights_plan": plan_w,
        "log": log, "stats": eng.latency_stats()}
torch.save(logits, os.path.join(out_dir, f"logits_{mode}_{rank}.pt"))
print("P32RESULT " + json.dumps(out), flush=True)
comm.destroy_process_group()
"""


def _tp_result(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith("P32RESULT ")]
    check(bool(lines), "phase 32: a rank printed no result:\n" + text[-2000:])
    return json.loads(lines[-1][len("P32RESULT "):])


def tp_phase(torch, np, zero) -> dict:
    """Phase 32: tensor parallelism (see the module docstring).  (a)
    serves GPT-3 6.7B's width at ``TP_SERVE_LAYERS`` layers: the reference
    here, world 1 on NCCL at mesh 1 x 1 in a child (bit-equal to it), then
    4 gloo ranks sharing the card at each of ``TP_SERVE_MESHES`` and
    ``generate()`` at tp_size 4.  (b) reads phase 31's world: GPT-2 125M
    at each of ``TP_TRAIN_MESHES``, each step from phase 31 (a)'s state.
    Returns the launch counts of (a) and (b) on rank 0."""
    import gc
    import shutil
    import tempfile
    import types
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.accelerator import nvidia_smi_line
    from deepspeed_tpu_torch.comm.local_ranks import run_ranks
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.ops import build
    card = nvidia_smi_line(0)
    cfg = gpt2_config("6.7b", num_layers=TP_SERVE_LAYERS)
    label = f"GPT-3 6.7B ({TP_SERVE_LAYERS} of 32 layers)"
    rng, prompts, lens, sprompts = serving_prompts(np, cfg.vocab_size)

    # the reference: one process, no mesh
    t0 = time.perf_counter()
    eng = init_inference(TransformerLM(cfg), {
        "dtype": "bfloat16", "temperature": 0.0, "serving": SERVING})
    gen_ref = eng.generate(prompts, max_new_tokens=TP_GEN_NEW).tolist()
    srv = eng.serving_engine()
    first_ref = {}
    reqs, counts, wall = drain(
        torch, srv, sprompts, f"phase 32 (a) {label} reference", 0,
        lambda mixed: first_step_recorder(srv, mixed, first_ref))
    ref = {"streams": [r.output for r in reqs],
           "tokens": sum(len(r.output) for r in reqs), "wall": wall}
    # the first 4 requests' first-step logits, in submission order
    first_ref = [first_ref[r.req_id] for r in reqs[:4]]
    del srv, reqs
    eng._serving = None
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 32 (a) {label}, the reference at one rank without a "
          f"mesh: {ref['tokens']} tokens in {ref['wall']:.2f} s = "
          f"{ref['tokens'] / ref['wall']:.1f} tokens/s; "
          f"{time.perf_counter() - t0:.1f} s with the engine's init")

    out_dir = tempfile.mkdtemp(prefix="dstpu_tp_")
    env = {"P32_OUT": out_dir, "P32_TIMEOUT": str(TP_DEADLINE),
           "P32_LAYERS": str(TP_SERVE_LAYERS), "P32_NEW": str(TP_GEN_NEW),
           "P32_MESHES": json.dumps(TP_SERVE_MESHES)}
    try:
        # world 1 on NCCL at mesh 1 x 1: bit-equal to the reference
        t0 = time.perf_counter()
        (text,) = run_ranks(TP_WORKER, 1, TP_DEADLINE, cwd=str(REPO),
                            env={**env, "P32_MODE": "one"})
        one = _tp_result(text)["1x1"]
        one_gen = _tp_result(text)["gen"]
        one_logits = torch.load(f"{out_dir}/logits_one_0.pt")["1x1"]
        same = (one["streams"] == ref["streams"] and one_gen == gen_ref
                and all(torch.equal(a, b)
                        for a, b in zip(one_logits, first_ref)))
        print(f"phase 32 (a) world 1 on NCCL at mesh 1 x 1 against the "
              f"engine without a mesh: 16 streams, generate()'s 8 x "
              f"{TP_GEN_NEW} tokens and 4 requests' first-step logits "
              f"{'bit-equal' if same else 'NOT bit-equal'}; "
              f"{time.perf_counter() - t0:.1f} s with the child's start")
        check(same, "phase 32 (a): world 1 at mesh 1 x 1 is not bit-equal "
                    "to the engine without a mesh")

        # world 4 over gloo
        t0 = time.perf_counter()
        outs = run_ranks(TP_WORKER, TP_WORLD, TP_DEADLINE, cwd=str(REPO),
                         env={**env, "P32_MODE": "mesh"})
        mesh_wall = time.perf_counter() - t0
        ranks = [_tp_result(o) for o in outs]
        logits = [torch.load(f"{out_dir}/logits_mesh_{r}.pt")
                  for r in range(TP_WORLD)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase 32 (a) world {TP_WORLD} over gloo, the ranks sharing the "
          f"card (each collective staged through pinned host memory: one "
          f"host's gloo, not tensor parallelism across cards; {card}); "
          f"{mesh_wall:.1f} s with the children's start:")
    counts_out = {}
    for mesh in TP_SERVE_MESHES:
        key = f"{mesh['data']}x{mesh['model']}"
        mp = mesh["model"]
        r0 = ranks[0][key]
        for r, res in enumerate(ranks):
            got = res[key]
            check(got["streams"] == r0["streams"],
                  f"phase 32 (a) {key}: rank {r}'s streams differ from rank "
                  f"0's")
            check(got["kv_heads"] == [cfg.kv_heads // mp],
                  f"phase 32 (a) {key} rank {r}: B6/B7 saw {got['kv_heads']}"
                  f" kv heads, not {cfg.kv_heads // mp}")
            check(got["pool"] == got["pool_plan"],
                  f"phase 32 (a) {key} rank {r}: pool {got['pool']} bytes "
                  f"against kv_block_bytes' {got['pool_plan']}")
            check(got["weights"] == got["weights_plan"],
                  f"phase 32 (a) {key} rank {r}: weights {got['weights']} "
                  f"bytes against the plan's {got['weights_plan']}")
            check(got["b6"] == r0["b6"] and got["b7"] == r0["b7"],
                  f"phase 32 (a) {key} rank {r}: B6/B7 {got['b6']}/"
                  f"{got['b7']} against rank 0's {r0['b6']}/{r0['b7']}")
        worst = 0.0
        for i, want in enumerate(first_ref):
            for lg in logits:
                a = lg[key][i]
                worst = max(worst, float((a - want).abs().max())
                            / float(want.abs().max()))
        check(worst <= LOGITS_REL_TOL,
              f"phase 32 (a) {key}: first-step logits differ by {worst:.4f}"
              f" of their scale (> {LOGITS_REL_TOL})")
        reqs = [types.SimpleNamespace(req_id=i, prompt=p, output=o)
                for i, p, o in zip(r0["ids"], sprompts, r0["streams"])]
        parted = near_tie_partings(np, eng, reqs, ref["streams"],
                                   f"phase 32 (a) {key}")
        same = sum(a == b for a, b in zip(r0["streams"], ref["streams"]))
        counts_out[key] = {"paged_decode_attention": r0["b6"],
                           "paged_prefill_attention": r0["b7"]}
        print(f"  serving.mesh {{data {mesh['data']}, model {mp}}}: "
              f"{r0['tokens']} tokens in {r0['wall']:.2f} s = "
              f"{r0['tokens'] / r0['wall']:.1f} tokens/s on rank 0 "
              f"({r0['dispatches']} dispatches; the reference "
              f"{ref['tokens'] / ref['wall']:.1f}); {same} of 16 streams "
              f"equal to the reference's, {parted} parting at a near tie; "
              f"every rank's streams equal; first-step logits within "
              f"{worst:.4f} of max|logit| (limit {LOGITS_REL_TOL}); B6 "
              f"{r0['b6']}, B7 {r0['b7']} launches on every rank at "
              f"{cfg.kv_heads // mp} kv heads; weights "
              f"{r0['weights'] / 1e9:.3f} GB a rank, pool "
              f"{r0['pool'] / 2**20:.1f} MiB a rank (the plans' counts); "
              f"{r0['psum']} bytes a token and layer over the model axis")
        for op, lg in sorted(r0["log"].items()):
            print(f"    {op}: {lg['count']} calls, {lg['bytes'] / 1e6:.2f} "
                  f"MB on rank 0, {lg['seconds'] * 1e3:.1f} ms; algbw "
                  f"{lg['algbw_GBps']:.3f} GB/s, busbw "
                  f"{lg['busbw_GBps']:.3f} GB/s")
    g0 = ranks[0]["gen_stats"]
    for r, res in enumerate(ranks):
        check(res["gen"] == ranks[0]["gen"],
              f"phase 32 (a) tp_size {TP_WORLD}: rank {r}'s generate() "
              f"differs from rank 0's")
        want = TP_SERVE_LAYERS * (TP_GEN_NEW - 1)
        check(res["gen_stats"]["b5"] == want,
              f"phase 32 (a) tp_size {TP_WORLD} rank {r}: B5 launches "
              f"{res['gen_stats']['b5']} != {want}")
        check(res["gen_stats"]["weights"] == res["gen_stats"][
            "weights_plan"], f"phase 32 (a) tp_size {TP_WORLD} rank {r}: "
                             f"weights against the plan")
    reqs = [types.SimpleNamespace(req_id=f"row{i}", prompt=p.tolist(),
                                  output=o)
            for i, (p, o) in enumerate(zip(prompts, ranks[0]["gen"]))]
    parted = near_tie_partings(np, eng, reqs, gen_ref,
                               f"phase 32 (a) generate() tp_size {TP_WORLD}")
    same = sum(a == b for a, b in zip(ranks[0]["gen"], gen_ref))
    print(f"  generate() at tensor_parallel.tp_size {TP_WORLD}: 8 x "
          f"{TP_GEN_NEW} tokens in {g0['wall']:.2f} s on rank 0 (decode "
          f"{g0['stats']['p50_ms']:.2f} ms/token); {same} of 8 rows equal "
          f"to the reference's, {parted} parting at a near tie; B5 "
          f"{g0['b5']} launches on every rank at {cfg.kv_heads // TP_WORLD}"
          f" kv heads; weights {g0['weights'] / 1e9:.3f} GB a rank")
    for op, lg in sorted(g0["log"].items()):
        print(f"    {op}: {lg['count']} calls, {lg['bytes'] / 1e6:.2f} MB "
              f"on rank 0, {lg['seconds'] * 1e3:.1f} ms; busbw "
              f"{lg['busbw_GBps']:.3f} GB/s")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    counts_out["generate"] = {"decode_attention": g0["b5"]}
    if zero is not None:
        counts_out["train"] = tp_train_report(zero, card)
    return counts_out


def tp_train_report(zero, card) -> dict:
    """Phase 32 (b)'s checks and lines, from phase 31's world 4: every
    rank's loss and grad norm against phase 31 (a)'s engine without ZeRO
    at the same state and batch, B1/B2 launches exact, state bytes the
    plan's count.  Returns rank 0's launches per mesh."""
    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd": 12}
    ref = zero["tp_ref"]
    out = {}
    print(f"phase 32 (b) GPT-2 125M, seq {ZERO_SEQ}, global batch "
          f"{TP_TRAIN_GLOBAL}, {TP_TRAIN_STEPS} steps a mesh, each from "
          f"phase 31 (a)'s state of that step, in phase 31's world of 4 "
          f"gloo ranks sharing the card ({card}); {zero['tp_seconds']:.1f} "
          f"s of phase 31's:")
    for mesh, stage in TP_TRAIN_MESHES:
        key = f"{mesh['data']}x{mesh['model']}"
        r0 = zero["tp"][0][key]
        for r, ranks in enumerate(zero["tp"]):
            st = ranks[key]
            for i, (row, want) in enumerate(zip(st["rows"], ref)):
                ls = abs(row[0] - want[0]) / abs(want[0])
                gs = abs(row[1] - want[1]) / abs(want[1])
                check(ls <= STEP_LOSS_REL_TOL and gs <= STEP_GNORM_REL_TOL,
                      f"phase 32 (b) {key} rank {r} step {i}: loss "
                      f"{row[0]} vs {want[0]}, grad norm {row[1]} vs "
                      f"{want[1]}")
            for k, n in per_step.items():
                check(st["launches"][k] == n * TP_TRAIN_STEPS,
                      f"phase 32 (b) {key} rank {r}: {k} launches "
                      f"{st['launches'][k]}")
            check(st["bytes"] == st["planned"],
                  f"phase 32 (b) {key} rank {r}: state bytes {st['bytes']}"
                  f" against the plan's {st['planned']}")
        total = sum(r0["bytes"].values())
        print(f"  {{data {mesh['data']}, model {mesh['model']}}} at stage "
              f"{stage} (micro {TP_TRAIN_GLOBAL // mesh['data']} a rank): "
              f"loss " + " ".join(f"{row[0]:.5f}" for row in r0["rows"])
              + " against " + " ".join(f"{w[0]:.5f}" for w in ref)
              + ", grad norm " + " ".join(f"{row[1]:.5f}"
                                          for row in r0["rows"])
              + " against " + " ".join(f"{w[1]:.5f}" for w in ref)
              + f" (every rank within {STEP_LOSS_REL_TOL} / "
              f"{STEP_GNORM_REL_TOL}); state {total / 1e9:.3f} GB a rank = "
              f"{total / r0['n_params']:.2f} bytes a parameter ("
              + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                          r0["bytes"].items())
              + " GB; the plan's count on every rank); peak memory "
              + "/".join(f"{ranks[key]['peak'] / 2**30:.2f}"
                         for ranks in zero["tp"])
              + " GiB (ranks 0-3); ms/step "
              + "/".join(f"{max(ranks[key]['ms'][i] for ranks in zero['tp']):.0f}"
                         for i in range(TP_TRAIN_STEPS))
              + f" (slowest rank); B1 {r0['launches']['flash_attention_fwd']}"
              f", B2 {r0['launches']['flash_attention_bwd']} on every rank")
        for op, lg in sorted(r0["log"].items()):
            print(f"    {op}: {lg['count'] // TP_TRAIN_STEPS} calls, "
                  f"{lg['bytes'] / TP_TRAIN_STEPS / 1e6:.2f} MB a step a "
                  f"rank, {lg['seconds'] / TP_TRAIN_STEPS * 1e3:.1f} ms a "
                  f"step; busbw {lg['busbw_GBps']:.3f} GB/s")
        out[key] = r0["launches"]
    return out

# -- 33. pipeline parallelism ------------------------------------------------
def pipe_report(zero, card) -> dict:
    """Phase 33's checks and lines, from phase 31's world 4 (see the
    module docstring): every rank's loss and grad norm against phase 32
    (b)'s reference (the engine without a mesh at phase 31 (a)'s state
    and the same batch), the same on every rank, B1/B2 launches exact
    (layers a stage x micro batches x steps, twice for B1: the forward
    and the remat recompute), state bytes the plan's count, and 1F1B's
    schedule peak on stage 0 at most gpipe's.  Returns rank 0's
    launches per mesh."""
    ref = zero["tp_ref"]
    ranks = zero["pipe"]
    out = {}
    print(f"phase 33 GPT-2 125M under the pipeline, seq {ZERO_SEQ}, global "
          f"batch {TP_TRAIN_GLOBAL} at micro 1, {TP_TRAIN_STEPS} steps a "
          f"mesh, each from phase 31 (a)'s state of that step, in phase "
          f"31's world of 4 gloo ranks sharing the card (activations and "
          f"their gradients sent through pinned host memory; {card}); "
          f"{zero['pipe_seconds']:.1f} s of phase 31's:")
    for key, mesh, stage, schedule in PIPE_TRAIN_MESHES:
        r0 = ranks[0][key]
        for r, res in enumerate(ranks):
            st = res[key]
            check(st["schedule"] == schedule,
                  f"phase 33 {key} rank {r}: schedule {st['schedule']}")
            check(st["rows"] == r0["rows"],
                  f"phase 33 {key}: rank {r}'s losses {st['rows']} differ "
                  f"from rank 0's {r0['rows']}")
            for i, (row, want) in enumerate(zip(st["rows"], ref)):
                ls = abs(row[0] - want[0]) / abs(want[0])
                gs = abs(row[1] - want[1]) / abs(want[1])
                check(ls <= STEP_LOSS_REL_TOL and gs <= STEP_GNORM_REL_TOL,
                      f"phase 33 {key} rank {r} step {i}: loss {row[0]} vs "
                      f"{want[0]}, grad norm {row[1]} vs {want[1]}")
            n = st["lps"] * st["micro_batches"] * TP_TRAIN_STEPS
            want_l = {"flash_attention_fwd": 2 * n, "flash_attention_bwd": n}
            check(st["launches"] == want_l,
                  f"phase 33 {key} rank {r}: launches {st['launches']} "
                  f"against {want_l}")
            check(st["bytes"] == st["planned"],
                  f"phase 33 {key} rank {r}: state bytes {st['bytes']} "
                  f"against the plan's {st['planned']}")
        total = sum(r0["bytes"].values())
        b1 = r0["launches"]["flash_attention_fwd"]
        b2 = r0["launches"]["flash_attention_bwd"]
        print(f"  {key} ({schedule}, ZeRO stage {stage}, "
              f"{r0['micro_batches']} micro batches a step, {r0['lps']} "
              f"layers a stage): loss " + " ".join(
                  f"{row[0]:.5f}" for row in r0["rows"])
              + " against " + " ".join(f"{w[0]:.5f}" for w in ref)
              + ", grad norm " + " ".join(f"{row[1]:.5f}"
                                          for row in r0["rows"])
              + " against " + " ".join(f"{w[1]:.5f}" for w in ref)
              + f" (every rank the same, within {STEP_LOSS_REL_TOL} / "
              f"{STEP_GNORM_REL_TOL}); state " + "/".join(
                  f"{sum(res[key]['bytes'].values()) / 1e9:.3f}"
                  for res in ranks)
              + f" GB (ranks 0-3; rank 0: " + ", ".join(
                  f"{k} {v / 1e9:.3f}" for k, v in r0["bytes"].items())
              + f" GB = {total / r0['n_params']:.2f} bytes a parameter of "
              f"the model; the plan's count on every rank); peak memory "
              + "/".join(f"{res[key]['peak'] / 2**30:.2f}" for res in ranks)
              + " GiB, the schedule's own peak "
              + "/".join(f"{res[key]['act_peak'] / 2**20:.1f}"
                         for res in ranks)
              + " MiB (ranks 0-3); s/step " + "/".join(
                  f"{max(res[key]['ms'][i] for res in ranks) / 1e3:.3f}"
                  for i in range(TP_TRAIN_STEPS))
              + f" (slowest rank); B1 {b1} = 2 x {r0['lps']} x "
              f"{r0['micro_batches']} x {TP_TRAIN_STEPS}, B2 {b2} = "
              f"{r0['lps']} x {r0['micro_batches']} x {TP_TRAIN_STEPS} on "
              f"every rank")
        for op, lg in sorted(r0["log"].items()):
            calls = max(lg["count"], 1)
            print(f"    {op}: {lg['count'] // TP_TRAIN_STEPS} calls, "
                  f"{lg['bytes'] / TP_TRAIN_STEPS / 1e6:.2f} MB a step on "
                  f"rank 0, {lg['seconds'] / calls * 1e3:.3f} ms a call, "
                  f"{lg['seconds'] / TP_TRAIN_STEPS * 1e3:.1f} ms a step")
        ar = r0["log_pipe"].get("all_reduce")
        if ar:
            calls = ar["count"] // TP_TRAIN_STEPS
            mb = ar["bytes"] / TP_TRAIN_STEPS / 1e6
            ms = ar["seconds"] / TP_TRAIN_STEPS * 1e3
            print(f"    of which over pipe: all_reduce {calls} calls, "
                  f"{mb:.2f} MB a step (the replicated leaves' grads, the "
                  f"loss, the norm), {ms:.1f} ms a step, busbw "
                  f"{ar['busbw_GBps']:.3f} GB/s")
        out[key] = r0["launches"]
    # bounding the micro batches in flight is what 1F1B is for
    a = [res["pipe4_1f1b"] for res in ranks if res["pipe4_1f1b"]["stage_id"]
         == 0]
    b = [res["pipe4_gpipe"] for res in ranks
         if res["pipe4_gpipe"]["stage_id"] == 0]
    for x, y in zip(a, b):
        check(x["act_peak"] <= y["act_peak"],
              f"phase 33: 1F1B's schedule peak on stage 0 {x['act_peak']} "
              f"above gpipe's {y['act_peak']}")
    from deepspeed_tpu_torch.runtime.pipe.schedule import TrainSchedule
    m = a[0]["micro_batches"]
    print(f"  stage 0's schedule peak at {{pipe 4}}: 1F1B "
          f"{a[0]['act_peak'] / 2**20:.1f} MiB against gpipe's "
          f"{b[0]['act_peak'] / 2**20:.1f} MiB (1F1B's buffers hold at "
          f"most {TrainSchedule(m, 4, 0).num_pipe_buffers} micro batches "
          f"on stage 0, gpipe all {m})")
    for key in ("pipe4_1f1b", "pipe4_gpipe"):
        bub = ranks[0][key]["bubble"]
        m1, m2 = bub["micro_counts"]
        print(f"  bubble fit {bub['schedule']} at {{pipe 4}}: "
              f"{bub['bubble_frac']:.4f} of the step (M {m1} and {m2}: "
              f"{bub['step_time_s']:.3f} s at M {m2}, {bub['per_micro_s']:.4f}"
              f" s a micro batch; the schedule alone, without the exit "
              f"reductions; analytic (S - 1) / (M + S - 1) = "
              f"{3 / (m2 + 3):.4f}); the fit took "
              f"{ranks[0][key]['bubble_s']:.1f} s")
    return out


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: every kernel in ``deepspeed_tpu_torch/csrc`` with ``nvcc``
   (timed as set-up);
3. each kernel against its plain PyTorch version at the slice's shapes
   (serving: GPT-3 6.7B heads, H=32, D=128; training: GPT-2 125M
   attention, B*H = 64 x 12, T = 1024, D = 64; bf16), with its time, the
   plain version's time, one PyTorch library call's time where one
   computes the same function, and the least time the card could take;
4. ``init_inference(TransformerLM(gpt2_config("6.7b")))`` with random
   weights from seed 0, then ``generate()`` on 8 prompts of 128 tokens,
   64 new tokens, greedy: every decode step goes through kernel B5;
   then ``forward()`` on the same prompts through kernel B1, its
   last-position logits checked against ``generate()``'s prefill;
5. the continuous-batching server on the same engine: 16 greedy requests
   with prompt lengths 16-512, 32 new tokens each, drained with
   ``run()``: decode through kernel B6, prompt chunks through kernel B7;
   first-step logits of 4 requests checked against ``generate()``'s;
6. training: ``initialize`` on GPT-2 125M (all 12 layers, seq 1024,
   ``remat="full"``, flash attention, fused loss head at chunk 256) with
   ``bench.py``'s config (micro batch 64, AdamW, bf16 over f32 masters,
   clipping 1.0), weights from seed 0, 20 ``train_step``s on one seeded
   batch: every layer's forward (twice, with the remat recompute) runs
   kernel B1 and its backward kernel B2; then the same step with plain
   attention at micro batch 8 for 3 steps, checked against the kernels'.

The line before the last holds ``nvidia-smi``'s name and power limit,
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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

#: flash vs plain attention through the whole training step (3 steps at
#: micro batch 8): bf16 activations are rounded at different places in
#: the two attention paths (B1 rounds the probabilities before P.V and
#: writes o once; the plain path rounds the probabilities and the P.V
#: product), and AdamW's first steps amplify small gradient differences
#: (the update is about lr * sign(g)), so the losses must agree to this
#: fraction and the gradient norms to STEP_GNORM_REL_TOL (readings on an
#: H100: at most 1.2e-4 and 2.7e-3).
STEP_LOSS_REL_TOL = 2e-3
STEP_GNORM_REL_TOL = 2e-2

#: lse (float32 in both versions) may differ by the order of the sums
LSE_ATOL = 1e-3

#: the training phase: bench.py's GPT-2 125M step (seq 1024, micro 64)
TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 1024, 64, 20

N_TIMED, N_WARM = 30, 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


#: GPU clock cycles of the spin that keeps the card busy while the host
#: enqueues a timed call (~1 ms at H100 clocks)
SPIN_CYCLES = 2_000_000


def time_ms(fn, torch, flush) -> float:
    """Median device ms of one call of ``fn`` over N_TIMED calls after
    N_WARM, each between two CUDA events.  Before each call the L2 cache
    is flushed (a decode step finds it cold: 32 layers of KV exceed the
    50 MB L2), then a spin kernel holds the stream while the host
    enqueues the call, so the events bracket the call's kernels and not
    the host's launch latency."""
    for _ in range(N_WARM):
        fn()
    times = []
    for _ in range(N_TIMED):
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


def margin(a, b) -> float:
    """Largest |a - b| as a share of the limit at that element: the
    check passes where this is at most 1."""
    a, b = a.float(), b.float()
    return float(((a - b).abs()
                  / (KERNEL_ATOL + KERNEL_RTOL * b.abs())).max())


def agree(name, got, want, fault) -> dict:
    """Hold a kernel's output against its plain version, and check that
    the limit catches the planted fault ``fault`` (the plain version with
    one tail row left out) on the same inputs."""
    check(bool(got.isfinite().all()), f"{name}: non-finite output")
    err, m = max_err(got, want), margin(got, want)
    check(m <= 1.0, f"{name}: max |err| {err} ({m:.3g} of the limit)")
    fm = margin(fault, want)
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

    # B5: dense decode at the generate() shape (8 rows, cache 192) and a
    # long cache; lengths full and not a multiple of any chunk; rows past
    # the length hold NaN (so the planted fault at length - 1 reads none)
    b5 = []
    for S, length in ((192, 192), (192, 130), (1024, 1024), (1024, 1000)):
        B = 8
        q, k, v = randn(B, H, D), randn(B, S, H, D), randn(B, S, H, D)
        k[:, length:] = float("nan")
        v[:, length:] = float("nan")
        got = DA.decode_attention(q, k, v, length)
        want = DA.decode_attention_plain(q, k, v, length)
        fault = DA.decode_attention_plain(q, k, v, length - 1)
        torch.cuda.synchronize()
        acc = agree(f"B5 S={S} len={length}", got, want, fault)
        ms = time_ms(lambda: DA.decode_attention(q, k, v, length), torch,
                     flush)
        plain = time_ms(lambda: DA.decode_attention_plain(q, k, v, length),
                        torch, flush)
        kt = k[:, :length].transpose(1, 2)
        vt = v[:, :length].transpose(1, 2)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt), torch, flush)
        nbytes = 2 * B * length * H * D * 2 + 2 * B * H * D * 2
        bnd, by = bound_ms(nbytes, 4.0 * B * H * length * D)
        b5.append(dict(case=f"B={B} S={S} length={length}", **acc,
                       ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by))
    results["decode_attention"] = b5

    # B6: 8 slots of ragged lengths, two inactive, pool of 512 x 16-token
    # blocks, 64 pages per table; a NaN block sits in slot 2's table just
    # past its length and every unused row of a partly filled page is NaN
    NB, BLK, NP = 512, 16, 64
    lengths = [1, 17, 200, 513, 0, 96, 0, 255]
    pk, pv = randn(NB, BLK, H, D), randn(NB, BLK, H, D)
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
    tables = tables.to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = randn(8, H, D)
    got = PA.paged_decode_attention(q, pk, pv, lens, tables)
    want = PA.paged_decode_attention_plain(q, pk, pv, lens, tables)
    fault = PA.paged_decode_attention_plain(
        q, pk, pv, (lens - (lens > 0).int()).int(), tables)
    torch.cuda.synchronize()
    acc = agree("B6", got, want, fault)
    check(float(got[4].abs().max()) == 0.0 and
          float(got[6].abs().max()) == 0.0, "B6: inactive slots not zero")
    ms = time_ms(lambda: PA.paged_decode_attention(q, pk, pv, lens, tables),
                 torch, flush)
    plain = time_ms(lambda: PA.paged_decode_attention_plain(
        q, pk, pv, lens, tables), torch, flush)
    rows = sum(lengths)
    bnd, by = bound_ms(2 * rows * H * D * 2 + 2 * 8 * H * D * 2
                       + tables.numel() * 4, 4.0 * rows * H * D)
    results["paged_decode_attention"] = [dict(
        case=f"8 slots, lengths {lengths}", **acc, ms=ms,
        plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by)]

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
        want = PA.paged_prefill_attention_plain(q, pk2, pv2, base, clen,
                                                table)
        fault = PA.paged_prefill_attention_plain(q, pk2, pv2, base,
                                                 clen - 1, table)
        torch.cuda.synchronize()
        acc = agree(f"B7 base={base} len={clen}", got, want, fault)
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
    return results


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
        keep = torch.ones((T, T), dtype=torch.bool, device=dev)
        if causal:
            keep = keep.tril()
            drop = torch.arange(1, T, device=dev)
            keep[drop, drop] = False          # the diagonal key, rows >= 1
        else:
            keep[:, T - 1] = False
        case = f"B*H={BH} T={T} D={D} {'causal' if causal else 'full'}"
        # B1
        o, lse = FA.flash_attention_fwd(q, k, v, causal)
        o_p, lse_p = FA.flash_attention_fwd_plain(q, k, v, causal)
        o_f, _ = FA.flash_attention_fwd_plain(q, k, v, causal, keep=keep)
        torch.cuda.synchronize()
        acc = agree(f"B1 {case}", o, o_p, o_f)
        lse_err = max_err(lse, lse_p)
        check(lse_err <= LSE_ATOL, f"B1 {case}: lse off by {lse_err}")
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
        b1.append(dict(case=case, **acc, lse_err=lse_err, ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by))
        # B2, from the sound forward's o and lse
        got = FA.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
        want = FA.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal)
        fault = FA.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do,
                                             causal, keep=keep)
        again = FA.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
        torch.cuda.synchronize()

        def flat(ts):
            return torch.cat([t.float().flatten() for t in ts])
        acc = agree(f"B2 {case}", flat(got), flat(want), flat(fault))
        rerun = max_err(flat(got), flat(again))
        check(rerun == 0.0, f"B2 {case}: two launches differ by {rerun}")
        del want, fault, again
        ms = time_ms(lambda: FA.flash_attention_bwd(q, k, v, o_p, lse_p, do,
                                                    causal), torch, flush)
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
                       plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by))
    return {"flash_attention_fwd": b1, "flash_attention_bwd": b2}


def main() -> int:
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
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.accelerator import device_report, nvidia_smi_line
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.ops import build
    dev = torch.device("cuda", 0)

    # -- 1. environment ------------------------------------------------
    rep = device_report(dev)
    print(f"card: {rep['nvidia_smi']} (capability {rep['capability']}, "
          f"{rep['sms']} SMs, {rep['memory_bytes'] / 2**30:.1f} GiB)")
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    nv = subprocess.run([build.nvcc_path(), "--version"], check=True,
                        capture_output=True, text=True, timeout=60)
    print("nvcc: " + nv.stdout.strip().splitlines()[-1])

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build()
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    for name, path in libs.items():
        for line in Path(f"{path}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions -----------------------
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    kres = kernel_checks(torch, dev, flush)
    for name, cases in kres.items():
        for c in cases:
            print(f"kernel {name} [{c['case']}]: max|err| "
                  f"{c['max_abs_err']:.3g} = {c['limit_share']:.3g} of the "
                  f"limit (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}); planted "
                  f"fault {c['fault_err']:.3g} = "
                  f"{c['fault_limit_share']:.3g} of it; {c['ms']:.4f} ms, plain "
                  f"{c['plain_ms']:.4f} ms, library "
                  f"{'-' if c['library_ms'] is None else '%.4f' % c['library_ms']}"
                  f" ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
                  + (f"; lse max|err| {c['lse_err']:.3g}"
                     if "lse_err" in c else "")
                  + (f"; two launches differ by {c['rerun_diff']:.3g}"
                     if "rerun_diff" in c else ""))
    del flush

    # -- 4. generate() at GPT-3 6.7B width ------------------------------
    cfg = gpt2_config("6.7b")
    t0 = time.perf_counter()
    eng = init_inference(TransformerLM(cfg), {
        "dtype": "bfloat16", "temperature": 0.0,
        "serving": {"enabled": True, "kv_block_size": 16,
                    "num_kv_blocks": 512, "max_batch_slots": 8,
                    "prefill_chunk_tokens": 256}})
    torch.cuda.synchronize()
    print(f"init: {cfg.num_params() / 1e9:.2f} B params "
          f"({sum(t.numel() * t.element_size() for t in _leaves(eng.params)) / 1e9:.2f} GB bf16) "
          f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (8, 128))
    eng.generate(prompts, max_new_tokens=4)          # warm-up
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
    print(f"generate: 8 x 128-token prompts, 64 new tokens: TTFT "
          f"{stats['ttft_p50_ms']:.1f} ms, decode "
          f"{stats['p50_ms']:.2f} ms/token ({8 * stats['tokens_per_sec']:.0f}"
          f" tokens/s over the batch); B5 launches "
          f"{gen_counts['decode_attention']}")

    device_profile(torch, lambda: eng.generate(prompts, max_new_tokens=16),
                   "generate 8 x 128 prompts, 16 new tokens")

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
    print(f"forward: 8 x 128 prompts in {fwd_s * 1e3:.1f} ms, B1 launches "
          f"{fwd_counts['flash_attention_fwd']}; last-position logits "
          f"max|forward - generate prefill| {fwd_err:.4f} = {fwd_rel:.4f} of "
          f"max|logit| (limit {LOGITS_REL_TOL}), argmax equal on {same} of 8")
    check(fwd_rel <= LOGITS_REL_TOL,
          f"forward/generate logits differ by {fwd_rel:.4f} of their scale")
    del fwd, ref

    # -- 5. serving ------------------------------------------------------
    srv = eng.serving_engine()
    model = srv.model
    first_logits = {}
    mixed = model._apply_paged_mixed

    def recording_mixed(params, cache, dec_tokens, dec_active, chunk_ids,
                        chunk_slot, chunk_start, chunk_len):
        res = mixed(params, cache, dec_tokens, dec_active, chunk_ids,
                    chunk_slot, chunk_start, chunk_len)
        if chunk_len:
            req = srv.scheduler.running[chunk_slot]
            if chunk_start + chunk_len == len(req.prompt):
                first_logits[req.req_id] = res[1].float().cpu()
        return res
    model._apply_paged_mixed = recording_mixed
    lens = rng.integers(16, 513, 16)
    sprompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    build.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=32) for p in sprompts]
    finished = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    srv_counts = dict(build.launch_counts)
    model._apply_paged_mixed = mixed
    check(len(finished) == 16, f"{len(finished)} of 16 requests finished")
    for r in reqs:
        check(r.status is not None and r.status.value == "ok"
              and len(r.output) == 32,
              f"{r.req_id}: status {r.status}, {len(r.output)} tokens")
    check(srv.allocator.num_used == 0,
          f"allocator holds {srv.allocator.num_used} blocks after drain")
    check(srv_counts["paged_decode_attention"] > 0, "B6 never launched")
    check(srv_counts["paged_prefill_attention"] > 0, "B7 never launched")
    ntok = sum(len(r.output) for r in reqs)
    print(f"serving: 16 requests, prompts {int(lens.min())}-"
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
    worst = 0.0
    for i, r in enumerate(reqs):
        ref = eng.generate(np.asarray(r.prompt)[None], max_new_tokens=32)
        same += int(sum(a == b for a, b in zip(r.output, ref[0].tolist())))
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
    print(f"serving streams equal to generate(): {same} of {ntok} tokens "
          f"({100.0 * same / ntok:.1f} %)")

    # fresh prompts of the first 8 lengths for each of device_profile's
    # two runs (the served prompts sit in the prefix cache now)
    bursts = iter([[rng.integers(0, cfg.vocab_size, n).tolist()
                    for n in lens[:8]] for _ in range(2)])

    def serve_burst():
        for p in next(bursts):
            srv.submit(p, max_new_tokens=8)
        srv.run()
    device_profile(torch, serve_burst, "serving 8 requests, 8 new tokens")
    del srv, model, eng
    import gc
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6. training ------------------------------------------------------
    train = train_phase(torch, np)

    # -- result lines ------------------------------------------------------
    replaces = {
        "decode_attention":
            "deepspeed_tpu/ops/transformer/decode_attention.py:56",
        "paged_decode_attention":
            "deepspeed_tpu/ops/transformer/paged_decode_attention.py:143",
        "paged_prefill_attention":
            "deepspeed_tpu/ops/transformer/paged_decode_attention.py:358",
        "flash_attention_fwd":
            "deepspeed_tpu/ops/transformer/flash_attention.py:94",
        "flash_attention_bwd":
            "deepspeed_tpu/ops/transformer/flash_attention.py:300",
    }
    launches = {"decode_attention": gen_counts["decode_attention"],
                "paged_decode_attention":
                    srv_counts["paged_decode_attention"],
                "paged_prefill_attention":
                    srv_counts["paged_prefill_attention"],
                "flash_attention_fwd": train["flash_attention_fwd"],
                "flash_attention_bwd": train["flash_attention_bwd"]}
    # the main-path case of each kernel: B5 at generate()'s last step
    # (cache 192), B6 at 8 ragged slots, B7 at a 256-chunk on 256 rows,
    # B1/B2 at the training shape (T = 1024, causal)
    main_case = {"decode_attention": 0, "paged_decode_attention": 0,
                 "paged_prefill_attention": 1, "flash_attention_fwd": 0,
                 "flash_attention_bwd": 0}
    kernels = []
    for name in build.KERNELS:
        c = kres[name][main_case[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
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


def train_phase(torch, np) -> dict:
    """GPT-2 125M at bench.py's configuration for TRAIN_STEPS steps on one
    seeded batch (B1/B2 launches counted over exactly those steps), its
    profile, then flash against plain attention at micro batch 8."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import (TransformerLM,
                                                        gpt2_config)
    from deepspeed_tpu_torch.ops import build

    def make(attn_impl, micro):
        cfg = gpt2_config("125m", max_seq_len=TRAIN_SEQ, remat="full",
                          attn_impl=attn_impl, loss_chunk=256)
        config = {       # bench.py:171-180
            "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 6e-4, "weight_decay": 0.1}},
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 0},
            "gradient_clipping": 1.0,
            "steps_per_print": 0,
        }
        eng, _, _, _ = initialize(model=TransformerLM(cfg), config=config)
        return cfg, eng

    cfg, eng = make("flash", TRAIN_MICRO)
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, cfg.vocab_size,
                                     (TRAIN_MICRO, TRAIN_SEQ),
                                     dtype=np.int32)}
    n_params = eng.num_parameters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [eng.train_step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"training: non-finite loss or grad norm {losses} {gnorms}")
    check(losses[-1] < losses[0],
          f"training: loss did not fall ({losses[0]} -> {losses[-1]})")
    want = {"flash_attention_fwd": 2 * cfg.num_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.num_layers * TRAIN_STEPS}
    for name, n in want.items():
        check(counts[name] == n, f"training: {name} launches "
                                 f"{counts[name]} != {n}")
    step_s = wall / TRAIN_STEPS
    tok_s = TRAIN_MICRO * TRAIN_SEQ / step_s
    # bench.py:212-215: 6 N per token plus the attention term
    flops_per_tok = 6 * n_params + 12 * cfg.num_layers * cfg.d_model \
        * TRAIN_SEQ
    mfu = tok_s * flops_per_tok / BF16_FLOPS
    print(f"training: GPT-2 125M ({n_params / 1e6:.1f} M params), seq "
          f"{TRAIN_SEQ}, micro {TRAIN_MICRO}, remat full, flash, fused "
          f"head chunk 256, AdamW bf16/f32: {TRAIN_STEPS} steps in "
          f"{wall:.2f} s = {step_s * 1e3:.1f} ms/step (the first step "
          f"included), {tok_s:.0f} tokens/s, MFU {100 * mfu:.2f} % of "
          f"989 TF/s; peak memory {peak:.1f} GiB")
    print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f} (every step: "
          f"{' '.join(f'{x:.3f}' for x in losses)}); grad norm "
          f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f}")
    print(f"  launches over {TRAIN_STEPS} steps: B1 "
          f"{counts['flash_attention_fwd']} "
          f"({counts['flash_attention_fwd'] // TRAIN_STEPS} per step), B2 "
          f"{counts['flash_attention_bwd']} "
          f"({counts['flash_attention_bwd'] // TRAIN_STEPS} per step)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.train_step(batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"  3 more steps (warm): {warm_ms:.1f} ms/step")
    head = loss_head_ms(torch, eng, batch)
    print(f"  loss head alone (fused, chunk 256, bf16 logits widened to "
          f"f32, f32 backward products): forward {head['fwd']:.1f} ms, "
          f"forward + backward {head['both']:.1f} ms = "
          f"{100 * head['both'] / warm_ms:.1f} % of the warm step")
    device_profile(torch, lambda: [eng.train_step(batch) for _ in range(2)],
                   "training 2 steps")
    out = {"flash_attention_fwd": counts["flash_attention_fwd"],
           "flash_attention_bwd": counts["flash_attention_bwd"]}
    del eng, metrics
    torch.cuda.empty_cache()

    # the whole step with B1/B2 against plain attention
    small = {"input_ids": batch["input_ids"][:8]}
    runs = {}
    for impl in ("flash", "xla"):
        _, e = make(impl, 8)
        ms = [e.train_step(small) for _ in range(3)]
        runs[impl] = ([float(m["loss"]) for m in ms],
                      [float(m["grad_norm"]) for m in ms])
        del e, ms
    for i in range(3):
        (lf, gf), (lx, gx) = ((runs[k][0][i], runs[k][1][i])
                              for k in ("flash", "xla"))
        print(f"  step {i} at micro 8: loss flash {lf:.5f} plain {lx:.5f} "
              f"({abs(lf - lx) / abs(lx) / STEP_LOSS_REL_TOL:.3g} of the "
              f"limit); grad norm flash {gf:.4f} plain {gx:.4f} "
              f"({abs(gf - gx) / abs(gx) / STEP_GNORM_REL_TOL:.3g} of the "
              f"limit)")
        check(abs(lf - lx) <= STEP_LOSS_REL_TOL * abs(lx),
              f"training step {i}: loss flash {lf} vs plain {lx}")
        check(abs(gf - gx) <= STEP_GNORM_REL_TOL * abs(gx),
              f"training step {i}: grad norm flash {gf} vs plain {gx}")
    torch.cuda.empty_cache()
    return out


def loss_head_ms(torch, eng, batch) -> dict:
    """Device ms of the loss head alone (``nll_from_hidden`` on the
    engine's bf16 params), forward and forward + backward, at the step's
    shape: hidden states [micro, seq, d_model] from a seeded generator."""
    dev = eng.device
    g = torch.Generator(device=dev)
    g.manual_seed(99)
    w = eng.state["params"]["embed"]["embedding"].detach().requires_grad_(
        True)
    x = torch.randn((TRAIN_MICRO, TRAIN_SEQ, eng.model.config.d_model),
                    generator=g, device=dev).to(torch.bfloat16)
    x.requires_grad_(True)
    labels = torch.as_tensor(batch["input_ids"]).long().to(dev)

    def nll():
        return eng.model.nll_from_hidden(
            {"embed": {"embedding": w.to(torch.bfloat16)}}, x, labels)

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


def device_profile(torch, fn, label: str) -> None:
    """Run ``fn`` once unprofiled for its wall time, then once under
    ``torch.profiler`` (CUDA activity only) for the kernel time, and
    print the card's busy share (kernel time over the unprofiled wall
    time) and the kernels that took the most time."""
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


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: every kernel in ``deepspeed_tpu_torch/csrc`` with ``nvcc``
   (timed as set-up);
3. each kernel against its plain PyTorch version at the slice's shapes
   (GPT-3 6.7B heads: H=32, D=128, bf16), with its time, the plain
   version's time, one PyTorch library call's time where one computes
   the same function, and the least time the card could take;
4. ``init_inference(TransformerLM(gpt2_config("6.7b")))`` with random
   weights from seed 0, then ``generate()`` on 8 prompts of 128 tokens,
   64 new tokens, greedy: every decode step goes through kernel B5;
5. the continuous-batching server on the same engine: 16 greedy requests
   with prompt lengths 16-512, 32 new tokens each, drained with
   ``run()``: decode through kernel B6, prompt chunks through kernel B7;
   first-step logits of 4 requests checked against ``generate()``'s.

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
#: reference logits' largest magnitude.
LOGITS_REL_TOL = 0.05

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
    return results


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
                  f" ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
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

    # -- result lines ------------------------------------------------------
    replaces = {
        "decode_attention":
            "deepspeed_tpu/ops/transformer/decode_attention.py:56",
        "paged_decode_attention":
            "deepspeed_tpu/ops/transformer/paged_decode_attention.py:143",
        "paged_prefill_attention":
            "deepspeed_tpu/ops/transformer/paged_decode_attention.py:358",
    }
    launches = {"decode_attention": gen_counts["decode_attention"],
                "paged_decode_attention":
                    srv_counts["paged_decode_attention"],
                "paged_prefill_attention":
                    srv_counts["paged_prefill_attention"]}
    # the main-path case of each kernel: B5 at generate()'s last step
    # (cache 192), B6 at 8 ragged slots, B7 at a 256-chunk on 256 rows
    main_case = {"decode_attention": 0, "paged_decode_attention": 0,
                 "paged_prefill_attention": 1}
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

#!/usr/bin/env python3
"""Time source variants of the bf16 decode kernel B5 on one CUDA card.

Run from the root of a checkout, after (or without) ``chip_smoke.py``::

    python3 b5_variants.py

Each variant is ``deepspeed_tpu_torch/csrc/decode_attention.cu`` with one
design choice changed, compiled by ``nvcc`` with the port's flags into
``deepspeed_tpu_torch/_build/variants/`` and swapped in under the
wrapper.  Every variant is held against the plain version (products
removed excepted) and timed as ``chip_smoke.py`` times kernels (CUDA
events, L2 flushed, host latency hidden), in the order listed and then
reversed, beside SDPA at kv-head width, at the decode shapes of phase 3:
GPT-3 6.7B's (B 8, H = Hkv 32, D 128; caches 192 and 1000) and
TinyLlama-1.1B's (H 32 over Hkv 4, D 64, cache 192).

The source as built is also timed with its positions cut into 2 and 3
splits (ranks of one cluster) where ``cluster_plan`` gives another
count, by calling the library's C symbol with that plan directly.

Variants: ``as built`` (the source as it is), ``64-row chunks at D 128``,
``4 stages``, ``16-row chunks, 6 stages``, ``no cluster at 1 split``
(a plain launch when the plan has one split), and ``products removed``
(the loads, barriers and merge alone: not a result, a floor).

Beside each device time it prints the host's microseconds a call (the
median of 7 runs of 200 calls queued back to back), alone and
under ``torch.profiler`` (CPU and CUDA activities), the cost a host-paced
decode step pays for each B5 call.
"""
from __future__ import annotations

import contextlib
import ctypes
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

ROWS = "static constexpr int kRows = D <= 64 ? 64 : 32;"
STAGES = "constexpr int kStages = 3;"
LAUNCH = "  cudaLaunchConfig_t cfg = {};"
SCORES = "    for (int base = 0; base < pairs; base += items) {"
PV = "    if (pv_active) {"

VARIANTS = {
    "as built": (),
    "64-row chunks at D 128": (
        (ROWS, "static constexpr int kRows = D <= 128 ? 64 : 32;"),),
    "4 stages": ((STAGES, "constexpr int kStages = 4;"),),
    "16-row chunks, 6 stages": (
        (ROWS, "static constexpr int kRows = D <= 64 ? 64 : 16;"),
        (STAGES, "constexpr int kStages = 6;")),
    "no cluster at 1 split": ((LAUNCH, """  if (nsplit == 1) {
    kernel<<<dim3(1, Hkv, B), kThreads, smem, stream>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), S, H,
        Hkv, length, split_len, sm_scale);
    return static_cast<int>(cudaGetLastError());
  }
""" + LAUNCH),),
    "products removed": (
        (SCORES, "    if (valid < 0) " + SCORES.lstrip()),
        (PV, "    if (pv_active && valid < 0) {")),
}

#: (S, length, H, Hkv, D) at batch 8
CASES = ((192, 192, 32, 32, 128), (1024, 1000, 32, 32, 128),
         (192, 192, 32, 4, 64))


def build_variants(build) -> dict:
    src = (build.CSRC / "decode_attention.cu").read_text()
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"b5_variants: {name}: {old!r} not in the "
                                 f"source")
            text = text.replace(old, new)
        cu = out / f"decode_attention_v{i}.cu"
        cu.write_text(text)
        lib = out / f"libdecode_attention_v{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I",
             str(build.CSRC), "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"b5_variants: {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def host_us(torch, fn, n=200, trials=7) -> tuple:
    """Host microseconds a call of ``fn``, the median over ``trials`` runs
    of ``n`` calls queued back to back, alone and under
    ``torch.profiler``."""
    prof = torch.profiler
    out = []
    for traced in (False, True):
        runs = []
        for _ in range(trials):
            torch.cuda.synchronize()
            ctx = (prof.profile(activities=[prof.ProfilerActivity.CPU,
                                            prof.ProfilerActivity.CUDA])
                   if traced else contextlib.nullcontext())
            with ctx:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
            runs.append((t1 - t0) / n * 1e6)
        out.append(sorted(runs)[trials // 2])
    return tuple(out)


def launch_at(torch, build, DA, q, k, v, length, nsplit):
    """The bf16 B5 with its ``length`` positions cut into about ``nsplit``
    splits of whole 64-row blocks, past ``cluster_plan``; returns the
    output and the plan (splits, positions a split)."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rows = DA._MIN_SPLIT_ROWS
    split_len = -(-(-(-length // nsplit)) // rows) * rows
    plan = (-(-length // split_len), split_len)
    out = torch.empty_like(q)
    lib, fn = DA._kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            None, b, s, h, hkv, d, 1, length, *plan, d ** -0.5,
            build.DTYPE_CODES[torch.bfloat16], build.current_stream(q.device))
    build.check_launch(lib, DA._SYM, rc)
    return out, plan


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("b5_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as CS
    from deepspeed_tpu_torch.accelerator import nvidia_smi_line
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import decode_attention as DA
    print(nvidia_smi_line(0))
    libs = build_variants(build)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    F = torch.nn.functional
    data = {}
    for S, L, H, Hkv, D in CASES:
        data[S, L, Hkv] = tuple(
            torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            for shape in ((8, H, D), (8, S, Hkv, D), (8, S, Hkv, D)))
        q, k, v = data[S, L, Hkv]
        kt, vt = k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)
        sdpa = CS.time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, enable_gqa=True), torch, flush)
        print(f"S {S} length {L} H {H} Hkv {Hkv} D {D}: plan "
              f"{DA.cluster_plan(8, Hkv, L, sms)}, SDPA {sdpa:.4f} ms")
    names = list(VARIANTS)
    built = build._libs.get("decode_attention")
    try:
        for name in names + names[::-1]:
            build._libs["decode_attention"] = libs[name]
            DA._kernel.cache_clear()
            for S, L, H, Hkv, D in CASES:
                q, k, v = data[S, L, Hkv]
                got = DA.decode_attention(q, k, v, L)
                share = CS.margin(got, DA.decode_attention_plain(q, k, v, L))
                if name != "products removed":
                    CS.check(share <= 1.0, f"{name}: off the limit")
                ms = CS.time_ms(lambda: DA.decode_attention(q, k, v, L),
                                torch, flush)
                us, us_traced = host_us(
                    torch, lambda: DA.decode_attention(q, k, v, L))
                print(f"{name:24s} S {S} length {L} Hkv {Hkv} D {D}: "
                      f"{ms:.4f} ms; host {us:.1f} us a call, "
                      f"{us_traced:.1f} under torch.profiler")
                for nsplit in ((2, 3) if name == "as built" else ()):
                    got, plan = launch_at(torch, build, DA, q, k, v, L,
                                          nsplit)
                    if plan == DA.cluster_plan(8, Hkv, L, sms):
                        continue
                    CS.check(CS.margin(got, DA.decode_attention_plain(
                        q, k, v, L)) <= 1.0, f"{plan}: off the limit")
                    ms = CS.time_ms(lambda: launch_at(
                        torch, build, DA, q, k, v, L, nsplit), torch, flush)
                    print(f"{name:24s} S {S} length {L} Hkv {Hkv} D {D} at "
                          f"{plan[0]} split(s) of {plan[1]}: {ms:.4f} ms")
    finally:
        if built is None:
            build._libs.pop("decode_attention", None)
        else:
            build._libs["decode_attention"] = built
        DA._kernel.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())

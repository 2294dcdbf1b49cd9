#!/usr/bin/env python3
"""Time source variants of the bf16 paged kernels B6 and B7 on one CUDA
card.

Run from the root of a checkout, after (or without) ``chip_smoke.py``::

    python3 paged_variants.py

Each variant is ``deepspeed_tpu_torch/csrc/paged_decode_attention.cu``
(B6) or ``paged_prefill_attention.cu`` (B7) with one design choice
changed, compiled by ``nvcc`` with the port's flags into
``deepspeed_tpu_torch/_build/variants/`` and swapped in under the
wrapper.  Every variant is held against the plain version (products
removed excepted) and timed as ``chip_smoke.py`` times kernels (CUDA
events, L2 flushed, host latency hidden), in the order listed and then
reversed, at kv_bits 0, 8 and 4, at phase 3's shapes: B6's 8 slots
(lengths 1, 17, 200, 513, 0, 96, 0, 255 over a table of 64 pages of 16
rows) at GPT-3 6.7B's heads (H = Hkv 32, D 128) and TinyLlama-1.1B's (H
32 over Hkv 4, D 64); B7's chunk of 256 at base 256 at both.

B6 as built is also timed with the table cut into 4, 2 and 1 ranks (the
wrapper's ``paged_split_plan`` gives 8 ranks of 128 rows) by calling the
library's C symbol with that plan directly (the wrapper has no knob for
it), and on the same grid with every slot inactive and with the longest
slot (513 rows) alone: what launching the grid costs, and what the
longest walk costs.

Variants: B6 ``as built``, ``16-row chunks at D 128``, ``3 stages at
every size`` and ``2 stages at every size`` (of the ``cp.async`` ring; as
built it rings 2 stages of 16 KB or more, else 3), ``products
removed`` (the loads, barriers and merge alone: not a result, a floor); B7 ``as built``
(64-row query tiles, 4 warps) and ``32-row query tiles`` (2 warps, twice
the blocks).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

B6_ROWS = "static constexpr int kRows = D <= 64 ? 64 : 32;"
B6_SCORES = "    for (int base = 0; base < pairs; base += items) {"
B6_PV = "    if (pv_active) {"
B6_STAGES = "constexpr int kStages = 3;"
B6_BIG = "constexpr int kBigStage = 16384;"
B7_WARPS = "constexpr int kMmaWarps = 4;"

#: (kernel library, variant name, source substitutions)
VARIANTS = (
    ("paged_decode_attention", "as built", ()),
    ("paged_decode_attention", "16-row chunks at D 128", (
        (B6_ROWS, "static constexpr int kRows = D <= 64 ? 64 : 16;"),)),
    ("paged_decode_attention", "3 stages at every size", (
        (B6_BIG, "constexpr int kBigStage = 1 << 30;"),)),
    ("paged_decode_attention", "2 stages at every size", (
        (B6_STAGES, "constexpr int kStages = 2;"),)),
    ("paged_decode_attention", "products removed", (
        (B6_SCORES, "    if (valid < 0) " + B6_SCORES.lstrip()),
        (B6_PV, "    if (pv_active && valid < 0) {"))),
    ("paged_prefill_attention", "as built", ()),
    ("paged_prefill_attention", "32-row query tiles", (
        (B7_WARPS, "constexpr int kMmaWarps = 2;"),)),
)

#: phase 3's paged pool (blocks, block size, pages a table), slots' lengths
POOL = (512, 16, 64)
LENGTHS = [1, 17, 200, 513, 0, 96, 0, 255]
#: (H, Hkv, D): GPT-3 6.7B's heads and TinyLlama-1.1B's
HEADS = ((32, 32, 128), (32, 4, 64))


def build_variants(build) -> dict:
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (lib_name, name, subs) in enumerate(VARIANTS):
        text = (build.CSRC / f"{lib_name}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"paged_variants: {name}: {old!r} not in "
                                 f"{lib_name}.cu")
            text = text.replace(old, new)
        cu = out / f"{lib_name}_v{i}.cu"
        cu.write_text(text)
        lib = out / f"lib{lib_name}_v{i}.so"
        procs[lib_name, name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I",
             str(build.CSRC), "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"paged_variants: {key} failed to build:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def decode_at(torch, build, PA, q, kp, vp, lens, tables, quant, nsplit):
    """The bf16 B6 with the table cut into ``nsplit`` ranks of whole
    pages, past ``paged_split_plan``; returns (output, plan)."""
    b, h, d = q.shape
    _, blk, hkv, _ = kp.shape
    npages = tables.shape[1]
    pages = -(-npages // nsplit)
    plan = (-(-npages // pages), pages * blk)
    out = torch.empty_like(q)
    bits = quant.get("kv_bits", 0)
    lib, fn = PA._decode_kernel(bool(bits))
    scales = ((quant["k_scale"].data_ptr(), quant["v_scale"].data_ptr())
              if bits else ())
    rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales,
            lens.data_ptr(), tables.data_ptr(), out.data_ptr(), b, h, hkv, d,
            1, blk, npages, *plan, d ** -0.5,
            build.DTYPE_CODES[torch.bfloat16], *((bits,) if bits else ()),
            build.current_stream(q.device))
    build.check_launch(lib, PA._DEC_SYM, rc)
    return out, plan


def cases(torch, dev):
    """Per (H, Hkv, D) and kv_bits: B6's and B7's inputs."""
    import chip_smoke as CS
    from deepspeed_tpu_torch.ops.quantizer import kv_quantize
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    out = []
    NB, BLK, NP = POOL
    for h, hkv, d in HEADS:
        pk, pv, tables, lens, perm = CS.paged_decode_case(torch, randn, dev,
                                                          hkv, d)
        q, qc = randn(8, h, d), randn(256, h, d)
        # B7 reads the first 64 blocks of the shuffled order as one slot's
        # 512 rows: the NaN tails of B6's slots there become values
        table = torch.tensor(perm[:NP], dtype=torch.int32, device=dev)
        for bits in (0, 8, 4):
            pools = {}
            for key, (k, v) in (("B6", (pk, pv)),
                                ("B7", (pk.nan_to_num(0.0),
                                        pv.nan_to_num(0.0)))):
                if bits:
                    kq, ks = kv_quantize(k, bits)
                    vq, vs = kv_quantize(v, bits)
                    pools[key] = (kq, vq, dict(k_scale=ks, v_scale=vs,
                                               kv_bits=bits))
                else:
                    pools[key] = (k, v, {})
            out.append((f"H {h} Hkv {hkv} D {d} kv_bits {bits}", q, qc,
                        pools, lens, tables, table))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as CS
    from deepspeed_tpu_torch.accelerator import nvidia_smi_line
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import (
        paged_decode_attention as PA)
    print(nvidia_smi_line(0))
    libs = build_variants(build)
    dev = torch.device("cuda", 0)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    data = cases(torch, dev)
    built = {k: build._libs.get(k) for k in ("paged_decode_attention",
                                             "paged_prefill_attention")}
    keys = [(lib, name) for lib, name, _ in VARIANTS]
    try:
        for lib_name, name in keys + keys[::-1]:
            build._libs[lib_name] = libs[lib_name, name]
            PA._decode_kernel.cache_clear()
            PA._prefill_kernel.cache_clear()
            floor = name == "products removed"
            for label, q, qc, pools, lens, tables, table in data:
                kp, vp, quant = pools["B6" if lib_name.startswith(
                    "paged_decode") else "B7"]
                if lib_name == "paged_decode_attention":
                    def run():
                        return PA.paged_decode_attention(q, kp, vp, lens,
                                                         tables, **quant)
                    want = PA.paged_decode_attention_plain(
                        q, kp, vp, lens, tables, **quant)
                    what = "B6 8 slots"
                else:
                    def run():
                        return PA.paged_prefill_attention(
                            qc, kp, vp, 256, 256, table, **quant)
                    want = PA.paged_prefill_attention_plain(
                        qc, kp, vp, 256, 256, table, **quant)
                    what = "B7 C 256 base 256"
                share = CS.margin(run(), want)
                if not floor:
                    CS.check(share <= 1.0, f"{name} {label}: off the limit")
                ms = CS.time_ms(run, torch, flush)
                print(f"{what} {name:24s} {label}: {ms:.4f} ms")
                if lib_name != "paged_decode_attention" or name != "as built":
                    continue
                for nsplit in (4, 2, 1):
                    got, plan = decode_at(torch, build, PA, q, kp, vp, lens,
                                          tables, quant, nsplit)
                    CS.check(CS.margin(got, want) <= 1.0,
                             f"{plan}: off the limit")
                    ms = CS.time_ms(lambda: decode_at(
                        torch, build, PA, q, kp, vp, lens, tables, quant,
                        nsplit), torch, flush)
                    print(f"{what} {name:24s} {label} at {plan[0]} rank(s) "
                          f"of {plan[1]} rows: {ms:.4f} ms")
                # what launching the grid costs: every slot inactive, and
                # the longest slot (513 rows) alone
                for pattern, keep in (("every slot inactive", ()),
                                      ("the 513-row slot alone", (3,))):
                    ln = torch.tensor([n if i in keep else 0
                                       for i, n in enumerate(LENGTHS)],
                                      dtype=torch.int32, device=dev)
                    ms = CS.time_ms(lambda: PA.paged_decode_attention(
                        q, kp, vp, ln, tables, **quant), torch, flush)
                    print(f"{what} {name:24s} {label}, {pattern}: "
                          f"{ms:.4f} ms")
    finally:
        for k, lib in built.items():
            if lib is None:
                build._libs.pop(k, None)
            else:
                build._libs[k] = lib
        PA._decode_kernel.cache_clear()
        PA._prefill_kernel.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())

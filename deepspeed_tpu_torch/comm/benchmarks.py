"""Collective benchmarks (``ds_bench`` parity).

Counterpart of ``deepspeed_tpu/comm/benchmarks.py``: sweep message sizes
for each collective of ``comm.py`` over one mesh axis and report latency
and bus bandwidth.  Every rank calls ``run_benchmark`` (a collective
program); the time is measured with CUDA events around the timed calls
on the card (the host clock off it), after warm-up calls.

busbw formulas (ring algorithms, reference ``communication/utils.py``;
``size`` = the buffer each rank contributes):
  all_reduce:      2 * size * (n-1)/n / t
  all_gather:      size * (n-1)/n / t
  reduce_scatter:  size * (n-1)/n / t
  all_to_all:      size * (n-1)/n / t

Run as ``python -m deepspeed_tpu_torch.comm.benchmarks`` in each rank
of a torchrun-style world (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``); rank 0 prints one JSON line per collective and size.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import torch

from . import comm

_BUSBW = {
    "all_reduce": lambda size, t, n: 2 * size * (n - 1) / n / t,
    "all_gather": lambda size, t, n: size * (n - 1) / n / t,
    "reduce_scatter": lambda size, t, n: size * (n - 1) / n / t,
    "all_to_all": lambda size, t, n: size * (n - 1) / n / t,
}


def _op(name: str, axis: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "all_reduce":
        return lambda x: comm.all_reduce(x, comm.ReduceOp.SUM, axis)
    if name == "all_gather":
        return lambda x: comm.all_gather(x, axis)
    if name == "reduce_scatter":
        return lambda x: comm.reduce_scatter(x, comm.ReduceOp.SUM, axis)
    if name == "all_to_all":
        return lambda x: comm.all_to_all_single(x, axis)
    raise ValueError(f"unknown collective {name}")


def run_benchmark(collective: str, sizes_mb: List[float],
                  axis: str = "data", trials: int = 5, warmups: int = 2,
                  device: Optional[torch.device] = None) -> List[Dict]:
    """Per size: ``{"collective", "size_bytes", "latency_ms",
    "busbw_GBps", "timer"}`` (``timer``: "cuda_events" or "host")."""
    n = comm.axis_size(axis)
    if n < 2:
        raise ValueError(f"axis {axis!r} has size {n}; need >= 2")
    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    fn = _op(collective, axis)
    results = []
    for mb in sizes_mb:
        # n*n alignment: reduce-scatter and all-to-all split by n
        elems = max(int(mb * 2 ** 20 // 4), n * n) // (n * n) * (n * n)
        x = torch.arange(elems, dtype=torch.float32, device=device)
        for _ in range(max(warmups, 1)):
            fn(x.clone())
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(trials):
            fn(x)
        if cuda:
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / trials
        else:
            dt = (time.perf_counter() - t0) / trials
        size = elems * 4
        results.append({
            "collective": collective, "size_bytes": size,
            "latency_ms": dt * 1e3,
            "busbw_GBps": _BUSBW[collective](size, dt, n) / 1e9,
            "timer": "cuda_events" if cuda else "host"})
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch.comm.benchmarks",
        description="collective busbw sweep (reference bin/ds_bench)")
    p.add_argument("--collective", default="all_reduce",
                   choices=sorted(_BUSBW) + ["all"])
    p.add_argument("--axis", default="data")
    p.add_argument("--sizes-mb", default="1,4,16,64")
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--backend", default="nccl",
                   choices=list(comm.SUPPORTED_DIST_BACKENDS))
    args = p.parse_args(argv)
    comm.init_distributed(args.backend)
    sizes = [float(s) for s in args.sizes_mb.split(",")]
    names = sorted(_BUSBW) if args.collective == "all" else [args.collective]
    device = (torch.device("cuda", comm.get_local_rank())
              if args.backend == "nccl" else None)
    for name in names:
        for row in run_benchmark(name, sizes, axis=args.axis,
                                 trials=args.trials, device=device):
            if comm.get_rank() == 0:
                print(json.dumps(row))
    comm.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

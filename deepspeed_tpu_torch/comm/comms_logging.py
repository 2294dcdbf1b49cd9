"""Communication volume and time logging.

Counterpart of ``deepspeed_tpu/comm/comms_logging.py`` (``CommsLogger``,
``calc_bw_factor``): op counts, payload bytes and the bus-bandwidth
factor per op and axis.  The JAX package records volumes at trace time
and leaves latency to the profiler; the port's collectives run eagerly,
so each one is also timed: with a pair of CUDA events on the card
(resolved when a summary is read, so recording never waits for the
card) and with the host clock on the CPU.  From bytes and seconds come
the algorithmic rate (payload / time) and the bus rate (algorithmic x
``calc_bw_factor``), the reference's ``get_bw``.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


def calc_bw_factor(op_name: str, n: int) -> float:
    """Bus-bandwidth correction factor: volume on the wire / payload (the
    reference's ``get_bw``, ``utils/comms_logging.py:31``)."""
    if n <= 1:
        return 0.0
    if op_name == "all_reduce":
        return 2 * (n - 1) / n
    if op_name in ("all_gather", "reduce_scatter", "all_to_all"):
        return (n - 1) / n
    return 1.0


class _Timer:
    """One op's time: CUDA events around it on the card, the host clock
    elsewhere.  ``seconds()`` synchronizes on the end event when read."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.t1 = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda:
            self.end.synchronize()
            return self.start.elapsed_time(self.end) / 1e3
        return self.t1 - self.t0


class CommsLogger:
    def __init__(self, verbose: bool = False, debug: bool = False,
                 prof_all: bool = True, prof_ops=None):
        self.enabled = False
        self.verbose = verbose
        self.debug = debug
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.comms_dict: dict = defaultdict(lambda: defaultdict(
            lambda: {"count": 0, "volume": 0, "timers": []}))

    def configure(self, enabled: bool = True, **kw) -> None:
        self.enabled = enabled
        for k, v in kw.items():
            if v is not None and hasattr(self, k):
                setattr(self, k, v)

    def wants(self, op_name: str) -> bool:
        return self.enabled and (self.prof_all or op_name in self.prof_ops)

    def start(self, device: torch.device) -> _Timer:
        return _Timer(device)

    def record(self, op_name: str, nbytes: int, axis_name: str,
               n: int = 0, timer: Optional[_Timer] = None) -> None:
        """``nbytes``: the payload one rank contributes; ``n``: the axis
        size; ``timer``: the op's stopped timer, if it was timed."""
        if not (self.prof_all or op_name in self.prof_ops):
            return
        rec = self.comms_dict[op_name][(nbytes, axis_name)]
        rec["count"] += 1
        rec["volume"] += nbytes
        if n:
            rec["n"] = n
        if timer is not None:
            rec["timers"].append(timer)
        if self.verbose:
            from ..utils.logging import logger
            logger.info(f"comm op: {op_name} | axis: {axis_name} | "
                        f"msg size: {nbytes} bytes")

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per op: ``count``, ``bytes`` (payload), ``seconds`` (the timed
        calls' sum), ``algbw_GBps`` and ``busbw_GBps``.  Reading the
        times waits for the card's events."""
        out: Dict[str, Dict[str, float]] = {}
        for op_name, sizes in sorted(self.comms_dict.items()):
            count = nbytes = 0
            secs, timed_bytes, wire = 0.0, 0, 0.0
            for (size, _axis), rec in sizes.items():
                count += rec["count"]
                nbytes += rec["volume"]
                ts = [t.seconds() for t in rec["timers"]]
                secs += sum(ts)
                timed_bytes += size * len(ts)
                wire += size * len(ts) * calc_bw_factor(op_name,
                                                        rec.get("n", 0))
            alg = timed_bytes / secs / 1e9 if secs > 0 else 0.0
            bus = wire / secs / 1e9 if secs > 0 else 0.0
            out[op_name] = {"count": count, "bytes": nbytes,
                            "seconds": secs, "algbw_GBps": alg,
                            "busbw_GBps": bus}
        return out

    def log_summary(self) -> str:
        """A table per (op, axis, message size): count, total volume, the
        bus-bandwidth factor, wire volume, and the measured time and
        rates of the timed calls."""
        lines: List[str] = [
            f"{'Op':<16}{'Axis':<12}{'Msg size':>12}{'Count':>8}"
            f"{'Total volume':>16}{'BW factor':>11}{'Wire volume':>16}"
            f"{'Time ms':>12}{'algbw GB/s':>12}{'busbw GB/s':>12}"]
        for op_name, sizes in sorted(self.comms_dict.items()):
            for (nbytes, axis_name), rec in sorted(sizes.items()):
                factor = calc_bw_factor(op_name, rec.get("n", 0))
                wire = int(rec["volume"] * factor)
                ts = [t.seconds() for t in rec["timers"]]
                secs = sum(ts)
                alg = nbytes * len(ts) / secs / 1e9 if secs > 0 else 0.0
                lines.append(f"{op_name:<16}{axis_name:<12}{nbytes:>12}"
                             f"{rec['count']:>8}{rec['volume']:>16}"
                             f"{factor:>11.3f}{wire:>16}"
                             f"{secs * 1e3:>12.3f}{alg:>12.3f}"
                             f"{alg * factor:>12.3f}")
        out = "\n".join(lines)
        from ..utils.logging import logger
        logger.info("\n" + out)
        return out

    def reset(self) -> None:
        self.comms_dict.clear()


_logger: Optional[CommsLogger] = None


def get_comms_logger() -> Optional[CommsLogger]:
    return _logger


def configure(config=None, verbose: Optional[bool] = None,
              **kw) -> CommsLogger:
    """Enable comms logging: ``config`` is a ``comms_logger`` block (a
    dict or an object with its fields), else keyword fields."""
    global _logger
    if _logger is None:
        _logger = CommsLogger()
    if config is not None:
        get = (config.get if isinstance(config, dict)
               else lambda k, d=None: getattr(config, k, d))
        prof_ops = get("prof_ops", None) or []
        # prof_ops given without prof_all means "profile only these"
        prof_all = get("prof_all", True) or not prof_ops
        _logger.configure(enabled=get("enabled", True),
                          verbose=get("verbose", False),
                          debug=get("debug", False), prof_all=prof_all,
                          prof_ops=prof_ops)
    else:
        if kw.get("prof_ops") and "prof_all" not in kw:
            kw["prof_all"] = False
        kw.setdefault("enabled", True)
        _logger.configure(verbose=verbose, **kw)
    return _logger

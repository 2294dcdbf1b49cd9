"""Rank-filtered logging (reference: `deepspeed/utils/logging.py`).

Copy of ``deepspeed_tpu/utils/logging.py`` for the PyTorch port; the rank
comes from the ``RANK`` environment variable (torchrun's contract)
instead of ``jax.process_index()``."""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


def _create_logger(name: str = "DeepSpeedTPUTorch",
                   level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        h = logging.StreamHandler(stream=sys.stdout)
        h.setFormatter(logging.Formatter(_FORMAT))
        lg.addHandler(h)
    return lg


logger = _create_logger()


def _this_rank() -> int:
    return int(os.environ.get("RANK", 0))


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log only on the given process ranks (None or [-1] = all)."""
    my_rank = _this_rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message: str, _seen=set()) -> None:
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)

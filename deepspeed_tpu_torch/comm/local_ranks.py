"""A world of ranks on this host, torchrun-style.

Starts ``world`` child interpreters, each running ``source`` with
``python -c`` and torchrun's environment contract (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``
127.0.0.1, ``MASTER_PORT`` a free port), so ``init_distributed()`` in
the child needs no arguments.  The parent waits for all of them under
one deadline: a rank that fails or outlives it fails the whole world,
and every child still running is killed, so a hung collective can never
stall the caller.  The first rank to fail ends the world.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from .comm import _free_port


class RanksFailed(RuntimeError):
    """A rank exited non-zero or the world outlived its deadline."""


def run_ranks(source: str, world: int, timeout: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None,
              log_dir: Optional[str] = None) -> List[str]:
    """Run ``source`` in ``world`` ranks; return each rank's output
    (stdout and stderr together), or raise :class:`RanksFailed` with the
    tail of every failing rank's output."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="ranks_")
    port = str(_free_port())
    procs, paths = [], []
    try:
        for rank in range(world):
            penv = dict(os.environ)
            penv.update(env or {})
            penv.update(RANK=str(rank), WORLD_SIZE=str(world),
                        LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            path = os.path.join(log_dir, f"rank{rank}.log")
            paths.append(path)
            with open(path, "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", source], env=penv, cwd=cwd,
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        # poll: the first rank to fail ends the world at once (its peers
        # would only wait for it in their collectives)
        while True:
            codes: List[Optional[int]] = [p.poll() for p in procs]
            if all(c is not None for c in codes) or \
                    any(c not in (None, 0) for c in codes) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for path in paths:
        with open(path, errors="replace") as f:
            outs.append(f.read())
    bad = [r for r, c in enumerate(codes) if c != 0]
    if bad:
        detail = "\n".join(
            f"--- rank {r} ({'stopped' if codes[r] is None else f'exit {codes[r]}'})"
            f" ---\n{outs[r][-4000:]}" for r in bad)
        raise RanksFailed(f"ranks {bad} of {world} failed "
                          f"(deadline {timeout} s):\n{detail}")
    return outs

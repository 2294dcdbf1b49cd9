#!/usr/bin/env python3
"""Run ``chip_smoke.py`` with a stack sampler of its main thread.

Run from the root of a checkout, on the card's machine::

    python3 chip_smoke_sampler.py [OUT]

It runs ``chip_smoke.main()`` unchanged (same phases, same checks, same
exit code) while a thread reads the main thread's stack four times a
second, and then writes ``OUT`` (by default ``chip_smoke_samples.txt``
in the current directory): the seconds spent
in each function of the repo (inclusive: the function anywhere on the
stack), at each line of the repo that was the innermost of the repo's
frames, and in the innermost frame of any file (a library's own time,
``torch.profiler``'s parsing for one).  The child processes of the
multi-rank phases are not sampled: their time shows as
``local_ranks.py:run_ranks``.  The sampler takes a few milliseconds a
second of the main thread's time.
"""
from __future__ import annotations

import collections
import os
import sys
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parent
#: seconds between two samples
PERIOD = 0.25
#: lines written per table
TOP = {"inclusive": 150, "innermost of the repo's, by line": 120,
       "innermost frame of any file": 60}


def sample(main_id: int, stop: threading.Event, tables: dict) -> None:
    """Every ``PERIOD`` until ``stop``, add one sample of the main
    thread's stack to ``tables``."""
    repo = str(REPO) + os.sep
    while not stop.wait(PERIOD):
        frame = sys._current_frames().get(main_id)
        seen, first, innermost = set(), None, None
        while frame is not None:
            code = frame.f_code
            key = f"{os.path.basename(code.co_filename)}:{code.co_name}"
            innermost = innermost or key
            if code.co_filename.startswith(repo) and \
                    "site-packages" not in code.co_filename:
                first = first or f"{key}:{frame.f_lineno}"
                if key not in seen:
                    seen.add(key)
                    tables["inclusive"][key] += 1
            frame = frame.f_back
        if first:
            tables["innermost of the repo's, by line"][first] += 1
        if innermost:
            tables["innermost frame of any file"][innermost] += 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0] if argv else "chip_smoke_samples.txt")
    sys.path.insert(0, str(REPO))
    tables = {name: collections.Counter() for name in TOP}
    stop = threading.Event()
    threading.Thread(target=sample, name="stack-sampler", daemon=True,
                     args=(threading.get_ident(), stop, tables)).start()
    import chip_smoke
    code = 1
    try:
        code = chip_smoke.main([])
    finally:
        stop.set()
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            for name, counts in tables.items():
                f.write(f"== {name}: seconds\n")
                for key, n in counts.most_common(TOP[name]):
                    f.write(f"{n * PERIOD:9.2f}  {key}\n")
    return code


if __name__ == "__main__":
    sys.exit(main())

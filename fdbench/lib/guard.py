"""A watchdog for a run: a daemon thread that ends the process, with a
line on standard error, once it has lived ``seconds`` or its resident
host memory passes ``rss_bytes``: a run that hangs or grows without end
must not take the machine with it."""
from __future__ import annotations

import os
import sys
import threading
import time


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def start(t_proc0: float, seconds: float, rss_bytes: float,
          poll_s: float = 1.0) -> threading.Thread:
    def watch():
        while True:
            time.sleep(poll_s)
            age = time.perf_counter() - t_proc0
            rss = _rss_bytes()
            if age > seconds or rss > rss_bytes:
                print(f"fdbench: watchdog ends the run: {age:.1f} s old, "
                      f"{rss / 2 ** 30:.1f} GiB resident (limits "
                      f"{seconds} s, {rss_bytes / 2 ** 30:.1f} GiB)",
                      file=sys.stderr, flush=True)
                os._exit(4)
    t = threading.Thread(target=watch, name="fdbench-watchdog", daemon=True)
    t.start()
    return t

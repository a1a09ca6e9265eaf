"""Wall-clock and bandwidth accounting.

The reference has no timing/observability (SURVEY.md §5); this adds the
north-star metrics: time/step, Poisson iters/sec, and effective HBM
bandwidth vs the analytic roofline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class StepRecord:
    it: int
    wall_s: float
    poisson_iters: int
    err: float


class RunTimer:
    def __init__(self):
        self.records: List[StepRecord] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, it: int, poisson_iters: int, err: float) -> StepRecord:
        rec = StepRecord(it=it, wall_s=time.time() - self._t0,
                         poisson_iters=poisson_iters, err=err)
        self.records.append(rec)
        return rec

    def summary(self, skip_first: int = 1) -> dict:
        recs = self.records[skip_first:] or self.records
        if not recs:
            return {}
        total = sum(r.wall_s for r in recs)
        iters = sum(r.poisson_iters for r in recs)
        return {
            "steps": len(recs),
            "time_per_step_s": total / len(recs),
            "poisson_iters_per_sec": iters / total if total else 0.0,
            "total_wall_s": total,
        }


def poisson_roofline_iters_per_sec(cells: int, itemsize: int,
                                   hbm_gbps: float) -> float:
    """Minimum HBM traffic per damped-iteration: read Pr/dprdtau/divv,
    write Pr/dprdtau = 5 grid passes."""
    return hbm_gbps * 1e9 / (5 * cells * itemsize)


class StallWatchdog:
    """Hard-exits the process when the run makes no progress for
    `timeout_s` seconds.

    A wedged device runtime can block FOREVER inside a device call — no
    Python exception, signal handler, or timeout wrapper can interrupt
    the blocked thread. The watchdog runs on a daemon thread; the
    driver calls beat() after every completed host sync. On expiry it
    writes a diagnosis to stderr and os._exit(exit_code), so a
    supervisor loop can restart the SAME command with --resume (run.py
    --nt is the total horizon, so resumption completes the run from the
    last checkpoint instead of extending it).

    Pick timeout_s well above the slowest legitimate gap between syncs:
    the first sync includes the JIT compile plus --sync-every steps of
    compute.
    """

    def __init__(self, timeout_s: float, exit_code: int = 3,
                 message: str = ""):
        import threading
        self.timeout_s = float(timeout_s)
        self.exit_code = int(exit_code)
        self.message = message
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def start(self) -> "StallWatchdog":
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    def _watch(self):
        import os as _os
        import sys as _sys
        poll = max(0.05, min(5.0, self.timeout_s / 4.0))
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                print(f"STALL: no progress for {idle:.0f}s "
                      f"(--stall-timeout {self.timeout_s:.0f}s); the "
                      f"device runtime is likely wedged. {self.message}",
                      file=_sys.stderr, flush=True)
                _os._exit(self.exit_code)

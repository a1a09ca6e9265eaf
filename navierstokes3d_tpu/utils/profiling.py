"""Profiling helpers: jax.profiler traces + step instrumentation.

The reference has no profiling at all (SURVEY.md §5). This provides:
  * trace(): context manager writing a TensorBoard/Perfetto trace of the
    enclosed steps,
  * profile_steps(): convenience wrapper timing N solver steps under a
    trace and returning the RunTimer summary with roofline percentages.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import jax
import numpy as np

from . import peaks
from .timers import RunTimer, poisson_roofline_iters_per_sec


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/ns3d_trace"):
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def profile_steps(solver, state, n_steps: int = 3,
                  trace_dir: Optional[str] = None) -> dict:
    """Run n_steps jitted solver steps (assumes the step is already
    compiled/warm) and return timing + roofline summary against the
    device's published HBM peak (utils/peaks.py; an unknown device
    raises)."""
    timer = RunTimer()
    ctx = trace(trace_dir) if trace_dir else contextlib.nullcontext()
    with ctx:
        for it in range(n_steps):
            timer.start()
            state, stats = solver.step_jit(state)
            jax.block_until_ready(state.pr)
            timer.stop(it, int(stats.iters), float(stats.err))
    g = solver.grid
    summary = timer.summary(skip_first=0)
    itemsize = np.dtype(solver.dtype).itemsize
    roof = poisson_roofline_iters_per_sec(g.nx * g.ny * g.nz, itemsize,
                                          peaks.peak_hbm_gbps())
    summary["roofline_iters_per_sec"] = roof
    summary["roofline_fraction"] = (
        summary.get("poisson_iters_per_sec", 0.0) / roof)
    return summary

"""Attribute the gap between step wall time and device time at the 255
showcase grid. Hypotheses:
  (a) per-step HOST-SIDE STATS FETCHES: the production loops read
      int(stats.iters) / float(stats.err) after every step — each is a
      blocking scalar device-to-host copy;
  (b) dispatch/launch latency of the step executable itself.

The probe separates them by running the SAME chained 8-step window
three ways (one process, states chained):
  1. eager stats: read iters+err after every step;
  2. deferred stats: block only on state.pr per step, fetch all stats
     AFTER the timed window (the fetch cost moves out of the window —
     isolates (a));
  3. free-run: enqueue all 8 steps back-to-back, block once at the end
     (also removes the per-step block_until_ready host round trip —
     the remaining wall ~ device time + 1 round trip, isolating (b)).

Usage: python benchmarks/dispatch_gap_probe.py [--nx 255] [--steps 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=255)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)

    import navierstokes3d_tpu as ns
    cfg = ns.preset_gpu(nx=args.nx, nt=args.steps, compat=False,
                        dtype="float32")
    s = ns.ChorinSolver(cfg)
    print(f"grid {s.grid.nx}x{s.grid.ny}x{s.grid.nz} "
          f"device={jax.devices()[0].device_kind}", flush=True)

    state = s.init_state()
    for _ in range(2):  # compile both structures
        state, _ = s.step_jit(state)
    jax.block_until_ready(state.pr)

    n = args.steps

    # 1. eager stats (the bench.py / run.py loop shape)
    t0 = time.time()
    tot = 0
    for _ in range(n):
        state, stats = s.step_jit(state)
        jax.block_until_ready(state.pr)
        tot += int(stats.iters)
        _ = float(stats.err)
    w1 = time.time() - t0
    print(f"eager stats   : {w1/n:.4f} s/step ({tot} iters)", flush=True)

    # 2. deferred stats: per-step block on the state only
    t0 = time.time()
    all_stats = []
    for _ in range(n):
        state, stats = s.step_jit(state)
        jax.block_until_ready(state.pr)
        all_stats.append(stats)
    w2 = time.time() - t0
    tot2 = sum(int(st.iters) for st in all_stats)
    print(f"deferred stats: {w2/n:.4f} s/step ({tot2} iters) "
          f"-> per-step stats-fetch cost {1e3*(w1-w2)/n:.1f} ms",
          flush=True)

    # 3. free-run: enqueue everything, block once
    t0 = time.time()
    all_stats = []
    for _ in range(n):
        state, stats = s.step_jit(state)
        all_stats.append(stats)
    jax.block_until_ready(state.pr)
    w3 = time.time() - t0
    tot3 = sum(int(st.iters) for st in all_stats)
    print(f"free-run      : {w3/n:.4f} s/step ({tot3} iters) "
          f"-> per-step sync/dispatch cost {1e3*(w2-w3)/n:.1f} ms",
          flush=True)
    print(f"summary: stats fetch {1e3*(w1-w2)/n:.1f} ms/step, "
          f"host sync {1e3*(w2-w3)/n:.1f} ms/step, "
          f"residual (device+pipeline) {w3/n:.4f} s/step", flush=True)


if __name__ == "__main__":
    main()

"""Break a full solver step into its cost components on the current
device: Poisson solve (sweeps + residual checks) vs the non-Poisson ops
(stress/predict/divergence/correct/BC/advect). Host-clock times around
block_until_ready; a profiler trace gives the per-fusion split.

Usage: python benchmarks/step_breakdown.py [--nx 255] [--steps 2]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *a, reps=1):
    out = fn(*a)
    jax.block_until_ready(jax.tree.leaves(out)[0])
    t0 = time.time()
    for _ in range(reps):
        out = fn(*a)
    jax.block_until_ready(jax.tree.leaves(out)[0])
    return (time.time() - t0) / reps, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=255)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)

    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    cfg = ns.preset_gpu(nx=args.nx, nt=1, compat=False, dtype="float32")
    s = ns.ChorinSolver(cfg)
    g = s.grid
    print(f"grid {g.nx}x{g.ny}x{g.nz} niter={g.niter} nchk={g.nchk}",
          flush=True)

    # develop the flow a little so iteration counts are realistic
    state = s.init_state()
    for i in range(args.steps):
        state, stats = s.step_jit(state)
    jax.block_until_ready(state.pr)

    # step_jit donates its input, so time it chained (fresh state each call)
    t0 = time.time()
    state2, stats2 = s.step_jit(state)
    jax.block_until_ready(state2.pr)
    t_step = time.time() - t0
    state = state2
    it_tot = int(stats2.iters)
    it_ext = int(stats2.iters_ext) if stats2.iters_ext is not None else 0
    print(f"full step      : {t_step*1e3:8.1f} ms   "
          f"iters={it_tot} (ext={it_ext}) err={float(stats2.err):.2e}",
          flush=True)

    # Poisson solve alone, on this step's actual inputs
    divv = jax.jit(s.predictor_divv)(state)
    solve = jax.jit(s.poisson_solve)
    t_ps, out = timed(solve, state.pr, state.dprdtau, divv)
    it_s = int(out[2].iters)
    it_se = int(out[2].iters_ext) if out[2].iters_ext is not None else 0
    print(f"poisson_solve  : {t_ps*1e3:8.1f} ms   "
          f"iters={it_s} (ext={it_se})", flush=True)

    # non-Poisson chain (everything but the solve): the step with the
    # solve replaced by a pass-through of the incoming pressure
    def no_solve(pr, dprdtau, divv):
        return pr, dprdtau, ns.StepStats(
            iters=jnp.int32(0), err=jnp.zeros((), pr.dtype),
            err_hist=jnp.zeros((1,), pr.dtype))

    rest = jax.jit(lambda st: s._step_impl(st, no_solve))
    t_rest, _ = timed(rest, state, reps=3)
    print(f"non-poisson ops: {t_rest*1e3:8.1f} ms", flush=True)
    print(f"unaccounted step overhead (step - solve - rest): "
          f"{(t_step - t_ps - t_rest)*1e3:8.1f} ms", flush=True)


if __name__ == "__main__":
    main()

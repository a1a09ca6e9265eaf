"""Probe: fdm direct backend at the showcase grid + compensated
iterative-refinement prototype.

Questions this answers (on the device, one process, chained states):

  (A) What does the CURRENT fdm backend (direct solve + PT polish,
      round-1-era table in docs/architecture.md) do at 255x153x153 f32
      today — time/step, iters, reported err, and the honest compensated
      residual of the returned single field?

  (B) Does compensated iterative refinement in the fdm eigenbasis
      contract? From a developed state: build the (hi,lo) RHS pair,
      direct-solve, then loop { r = compensated residual of the (hi,lo)
      pressure pair; e = fdm(r); pair += e } and print the err
      trajectory (reference err units, ly^2/psc-scaled). If the
      trajectory crosses eps_it=1e-3 in <= ~4 refinements, the
      refinement replaces thousands of PT iterations per step.

Run:  python benchmarks/fdm_refine_probe.py [--nx 255] [--steps 4]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.ops import ds as dsops


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=255)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--refines", type=int, default=6)
    ap.add_argument("--preset", choices=("gpu", "multi"), default="gpu")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    make = ns.preset_gpu if args.preset == "gpu" else ns.preset_multi
    cfg = make(nx=args.nx, nt=args.steps + 2, compat=False, dtype="float32")
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, poisson_backend="fdm"))
    solver = ns.ChorinSolver(cfg)
    g, phys = solver.grid, solver.cfg.physics
    eps_it = cfg.numerics.eps_it
    log(f"grid {g.nx}x{g.ny}x{g.nz} preset={args.preset} backend=fdm "
        f"fdm_refine={cfg.numerics.fdm_refine} "
        f"device={jax.devices()[0].device_kind}")

    # ---- (A) current fdm path ----
    state = solver.init_state()
    t0 = time.time()
    state, stats = solver.step_jit(state)
    jax.block_until_ready(state.pr)
    log(f"A: warmup1 (compile+host-eig): {time.time()-t0:.1f}s "
        f"iters={int(stats.iters)} err={float(stats.err):.3e}")
    t0 = time.time()
    state, stats = solver.step_jit(state)
    jax.block_until_ready(state.pr)
    log(f"A: warmup2: {time.time()-t0:.1f}s iters={int(stats.iters)} "
        f"err={float(stats.err):.3e}")
    per = []
    for i in range(args.steps):
        jax.block_until_ready(state.pr)
        divv_pre = jax.jit(solver.predictor_divv)(state)
        jax.block_until_ready(divv_pre)
        t0 = time.time()
        state, stats = solver.step_jit(state)
        jax.block_until_ready(state.pr)
        dtm = time.time() - t0
        per.append(dtm)
        st_err = float(jax.jit(solver.stored_residual_err)(
            state, divv=divv_pre))
        log(f"A: step {i}: {dtm:.3f}s iters={int(stats.iters)} "
            f"err={float(stats.err):.3e} stored_err={st_err:.3e} "
            f"({'OK' if st_err < eps_it else 'ABOVE eps_it'})")
    log(f"A: median step {np.median(per):.3f}s")

    # ---- (B) refinement prototype from the developed state ----
    comp = solver._comp_residual_fn()
    fdm = solver._fdm_solve  # built by the steps above
    static = solver._fdm_static
    err_scale = (g.ly * g.ly) / phys.psc
    nref = args.refines

    @jax.jit
    def refine_traj(divv, pr_planes):
        rhs_hi, rhs_lo = dsops.rhs_pair(
            divv[1:-1, 1:-1, 1:-1], phys.rho / g.dt, None)
        p_int = fdm(rhs_hi)
        if static is not None:
            p_int = p_int + static
        pr = pr_planes.at[1:-1, 1:-1, 1:-1].set(p_int)
        pr = solver.set_bc_pr(pr)
        lo = jnp.zeros_like(pr)
        errs = []
        for _ in range(nref):
            r, emax = comp(pr, lo, rhs_hi, rhs_lo)
            errs.append(emax * err_scale)
            # comp returns r = lap(p) - rhs; the correction solves
            # lap(e) = -r (same sign convention as the defect phase's
            # rhs_c = -r0 in models/chorin._poisson_solve_jnp_folded)
            e = fdm(-r.astype(pr.dtype))
            hi_i = pr[1:-1, 1:-1, 1:-1]
            lo_i = lo[1:-1, 1:-1, 1:-1]
            nh, t = dsops.two_sum(hi_i, e)
            nl = lo_i + t
            nh, nl = dsops.two_sum(nh, nl)
            pr = solver.set_bc_pr(pr.at[1:-1, 1:-1, 1:-1].set(nh))
            lo = lo.at[1:-1, 1:-1, 1:-1].set(nl)
        _, emax = comp(pr, lo, rhs_hi, rhs_lo)
        errs.append(emax * err_scale)
        return jnp.stack(errs)

    divv = jax.jit(solver.predictor_divv)(state)
    t0 = time.time()
    traj = np.asarray(refine_traj(divv, state.pr))
    log(f"B: refine trajectory compile+run: {time.time()-t0:.1f}s")
    for k, e in enumerate(traj):
        tag = "direct" if k == 0 else f"refine{k}"
        log(f"B: err after {tag}: {e:.3e} "
            f"({'< eps_it' if e < eps_it else 'above'})")
    # contraction summary
    with np.errstate(divide="ignore"):
        ratios = traj[1:] / np.maximum(traj[:-1], 1e-300)
    log(f"B: contraction ratios: {[f'{r:.2e}' for r in ratios]}")


if __name__ == "__main__":
    main()

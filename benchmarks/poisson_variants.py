"""Microbenchmark of Poisson-iteration implementations on the current
device at the showcase grid. Run each variant K iterations in a fori_loop
and report ms/iter + roofline fraction.

Variants:
  exact    — reference-ordered ops with per-iteration BC plane updates
  folded   — BCs folded into stencil masks (models/chorin.py default)
  masked   — fully elementwise: ring-zero via broadcast 1D masks + pad
  solver   — the solver's own poisson_solve (loop + residual checks)

The roofline share is against the device's published HBM rate
(navierstokes3d_tpu/utils/peaks.py; an unknown device raises).

Usage: python benchmarks/poisson_variants.py [--nx 255] [--iters 300]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=255)
    ap.add_argument("--iters", type=int, default=300)
    args = ap.parse_args(argv)

    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.ops import physics as ph
    from navierstokes3d_tpu.utils.cache import enable_compile_cache
    from navierstokes3d_tpu.utils.peaks import peak_hbm_gbps, pt_sweep_bytes
    enable_compile_cache()

    cfg = ns.preset_multi(nx=args.nx, nt=1, compat=False, dtype="float32")
    s = ns.ChorinSolver(cfg)
    g = s.grid
    rho, dt, dtau, damp = cfg.physics.rho, g.dt, g.dtau, g.damp
    dx, dy, dz = g.dx, g.dy, g.dz
    nx, ny, nz = g.nx, g.ny, g.nz
    K = args.iters

    rng = np.random.default_rng(0)
    pr0 = jnp.asarray(rng.random(g.shape_c), jnp.float32) * 1e-3
    dpr0 = jnp.zeros(g.shape_c, jnp.float32)
    divv0 = jnp.asarray(rng.random(g.shape_c), jnp.float32) * 1e-3

    cells = nx * ny * nz
    roof_ms = pt_sweep_bytes(cells, 4, False) / (peak_hbm_gbps() * 1e9) * 1e3

    def timeit(name, fn, *a):
        out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        _ = float(jax.tree.leaves(out)[0].ravel()[0])
        t0 = time.time()
        out = fn(*a)
        _ = float(jax.tree.leaves(out)[0].ravel()[0])
        dt_ms = (time.time() - t0) / K * 1e3
        print(f"{name:8s}: {dt_ms:7.3f} ms/iter  ({1e3/dt_ms:7.0f} it/s)  "
              f"{100*roof_ms/dt_ms:5.1f}% of roofline")
        return dt_ms

    # exact
    @jax.jit
    def run_exact(pr, dpr, divv):
        def body(_, c):
            pr, dpr = ph.poisson_iter(*c, divv, rho, dt, dtau, damp,
                                      dx, dy, dz)
            pr = s.set_bc_pr(pr)
            return (pr, dpr)
        return jax.lax.fori_loop(0, K, body, (pr, dpr))

    timeit("exact", run_exact, pr0, dpr0, divv0)

    # folded (reuse the solver's machinery by calling its inner pieces)
    def masks_1d(n, lo, hi):
        am = np.ones(n - 2, np.float32); ap = np.ones(n - 2, np.float32)
        if lo: am[0] = 0.0
        if hi: ap[-1] = 0.0
        return jnp.asarray(am), jnp.asarray(ap)
    axm, axp = masks_1d(nx, True, False)
    aym, ayp = masks_1d(ny, True, True)
    azm, azp = masks_1d(nz, True, True)
    axm = axm[:, None, None]; axp = axp[:, None, None]
    aym = aym[None, :, None]; ayp = ayp[None, :, None]
    azm = azm[None, None, :]; azp = azp[None, None, :]
    rhs = (rho / dt) * divv0[1:-1, 1:-1, 1:-1]

    def lap_folded(pr):
        pc = pr[1:-1, 1:-1, 1:-1]
        return ((axp * (pr[2:, 1:-1, 1:-1] - pc)
                 + axm * (pr[:-2, 1:-1, 1:-1] - pc)) / dx / dx
                + (ayp * (pr[1:-1, 2:, 1:-1] - pc)
                   + aym * (pr[1:-1, :-2, 1:-1] - pc)) / dy / dy
                + (azp * (pr[1:-1, 1:-1, 2:] - pc)
                   + azm * (pr[1:-1, 1:-1, :-2] - pc)) / dz / dz)

    @jax.jit
    def run_folded(pr, dpr):
        def body(_, c):
            pr, dpr = c
            resid = lap_folded(pr) - rhs
            dpr = dpr.at[1:-1, 1:-1, 1:-1].set(
                dpr[1:-1, 1:-1, 1:-1] * (1 - damp) + dtau * resid)
            pr = pr + dtau * dpr
            return (pr, dpr)
        return jax.lax.fori_loop(0, K, body, (pr, dpr))

    timeit("folded", run_folded, pr0, dpr0)

    # masked: fully elementwise via interior add (both updates through DUS
    # on the same region, candidates for a single fused loop)
    @jax.jit
    def run_masked(pr, dpr):
        def body(_, c):
            pr, dpr = c
            resid = lap_folded(pr) - rhs
            dpr_in = dpr[1:-1, 1:-1, 1:-1] * (1 - damp) + dtau * resid
            dpr = dpr.at[1:-1, 1:-1, 1:-1].set(dpr_in)
            pr = pr.at[1:-1, 1:-1, 1:-1].add(dtau * dpr_in)
            return (pr, dpr)
        return jax.lax.fori_loop(0, K, body, (pr, dpr))

    timeit("masked", run_masked, pr0, dpr0)

    # the real solver's poisson_solve (chunked while_loop + residual checks)
    @jax.jit
    def run_solver(pr, dpr, divv):
        return s.poisson_solve(pr, dpr, divv)

    out = run_solver(pr0, dpr0, divv0)
    jax.block_until_ready(out[0])
    n_iters = int(out[2].iters)
    if n_iters:
        t0 = time.time()
        out = run_solver(pr0, dpr0, divv0)
        _ = float(out[0].ravel()[0])
        dt_ms = (time.time() - t0) / n_iters * 1e3
        print(f"{'solver':8s}: {dt_ms:7.3f} ms/iter  ({1e3/dt_ms:7.0f} it/s)  "
              f"{100*roof_ms/dt_ms:5.1f}% of roofline  "
              f"[{n_iters} iters incl. checks]")


if __name__ == "__main__":
    main()

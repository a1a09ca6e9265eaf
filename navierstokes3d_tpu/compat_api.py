"""Drop-in equivalents of the reference's two public entry functions.

A user of the reference calls `run_navierstokes3D(...)` (the multi-GPU
script, NavierStokes3D_multi_gpu.jl:287) or `runme(...)` (the single-GPU
script, NavierStokes3D_gpu.jl:12). These wrappers provide the same
signatures, side effects (out_save/ dumps, viz3D_out/ frames, progress
prints) and return values on top of the unified solver.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np


def run_navierstokes3d(do_vis: bool = False, do_save: bool = False,
                       do_print: bool = False, nx: int = 255, nt: int = 10,
                       *, compat: bool = True, dtype: str = "float64",
                       out_dir: str = "out_save", viz_dir: str = "viz3D_out"):
    """The multi-GPU script's driver (NavierStokes3D_multi_gpu.jl:287-536).

    Returns (C_v, Pr_v, Vx_v, Vy_v, Vz_v): the global inner fields, as the
    reference's final gather does (:528-535). Defaults to float64 like the
    reference (@init_parallel_stencil(..., Float64, 3), multi_gpu.jl:6),
    which requires jax.config.update('jax_enable_x64', True) first (a clear
    error is raised otherwise); pass dtype='float32' to opt into the
    float32 path.
    """
    import jax

    from . import ChorinSolver, gather_inner, preset_multi
    from .io import binio, viz

    cfg = preset_multi(nx=nx, nt=nt, compat=compat, dtype=dtype)
    solver = ChorinSolver(cfg)
    g = solver.grid
    state = solver.init_state()
    nvis = nsave = 10  # reference cadence (:330,:332)
    iframe = 0

    def dump(state, stats=None):
        nonlocal iframe
        c, pr, vx, vy, vz = solver.gather_inner(state)
        fields = {"C": c, "Pr": pr, "Vx": vx, "Vy": vy, "Vz": vz}
        if do_save:
            binio.save_fields(out_dir, iframe, fields)
        if do_vis:
            viz.save_frame(viz_dir, iframe, g, fields, t=iframe * nvis * g.dt)
        iframe += 1

    if do_save or do_vis:
        dump(state)

    for it in range(1, nt + 1):
        state, stats = solver.step_jit(state)
        if do_print:
            print(f"#it = {it}", file=sys.stderr)
            hist = np.asarray(stats.err_hist)
            for kchk, err in enumerate(hist):
                if not np.isnan(err):
                    print(f"  #iter = {(kchk + 1) * g.nchk}, "
                          f"err = {err:1.3e}", file=sys.stderr)
        if (do_vis and it % nvis == 0) or (do_save and it % nsave == 0):
            dump(state, stats)

    return solver.gather_inner(state)


def runme(do_vis: bool = True, do_save: bool = False, *,
          nx: int = 255, nt: int = 10000, compat: bool = True,
          dtype: str = "float64", out_dir: str = "out_save",
          viz_dir: str = "viz3D_out"):
    """The single-GPU script's driver (NavierStokes3D_gpu.jl:12-173):
    hydrostatic +100 Pa head forcing, .mat snapshots every 10 steps.
    Defaults to float64 like the reference (gpu.jl:6); requires x64 enabled
    (clear error otherwise), dtype='float32' opts into the float32 path."""
    from . import ChorinSolver, preset_gpu
    from .io import matio, viz

    cfg = preset_gpu(nx=nx, nt=nt, compat=compat, dtype=dtype)
    solver = ChorinSolver(cfg)
    g = solver.grid
    state = solver.init_state()
    nvis = nsave = 10
    iframe = 0

    def fields_of(state):
        return (np.asarray(solver.full_pressure(state.pr)),
                np.asarray(state.vx),
                np.asarray(state.vy), np.asarray(state.vz),
                np.asarray(state.c))

    if do_save:
        pr, vx, vy, vz, c = fields_of(state)
        matio.save_step_mat(out_dir, 0, pr, vx, vy, vz, c, g.dx, g.dy, g.dz)
    if do_vis:
        pr, vx, vy, vz, c = fields_of(state)
        viz.save_frame(viz_dir, iframe, g,
                       {"Pr": pr, "C": c, "Vx": vx, "Vy": vy, "Vz": vz},
                       t=0.0, fixed_clims=False)
        iframe += 1

    for it in range(1, nt + 1):
        state, stats = solver.step_jit(state)
        print(f"#it = {it}", file=sys.stderr)
        if do_vis and it % nvis == 0:
            pr, vx, vy, vz, c = fields_of(state)
            viz.save_frame(viz_dir, iframe, g,
                           {"Pr": pr, "C": c, "Vx": vx, "Vy": vy, "Vz": vz},
                           t=it * g.dt, fixed_clims=False)
            iframe += 1
        if do_save and it % nsave == 0:
            pr, vx, vy, vz, c = fields_of(state)
            matio.save_step_mat(out_dir, it, pr, vx, vy, vz, c,
                                g.dx, g.dy, g.dz)
    return state

"""Manufactured-solution validation: the pseudo-transient Poisson solve
must converge to the exact solution of its own discrete system.

The discrete operator (folded-BC form: zero-gradient faces as dropped
neighbor terms, outlet Dirichlet column pinned) is assembled as a sparse
matrix and solved directly with scipy; the iterative solve must agree to
the level implied by its residual tolerance. This validates the whole
chain — operator, BC folding, damping, convergence control — against
linear algebra rather than against another stencil implementation.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax.numpy as jnp

import navierstokes3d_tpu as ns


def assemble_operator(grid):
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    ix, iy, iz = nx - 2, ny - 2, nz - 2
    n = ix * iy * iz
    idx = lambda i, j, k: (i * iy + j) * iz + k
    rows, cols, vals = [], [], []
    cx, cy, cz = 1 / grid.dx**2, 1 / grid.dy**2, 1 / grid.dz**2
    for i in range(ix):
        for j in range(iy):
            for k in range(iz):
                r = idx(i, j, k)
                diag = 0.0
                for (di, dj, dk, c) in ((1, 0, 0, cx), (-1, 0, 0, cx),
                                        (0, 1, 0, cy), (0, -1, 0, cy),
                                        (0, 0, 1, cz), (0, 0, -1, cz)):
                    ni, nj, nk = i + di, j + dj, k + dk
                    if 0 <= ni < ix and 0 <= nj < iy and 0 <= nk < iz:
                        diag -= c
                        rows.append(r); cols.append(idx(ni, nj, nk))
                        vals.append(c)
                    elif di == 1 and ni == ix:
                        diag -= c  # outlet Dirichlet-0 neighbor
                    # else: zero-gradient neighbor, term drops
                rows.append(r); cols.append(r); vals.append(diag)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def test_poisson_matches_direct_solve():
    import dataclasses
    # tight tolerance: at the reference's 1e-3 the permitted matrix
    # residual maps to ~8% field error through ||A^-1|| (the quasi-Neumann
    # operator is only weakly pinned via the outlet column) — a noteworthy
    # property of the reference's own convergence criterion.
    cfg = ns.preset_multi(nx=20, nt=1, compat=False)
    cfg = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                   eps_it=1e-6))
    solver = ns.ChorinSolver(cfg)
    g = solver.grid
    x = np.linspace(0, np.pi, g.nx)[:, None, None]
    y = np.linspace(0, 2 * np.pi, g.ny)[None, :, None]
    z = np.linspace(0, np.pi, g.nz)[None, None, :]
    divv = 0.01 * np.sin(x) * np.cos(y) * np.sin(z)

    pr_it, _, stats = solver.poisson_solve(
        jnp.zeros(g.shape_c), jnp.zeros(g.shape_c), jnp.asarray(divv))
    assert float(stats.err) < cfg.numerics.eps_it

    A = assemble_operator(g)
    rhs = (cfg.physics.rho / g.dt) * divv[1:-1, 1:-1, 1:-1]
    p_direct = spla.spsolve(A.tocsc(), rhs.ravel()).reshape(rhs.shape)
    p_iter = np.asarray(pr_it)[1:-1, 1:-1, 1:-1]

    # (a) the solver's contract: matrix residual below the absolute
    # tolerance implied by err < eps_it
    tol_abs = cfg.numerics.eps_it * cfg.physics.psc / g.ly**2
    r_it = np.abs(A @ p_iter.ravel() - rhs.ravel()).max()
    assert r_it < tol_abs, (r_it, tol_abs)
    # (b) field agreement with the direct solution
    scale = max(1.0, np.abs(p_direct).max())
    err = np.abs(p_iter - p_direct).max()
    assert err < 0.01 * scale, (err, scale)


def test_fdm_backend_full_step():
    """The fast-diagonalization backend solves the pressure system exactly
    (err orders of magnitude below the reference's tolerance) and the full
    step matches the tightly-converged pseudo-transient step."""
    import dataclasses
    for preset, variant in ((ns.preset_multi, "multi"), (ns.preset_gpu, "gpu")):
        cfg_fdm = preset(nx=20, nt=1, compat=False)
        cfg_fdm = cfg_fdm.replace(numerics=dataclasses.replace(
            cfg_fdm.numerics, poisson_backend="fdm"))
        cfg_pt = preset(nx=20, nt=1, compat=False)
        cfg_pt = cfg_pt.replace(numerics=dataclasses.replace(
            cfg_pt.numerics, eps_it=1e-6))
        s_fdm = ns.ChorinSolver(cfg_fdm)
        s_pt = ns.ChorinSolver(cfg_pt)
        st_fdm, stats = s_fdm.step_jit(s_fdm.init_state())
        st_pt, _ = s_pt.step_jit(s_pt.init_state())
        assert float(stats.err) < 1e-10, (variant, float(stats.err))
        # tolerance covers the tight-PT reference's own residual-implied
        # field error plus spin-up floor-flip amplification
        for name in ("vx", "vy", "vz"):
            a = np.asarray(getattr(st_pt, name))
            b = np.asarray(getattr(st_fdm, name))
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4,
                                       err_msg=f"{variant}:{name}")


def test_fdm_refine_stored_criterion_f32():
    """f32 fdm backend: the compensated refinement loop drives the STORED
    (hi, lo) pressure pair below eps_it every step (stats.err IS the
    stored-state criterion on this path), across multiple steps with one
    solver instance (regression: the lazily-built eigenbasis closures
    must hold NumPy constants, not tracers leaked from the first step's
    trace — ops/fdm_poisson.build_fdm_solver)."""
    import dataclasses
    import jax

    for preset, variant in ((ns.preset_multi, "multi"), (ns.preset_gpu, "gpu")):
        cfg = preset(nx=20, nt=3, compat=False, dtype="float32")
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend="fdm"))
        s = ns.ChorinSolver(cfg)
        eps_it = cfg.numerics.eps_it
        st = s.init_state()
        for i in range(3):
            divv = jax.jit(s.predictor_divv)(st)
            st, stats = s.step_jit(st)
            assert int(stats.iters) <= cfg.numerics.fdm_refine
            assert float(stats.err) < eps_it, (variant, i, float(stats.err))
            assert st.pr_lo is not None
            stored = float(jax.jit(s.stored_residual_err)(st, divv=divv))
            assert stored < eps_it, (variant, i, stored)
        assert not np.isnan(np.asarray(st.pr)).any()


def test_fdm_backend_sharded_equals_single():
    """fdm under the global-view SPMD path — the only distributed path
    that routes through poisson_solve (step_sharded_jit; the shard_map/
    fullstep schedules build their own PT loop and run.py refuses the
    combination). One step on a (2,2,2) 8-device mesh must match the
    single-device fdm step: the einsum transforms are plain jnp, so the
    partitioner shards them, and in f64 the direct solve is
    machine-exact, leaving only partition-order rounding."""
    import dataclasses
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from navierstokes3d_tpu.parallel import make_mesh, shard_state

    for preset, variant in ((ns.preset_multi, "multi"), (ns.preset_gpu, "gpu")):
        cfg = preset(nx=16, nt=1, compat=False)
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend="fdm"))
        s = ns.ChorinSolver(cfg)
        ref_state, ref_stats = s.step_jit(s.init_state())

        mesh = make_mesh(devices=jax.devices()[:8])
        st_sh = shard_state(s.init_state(), mesh)
        sh_state, sh_stats = s.step_sharded_jit(mesh)(st_sh)

        # both solve directly: same refinement-round count (f64: zero)
        assert int(ref_stats.iters) == int(sh_stats.iters), variant
        assert float(sh_stats.err) < 1e-9, (variant, float(sh_stats.err))
        for name in ("pr", "vx", "vy", "vz", "c"):
            a = np.asarray(getattr(ref_state, name))
            b = np.asarray(getattr(sh_state, name))
            scale = max(1.0, np.abs(a).max())
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-11 * scale,
                                       err_msg=f"{variant}:{name}")

    # f32 with a tight eps forces the refinement loop BODY to execute
    # under sharding (the gpu variant's direct solve lands ~3e-4 err
    # units, above 1e-7) — covering the pair-update insertions in the
    # while_loop, not just the initial one (docs/gspmd_dus_note.md).
    cfg = ns.preset_gpu(nx=20, nt=1, compat=False, dtype="float32")
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, poisson_backend="fdm", eps_it=1e-7))
    s = ns.ChorinSolver(cfg)
    ref_state, ref_stats = s.step_jit(s.init_state())
    mesh = make_mesh(devices=jax.devices()[:8])
    sh_state, sh_stats = s.step_sharded_jit(mesh)(
        shard_state(s.init_state(), mesh))
    assert int(ref_stats.iters) >= 1  # the body ran
    assert int(ref_stats.iters) == int(sh_stats.iters)
    assert float(sh_stats.err) < 1e-7
    a, b = np.asarray(ref_state.pr), np.asarray(sh_state.pr)
    # single-device step_jit returns the (hi, lo) pair; the sharded
    # wrapper folds it (want_pair=False) — agreement to the fold's
    # <=0.5 ulp plus cross-program f32 rounding
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(a).max()))


def test_fdm_refine_budget_exhaustion():
    """fdm_refine=0 with an unreachable eps returns the direct solve
    gracefully: zero rounds, an HONEST err above the tolerance (the
    solver reports, it does not mask), finite fields."""
    import dataclasses

    cfg = ns.preset_gpu(nx=20, nt=1, compat=False, dtype="float32")
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, poisson_backend="fdm", fdm_refine=0, eps_it=1e-12))
    s = ns.ChorinSolver(cfg)
    st, stats = s.step_jit(s.init_state())
    assert int(stats.iters) == 0
    assert float(stats.err) > 1e-12
    assert np.isfinite(np.asarray(st.pr)).all()


def test_fdm_step_has_no_grid_sized_literals():
    """The fdm step's lowered program must carry NO full-grid constants.

    Trace-time eager evaluation materializes anything computed from
    concrete closures as a literal per call site — at the 511 showcase
    grid that was 4 copies of the 189 MB 3-D eigenvalue sum plus the
    189 MB static boundary field (~1 GB of literals), which bloats
    compilation on every backend. The fix threads the 1-D eigenvalue
    vectors and the static field through the jit boundary as runtime
    arguments (ChorinSolver._step_fdm_aux); this pins that no literal
    within 4x of the interior-grid size survives in the StableHLO, for
    both variants, so a refactor cannot silently reintroduce the
    inlining."""
    import dataclasses
    import re

    import jax

    for preset, variant in ((ns.preset_gpu, "gpu"), (ns.preset_multi,
                                                     "multi")):
        cfg = preset(nx=20, nt=1, compat=False, dtype="float32")
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend="fdm"))
        s = ns.ChorinSolver(cfg)
        g = s.grid
        interior_bytes = (g.nx - 2) * (g.ny - 2) * (g.nz - 2) * 4
        state_struct = jax.eval_shape(s.init_state)
        aux_struct = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), s._fdm_aux)
        txt = jax.jit(s._step_fdm_aux, donate_argnums=0).lower(
            state_struct, aux_struct).as_text()
        # dense<"0x..."> hex payloads; the eigenvector matrices are
        # (n-2)^2 — far below the interior size — and everything else
        # legitimate is 1-D/2-D
        biggest = max((len(m.group(1)) // 2 for m in re.finditer(
            r'dense<"0x([0-9A-Fa-f]+)">', txt)), default=0)
        assert biggest < interior_bytes // 4, (
            f"{variant}: a {biggest}-byte literal survives in the fdm "
            f"step lowering (interior grid = {interior_bytes} bytes) — "
            "a full-grid constant is being inlined again")

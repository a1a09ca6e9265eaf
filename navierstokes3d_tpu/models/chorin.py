"""Chorin projection solver: the full time step as one jittable function.

Step structure (reference: the time loop at NavierStokes3D_gpu.jl:119-171 /
NavierStokes3D_multi_gpu.jl:446-477):

  1. viscous stress + predictor            update_τ! / predict_V!
  2. immersed cylinder mask                set_cylinder!
  3. divergence (Poisson RHS)              update_∇V!
  4. pseudo-transient Poisson solve        update_dPrdτ!/update_Pr!/set_bc_Pr!
     with residual checks every nchk iterations and early exit
  5. velocity correction + cylinder + BCs  correct_V!/set_cylinder!/set_bc_Vel!
  6. semi-Lagrangian advection             advect!

The reference's Poisson loop syncs to the host at every residual check
(gpu.jl:132). Here the entire solve — including the convergence check and,
on a sharded run, the cross-device max-reduction — lives inside one
lax.while_loop under jit: zero host round-trips per step.

Loop equivalence with the reference's `for iter=1:niter ... break`:
  * run chunks of nchk iterations; after each chunk compute err; stop when
    err < eps_it, err non-finite, or niter//nchk chunks done;
  * if never converged, run the trailing niter % nchk iterations unchecked
    (the reference's final partial chunk).
"""

from __future__ import annotations

import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..bc import make_bc_fns, make_bc_pr_pair
from ..config import SimConfig
from ..grid import Grid, make_grid
from ..ops import ds as dsops
from ..ops import physics as ph
from ..ops.advect import advect
from ..ops.cylinder import CylinderMasks, apply_cylinder, build_masks
from ..ptloop import pt_loop, pt_loop_fused
from ..state import FlowState, StepStats, zeros_state

def _two_sum(a, b):
    """Knuth two_sum: s = fl(a + b), e such that a + b = s + e exactly."""
    s = a + b
    ap = s - b
    bp = s - ap
    return s, (a - ap) + (b - bp)


class ChorinSolver:
    """Owns config-derived constants, masks and BC closures; exposes pure
    jittable `init_state`, `step`, and `poisson_solve`."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.grid: Grid = make_grid(cfg)
        self.dtype = cfg.numerics.jnp_dtype
        if self.dtype == jnp.float64 and not jax.config.jax_enable_x64:
            raise RuntimeError(
                "float64 requested but jax_enable_x64 is off; set "
                "jax.config.update('jax_enable_x64', True) or use float32.")
        self.masks: CylinderMasks = build_masks(cfg, self.grid)
        self._init_split()
        self.set_bc_vel, self.set_bc_pr = make_bc_fns(
            cfg, self.grid, pressure_split=self.pressure_split)
        # (hi, lo) image of set_bc_pr for the stored pressure pair
        # (FlowState.pr_lo); only the f32 accuracy phases consume it.
        self.set_bc_pr_pair = make_bc_pr_pair(
            cfg, self.grid, pressure_split=self.pressure_split)
        stall_on = cfg.numerics.stall_exit
        if stall_on is None:
            stall_on = not cfg.compat
        self._stall = ((cfg.numerics.stall_ratio, cfg.numerics.stall_checks)
                       if stall_on else None)
        # advection backend (NS3D_ADVECT overrides): the reference's own
        # per-point trilinear gather (gpu.jl:288-334), with no
        # displacement window. On an H100 it advects the 255x153x153
        # float32 fields in 1.0 ms against 5.7-6.4 ms for select-shift
        # at k=2 (benchmarks/sweep_trace.py; PERF.md).
        self.advect_method = os.environ.get("NS3D_ADVECT", "gather")
        # select-shift window: (2k+2)^3 accumulation terms per field;
        # k=2 is a 2x margin over the CFL_adv=1 displacement bound
        # (ops/advect.py), clamp-counted beyond. The fullstep schedule's
        # advection halo depth follows it for both backends.
        self.advect_k = int(os.environ.get("NS3D_ADVECT_K", "2"))
        # fdm backend: two classes of full-grid data must enter jitted
        # steps as RUNTIME ARGUMENTS, never closure constants — anything
        # closed over concretely is (a) evaluated eagerly at trace time
        # if operated on, and (b) inlined into the lowered program as a
        # literal. At the 511 grid that meant 4 copies of the 3-D
        # eigenvalue sum (one per modal_scale call site) plus the static
        # boundary field — ~1 GB of literals in every compile of the
        # step. The threaded aux dict carries the 1-D eigenvalue vectors (the 3-D sum is
        # then STAGED and built on device) and, for the gpu variant, the
        # host-f64-solved static boundary field (_build_fdm_static).
        # _fdm_aux_arg holds the threaded tracers for the duration of a
        # trace; unjitted steps fall back to the concrete closures.
        self._fdm_static = None
        self._fdm_aux = None
        self._fdm_aux_arg = None
        if cfg.numerics.poisson_backend == "fdm":
            from ..ops.fdm_poisson import build_fdm_solver
            self._fdm_solve = build_fdm_solver(self.grid, cfg.variant,
                                               self.dtype)
            aux = {"eigs": self._fdm_solve.eig_consts}
            if cfg.variant == "gpu":
                self._fdm_static = self._build_fdm_static()
                aux["static"] = self._fdm_static
            self._fdm_aux = aux
        if self._fdm_aux is None:
            self.step_jit = jax.jit(self.step, donate_argnums=0)
        else:
            inner = jax.jit(self._step_fdm_aux, donate_argnums=0)
            # device_put LAZILY on first step (constructing a solver must
            # not touch the device); cached so later steps reuse the
            # buffers instead of re-transferring host arrays every call.
            self._fdm_aux_dev = None

            def step_jit(state):
                if self._fdm_aux_dev is None:
                    self._fdm_aux_dev = jax.device_put(self._fdm_aux)
                return inner(state, self._fdm_aux_dev)

            self.step_jit = step_jit

    def _step_fdm_aux(self, state, fdm_aux):
        """step() with the fdm aux pytree (eigenvalue vectors + optional
        static boundary field, see __init__) threaded as an argument so
        they are device buffers, never compile-time literals."""
        self._fdm_aux_arg = fdm_aux
        try:
            return self.step(state)
        finally:
            self._fdm_aux_arg = None

    def _build_fdm_static(self):
        """gpu-variant fdm backend: the hydrostatic Dirichlet x planes
        (gpu.jl:257-261) put ~1e9-scale boundary terms in the Poisson RHS,
        which would drown the physics in float32. Solve the static
        boundary-driven part ONCE in float64 on the host; per step only
        the dynamic rho/dt divv part is solved on device
        (_poisson_solve_fdm)."""
        grid, phys = self.grid, self.cfg.physics
        iz = np.arange(1, grid.nz + 1, dtype=np.float64)
        prof = phys.rho * phys.g * (grid.nz - iz + 0.5) * grid.dz
        prof2d = np.broadcast_to(prof[None, :], (grid.ny, grid.nz))
        cx = 1.0 / (grid.dx * grid.dx)
        rhs_b = np.zeros((grid.nx - 2, grid.ny - 2, grid.nz - 2))
        rhs_b[0] -= (prof2d[1:-1, 1:-1] + 100.0) * cx
        rhs_b[-1] -= prof2d[1:-1, 1:-1] * cx
        from ..ops.fdm_poisson import solve_host_f64
        return np.asarray(solve_host_f64(grid, self.cfg.variant, rhs_b),
                          np.dtype(jnp.dtype(self.dtype).name))

    def _init_split(self):
        """Hydrostatic pressure split (NumericsConfig.pressure_split):
        state.pr stores p' = Pr - P_static(z), with P_static the exact
        init/BC profile rho*g*(nz-iz+0.5)*dz (gpu.jl:87,257-261 — both are
        the same linear-in-z profile). Algebraically identical to the
        reference formulation; see config.py for the float32 rationale."""
        cfg, phys, grid = self.cfg, self.cfg.physics, self.grid
        if cfg.compat and cfg.numerics.poisson_backend == "fdm":
            raise ValueError(
                "poisson_backend='fdm' replaces the reference's Poisson "
                "loop (direct solve + compensated refinement against the "
                "folded operator) and cannot compose with compat mode")
        want = cfg.numerics.pressure_split
        if want is None:
            want = (cfg.variant == "gpu" and not cfg.compat
                    and phys.g != 0.0
                    and cfg.numerics.poisson_backend != "fdm")
        self.pressure_split = bool(want)
        ext = cfg.numerics.extended_precision
        if ext is None:
            # f32 production runs carry the (hi,lo) stored pair whenever
            # the PT backend solves in f32 — not only under the gpu
            # variant's hydrostatic split: the multi variant's developing
            # inflow raises the pressure's dynamic range until the plain
            # f32 residual floor crosses eps_it (measured: nx=63 stalls
            # at step 7 with err 1.8e-3; with the pair every step
            # reproduces the f64 iteration counts exactly). compat keeps
            # the reference's plain iterate; fdm handles its own accuracy.
            ext = (cfg.numerics.jnp_dtype == jnp.float32
                   and not cfg.compat
                   and cfg.numerics.poisson_backend != "fdm")
        elif ext and cfg.compat:
            raise ValueError("extended_precision changes the iterate and "
                             "cannot compose with compat mode")
        self.extended = bool(ext)
        # Accuracy phase (NumericsConfig.accuracy): 'extended' runs the
        # (hi, lo) pair from the first sweep and reproduces the Float64
        # reference's iteration counts; 'none' keeps the plain iterate.
        acc = cfg.numerics.accuracy
        if acc not in (None, "extended", "none"):
            raise ValueError(f"accuracy must be extended/none, got {acc!r}")
        self.accuracy = ("none" if not self.extended or acc == "none"
                         else "extended")
        if self.pressure_split:
            if cfg.numerics.poisson_backend == "fdm":
                raise NotImplementedError(
                    "pressure_split composes only with the 'pt' backend "
                    "(the fdm backend hoists the static boundary terms "
                    "itself)")
            iz = np.arange(1, grid.nz + 1, dtype=np.float64)
            self._p_static = (phys.rho * phys.g
                              * (grid.nz - iz + 0.5) * grid.dz)  # (nz,)
        else:
            self._p_static = None
        # Folded-BC RHS hoist (full cell-centered shape): the affine-z BC
        # of the split field drops a CONSTANT -+rho*g*dz neighbor term at
        # the z-adjacent interior planes; rhs_folded = rhs - hoist. Zero
        # when the split is off (plain zero-gradient terms vanish).
        zh = np.zeros(grid.nz)
        if self.pressure_split:
            rho_g_dz = phys.rho * phys.g * grid.dz
            zh[1] = -rho_g_dz / grid.dz / grid.dz
            zh[grid.nz - 2] = +rho_g_dz / grid.dz / grid.dz
        self._z_hoist = zh  # (nz,), full-shape z index
        self._flap = None   # lazily-built folded interior Laplacian
        self._fcomp = None  # lazily-built compensated pair residual

    def full_pressure(self, pr) -> jax.Array:
        """Physical pressure Pr from the state's pressure field (identity
        unless the hydrostatic split is active)."""
        if not self.pressure_split:
            return pr
        return pr + jnp.asarray(self._p_static, pr.dtype)[None, None, :]

    def gather_inner(self, state: "FlowState"):
        """gather_inner with the physical (unsplit) pressure."""
        return gather_inner(
            state if not self.pressure_split
            else state.replace(pr=self.full_pressure(state.pr)))

    def step_sharded_jit(self, mesh):
        """Jitted step over a 3D device mesh (global-view SPMD path).

        The XLA SPMD partitioner turns the stencil slices into neighbor
        collective-permutes (halo exchanges) and the residual max into an
        all-reduce, all inside the jitted while_loop — the replacement for
        the reference's update_halo!/MPI.Allreduce
        (NavierStokes3D_multi_gpu.jl:450-466).
        """
        from ..parallel.mesh import replicated, state_shardings
        import functools
        sh = state_shardings(mesh, self.grid.shape_c)
        rep = replicated(mesh)
        # want_pair=False: the sharded pytrees stay pair-free (sh/stats_sh
        # declare no pr_lo). Single-chip users get the pair via step_jit;
        # a state carrying one must drop it (state.replace(pr_lo=None))
        # before entering a distributed step.
        poisson_fn = functools.partial(self.poisson_solve, want_pair=False)
        step = lambda state: self._step_impl(state, poisson_fn)
        # stats sharding template: derive the pytree structure (which
        # optional channels the selected backend emits) by abstract
        # evaluation instead of re-encoding the dispatch logic here
        state_struct = jax.eval_shape(self.init_state)
        if self._fdm_aux is not None:
            # fdm backend: thread the aux pytree (1-D eigenvalue vectors
            # + the gpu variant's full-grid static boundary field) as
            # replicated runtime arguments — same reason as step_jit in
            # __init__: closure constants are inlined as literals into
            # the lowered program. Replication is
            # correct and cheap in compile size; the partitioner slices
            # the static locally for the sharded p_int + static add, no
            # collectives.
            def step_aux(state, fdm_aux):
                self._fdm_aux_arg = fdm_aux
                try:
                    return step(state)
                finally:
                    self._fdm_aux_arg = None
            aux_struct = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                self._fdm_aux)
            aux_sh = jax.tree.map(lambda _: rep, self._fdm_aux)
            _, stats_struct = jax.eval_shape(step_aux, state_struct,
                                             aux_struct)
            stats_sh = jax.tree.map(lambda _: rep, stats_struct)
            inner = jax.jit(step_aux, donate_argnums=0,
                            in_shardings=(sh, aux_sh),
                            out_shardings=(sh, stats_sh))
            aux_dev_cell = []

            def sharded_step(state):
                if not aux_dev_cell:
                    aux_dev_cell.append(
                        jax.device_put(self._fdm_aux, aux_sh))
                return inner(state, aux_dev_cell[0])

            return sharded_step
        _, stats_struct = jax.eval_shape(step, state_struct)
        stats_sh = jax.tree.map(lambda _: rep, stats_struct)
        return jax.jit(step, donate_argnums=0,
                       in_shardings=(sh,), out_shardings=(sh, stats_sh))

    # ---- initialization ----

    def init_state(self) -> FlowState:
        """Initial conditions per variant.

        multi (NavierStokes3D_multi_gpu.jl:368-373): inflow plane velocity
        (written to Vy[1,:,:] in the reference — a typo kept under compat;
        Vx under compat=False), hydrostatic pressure from global z
        (zero when g=0), then the cylinder mask.
        gpu (NavierStokes3D_gpu.jl:84-88): 1/6-power-law Vx profile and
        hydrostatic pressure; no cylinder application at init.
        """
        cfg, g, grid = self.cfg, self.cfg.physics.g, self.grid
        rho = cfg.physics.rho
        st = zeros_state(grid, self.dtype)
        if cfg.variant == "multi":
            if cfg.compat:
                st = st.replace(vy=st.vy.at[0, :, :].set(cfg.physics.vin))
            else:
                st = st.replace(vx=st.vx.at[0, :, :].set(cfg.physics.vin))
            # Pr(iz) = -(z_g(iz) - dz/2) ρ g with z_g(iz) = (iz-1) dz (:370)
            iz = np.arange(1, grid.nz + 1)
            pr_prof = -(((iz - 1) * grid.dz) - grid.dz / 2) * rho * g
            pr = jnp.broadcast_to(
                jnp.asarray(pr_prof, dtype=self.dtype)[None, None, :],
                grid.shape_c)
            st = st.replace(pr=pr)
            c, vx, vy, vz = apply_cylinder(st.c, st.vx, st.vy, st.vz, self.masks)
            st = st.replace(c=c, vx=vx, vy=vy, vz=vz)
        else:  # gpu variant
            zc = grid.zc()
            prof = cfg.physics.vin * (7.0 / 6.0) * (
                (zc + grid.lz / 2) / grid.lz) ** (1.0 / 6.0)
            vx = jnp.broadcast_to(
                jnp.asarray(prof, dtype=self.dtype)[None, None, :],
                grid.shape_vx)
            if self.pressure_split:
                # the hydrostatic init IS P_static: p' starts at exactly 0
                st = st.replace(vx=vx)
            else:
                pr_prof = -(zc - grid.lz / 2) * rho * g
                pr = jnp.broadcast_to(
                    jnp.asarray(pr_prof, dtype=self.dtype)[None, None, :],
                    grid.shape_c)
                st = st.replace(vx=vx, pr=pr)
        return st

    # ---- Poisson solve ----

    def poisson_solve(self, pr, dprdtau, divv, *, want_pair=True):
        """Dispatch to the configured Poisson backend: 'fdm', the folded
        'pt' loop (compat=False) or the reference's exact 'pt' loop.

        want_pair=False suppresses the stored-pressure pair channel
        (StepStats.pr_lo) that the f32 accuracy phases emit — the
        distributed wrappers pass False so their stats/state pytree
        structure stays pair-free (the pair is a single-chip showcase
        feature; f64 distributed runs have no storage floor to lift)."""
        if self.cfg.numerics.poisson_backend == "fdm":
            return self._poisson_solve_fdm(pr, dprdtau, divv,
                                           want_pair=want_pair)
        if not self.cfg.compat:
            return self._poisson_solve_jnp_folded(pr, dprdtau, divv,
                                                  want_pair=want_pair)
        return self._poisson_solve_jnp(pr, dprdtau, divv)

    def _poisson_solve_fdm(self, pr, dprdtau, divv, *, want_pair=True):
        """Direct solve via fast diagonalization + compensated iterative
        refinement (ops/fdm_poisson): 6 dense transform passes solve the
        pressure system outright, then up to NumericsConfig.fdm_refine
        rounds of { r = compensated residual of the (hi, lo) pressure
        pair; e = fdm(-r); pair (+)= e } drive the STORED state below
        eps_it — the same stored-state criterion stored_residual_err
        evaluates, so stats.err here IS the honest pair residual. The
        loop exits as soon as err < eps_it; stats.iters counts refinement
        rounds (each ~12 transform passes), not PT iterations. This
        replaces the reference's thousands of pseudo-transient iterations
        per step (gpu.jl:126-137). dprdtau passes through untouched (it
        is pseudo-transient state; switching backends mid-run simply
        warm-starts 'pt' from wherever it was). The path is pure jnp
        (einsums + elementwise), so the SPMD partitioner can shard it."""
        grid, phys = self.grid, self.cfg.physics
        # _fdm_solve and the aux pytree are built eagerly in __init__
        # (backend == 'fdm' is config-fixed). Prefer the threaded runtime
        # arguments (tracers during jitted traces — keeps the 3-D
        # eigenvalue sum and static field out of the compiled program's
        # literals); unjitted callers fall back to the concrete closures.
        aux = self._fdm_aux_arg
        fdm_eigs = aux["eigs"] if aux is not None else None
        fdm_static = (aux.get("static") if aux is not None
                      else self._fdm_static)
        rho, dt = phys.rho, grid.dt
        num = self.cfg.numerics
        eps_it = num.eps_it
        err_scale = (grid.ly * grid.ly) / phys.psc
        fdm = self._fdm_solve
        use_pair = jnp.dtype(self.dtype) == jnp.float32

        if use_pair:
            # (hi, lo) RHS pair (ops/ds.rhs_pair): lo carries the f32
            # rounding of the RHS so the refinement targets the true
            # (f64-defined) right-hand side — without it eps32*|rhs|
            # (~7e-4 err units at 255) floors just under the criterion.
            rhs_hi3, rhs_lo3 = dsops.rhs_pair(divv, rho / dt, None)
            rhs_hi = rhs_hi3[1:-1, 1:-1, 1:-1]
            rhs_lo = rhs_lo3[1:-1, 1:-1, 1:-1]
            comp = self._comp_residual_fn()

            def resid(pr_v, lo_v):
                return comp(pr_v, lo_v, rhs_hi, rhs_lo)
        else:
            # f64: a plain folded-stencil residual carries ~eps64 noise,
            # far below eps_it — no compensation needed.
            rhs_hi = ((rho / dt) * divv[1:-1, 1:-1, 1:-1]).astype(self.dtype)
            lap = self._folded_lap_fn()

            def resid(pr_v, lo_v):
                r = lap(pr_v) - rhs_hi
                return r, jnp.max(jnp.abs(r))

        p_int = fdm(rhs_hi, eigs=fdm_eigs)
        if fdm_static is not None:
            p_int = p_int + fdm_static
        # Zero-pad insertion, NOT pr.at[1:-1,...].set(p_int): set_bc_pr
        # overwrites every boundary face anyway (both variants write all
        # six planes; verified bit-identical single-device), and the
        # DUS-into-pr form miscompiles under the GSPMD partitioner — on a
        # (2,2,2) mesh the x-shard-boundary plane of the update is
        # silently dropped (diff 0.112 at nx=16 f64, the whole i=8 plane
        # keeping pr0's values; tests/test_direct_solve.py
        # ::test_fdm_backend_sharded_equals_single guards this).
        pr = jnp.pad(p_int.astype(self.dtype), 1)
        pr = self.set_bc_pr(pr)
        lo = jnp.zeros_like(pr)
        if use_pair:
            # Install the (hi, lo) Dirichlet plane image BEFORE the
            # refinement: the pair image carries the f64 profile's f32
            # rounding remainder in the lo planes (bc.make_bc_pr_pair),
            # and the stored-state criterion reads those planes through
            # the folded masks — refining against lo-planes = 0 would
            # converge a ~1e-2-err-units-different problem (measured:
            # stored_err 9.4e-3 at 255 while the in-solve err read
            # 1.4e-8).
            pr, lo = self.set_bc_pr_pair(pr, lo)

        # Refinement loop. The Dirichlet planes are frozen after the
        # BC application above (the correction problem has homogeneous
        # BCs — exactly the operator build_fdm_solver diagonalizes) and
        # the compensated residual's folded masks never read the
        # zero-grad planes, so BCs need no re-application inside the
        # loop.
        nchunks = grid.niter // grid.nchk
        hist0 = jnp.full((nchunks,), jnp.nan, self.dtype)
        r0, emax0 = resid(pr, lo)
        err0 = (emax0 * err_scale).astype(self.dtype)
        hist0 = hist0.at[0].set(err0)
        max_ref = jnp.int32(num.fdm_refine)

        # Elementwise interior mask: like the zero-pad insertion above,
        # this replaces the .at[1:-1,...].set() dynamic-update-slice,
        # whose DUS-then-read-overlapping-planes composition miscompiles
        # under the GSPMD partitioner (docs/gspmd_dus_note.md) — resid()
        # reads the pair's BC planes through the folded masks right after
        # the write. where(mask, pad(inner), full) is bit-identical.
        sh_c = pr.shape
        interior = jnp.ones(tuple(d - 2 for d in sh_c), bool)
        interior = jnp.pad(interior, 1, constant_values=False)

        def insert_interior(full, inner):
            return jnp.where(interior, jnp.pad(inner, 1), full)

        def cond_fn(c):
            _, _, _, k, err, _ = c
            return (err >= eps_it) & (k < max_ref)

        def body_fn(c):
            pr_v, lo_v, r, k, _, hist = c
            # resid returns r = lap(p) - rhs, so the correction solves
            # lap(e) = -r (the defect phase's rhs_c = -r0 convention)
            e = fdm(-r.astype(self.dtype), eigs=fdm_eigs)
            nh, t = dsops.two_sum(pr_v[1:-1, 1:-1, 1:-1], e)
            nl = lo_v[1:-1, 1:-1, 1:-1] + t
            nh, nl = dsops.two_sum(nh, nl)
            pr_v = insert_interior(pr_v, nh)
            lo_v = insert_interior(lo_v, nl)
            r2, emax2 = resid(pr_v, lo_v)
            err2 = (emax2 * err_scale).astype(self.dtype)
            hist = hist.at[jnp.minimum(k + 1, nchunks - 1)].set(err2)
            return pr_v, lo_v, r2, k + jnp.int32(1), err2, hist

        pr, lo, _, nref, err, hist = lax.while_loop(
            cond_fn, body_fn,
            (pr, lo, r0, jnp.int32(0), err0, hist0))

        if want_pair and use_pair:
            pr, lo = self.set_bc_pr_pair(pr, lo)
            return pr, dprdtau, StepStats(iters=nref, err=err,
                                          err_hist=hist, pr_lo=lo)
        # Fold the pair: after the renormalizing two_sum, hi IS the
        # correctly-rounded sum, so dropping lo costs <= 0.5 ulp of the
        # stored field (err still reports the pair's residual — the
        # criterion the loop drove below eps_it).
        pr = self.set_bc_pr(pr)
        return pr, dprdtau, StepStats(iters=nref, err=err, err_hist=hist)

    def _folded_masks(self, dtype):
        """Per-axis neighbor coefficient masks of the folded stencil,
        broadcast-shaped, as NumPy (so cached closures hold no traced
        values — these may be first built inside a jit trace)."""
        grid = self.grid
        nx, ny, nz = grid.nx, grid.ny, grid.nz

        def masks_1d(n, lo_zero_grad, hi_zero_grad):
            am = np.ones(n - 2, dtype)
            ap = np.ones(n - 2, dtype)
            if lo_zero_grad:
                am[0] = 0.0
            if hi_zero_grad:
                ap[-1] = 0.0
            return am, ap

        if self.cfg.variant == "multi":
            # bc_x zero-grad lo; hi ends Dirichlet 0 (outlet overwrite)
            axm, axp = masks_1d(nx, True, False)
            aym, ayp = masks_1d(ny, True, True)
            azm, azp = masks_1d(nz, True, True)
        else:  # gpu: x Dirichlet both (hydrostatic), y/z zero-grad
            axm, axp = masks_1d(nx, False, False)
            aym, ayp = masks_1d(ny, True, True)
            azm, azp = masks_1d(nz, True, True)
        return (axm[:, None, None], axp[:, None, None],
                aym[None, :, None], ayp[None, :, None],
                azm[None, None, :], azp[None, None, :])

    def _comp_residual_fn(self):
        """Compensated folded residual of a (hi, lo) pressure pair against
        a (hi, lo) RHS pair, used by the folded backend's
        defect-correction finisher, the fdm refinement loop and
        stored_residual_err.

        A single f32 evaluation of lap(p) - rhs carries rounding
        ~eps32*|rhs| (~2e-3 err units at the showcase preset) — above
        eps_it, so it can neither define a correction problem nor report
        an honest final err. This evaluation tracks every first-order
        rounding term (two_sum neighbor diffs, Dekker products against
        f64-split weights, compensated accumulation), bringing the error
        down to ~eps32*|resid|. Runs once per restart — not hot."""
        if self._fcomp is not None:
            return self._fcomp
        grid = self.grid
        dx, dy, dz = grid.dx, grid.dy, grid.dz
        masks = self._folded_masks(np.float64)
        quads = [dsops.weight_quad(m / h / h) for m, h in
                 zip(masks, (dx, dx, dy, dy, dz, dz))]

        def comp(hi, lo, rhs_hi, rhs_lo):
            hic = hi[1:-1, 1:-1, 1:-1]
            loc = lo[1:-1, 1:-1, 1:-1]
            nbs = ((hi[:-2, 1:-1, 1:-1], lo[:-2, 1:-1, 1:-1]),
                   (hi[2:, 1:-1, 1:-1], lo[2:, 1:-1, 1:-1]),
                   (hi[1:-1, :-2, 1:-1], lo[1:-1, :-2, 1:-1]),
                   (hi[1:-1, 2:, 1:-1], lo[1:-1, 2:, 1:-1]),
                   (hi[1:-1, 1:-1, :-2], lo[1:-1, 1:-1, :-2]),
                   (hi[1:-1, 1:-1, 2:], lo[1:-1, 1:-1, 2:]))
            pairs = []
            for (nb_hi, nb_lo), quad in zip(nbs, quads):
                dh, dl = dsops.two_sum(nb_hi, -hic)
                dl = dl + (nb_lo - loc)
                pairs.append(dsops.weighted_term(dh, dl, quad))
            pairs.append((-rhs_hi, -rhs_lo))
            s, c = dsops.accumulate(pairs)
            r = s + c
            return r, jnp.max(jnp.abs(r))

        self._fcomp = comp
        return comp

    def _folded_lap_fn(self):
        """Interior Laplacian with the boundary conditions folded in:
        zero-gradient neighbor terms dropped via coefficient masks (the
        difference vanishes after BC application), Dirichlet planes read
        as-is (they are loop-invariant). Shared by the folded backend and
        the f64 fdm refinement residual."""
        if self._flap is not None:
            return self._flap
        dx, dy, dz = self.grid.dx, self.grid.dy, self.grid.dz
        axm, axp, aym, ayp, azm, azp = self._folded_masks(self.dtype)

        def lap_folded(pr):
            pc = pr[1:-1, 1:-1, 1:-1]
            return ((axp * (pr[2:, 1:-1, 1:-1] - pc)
                     + axm * (pr[:-2, 1:-1, 1:-1] - pc)) / dx / dx
                    + (ayp * (pr[1:-1, 2:, 1:-1] - pc)
                       + aym * (pr[1:-1, :-2, 1:-1] - pc)) / dy / dy
                    + (azp * (pr[1:-1, 1:-1, 2:] - pc)
                       + azm * (pr[1:-1, 1:-1, :-2] - pc)) / dz / dz)

        self._flap = lap_folded
        return lap_folded

    def _poisson_solve_jnp_folded(self, pr, dprdtau, divv, max_chunks=None,
                                  want_pair=True):
        """Poisson solve with the boundary conditions folded into the
        stencil: zero-gradient faces become dropped neighbor terms
        (coefficient masks), Dirichlet faces are loop-invariant planes,
        and the RHS is hoisted — so one iteration is two fused elementwise
        passes with NO per-iteration boundary-plane updates.

        Equivalence with the reference's update-then-BC sequence: after
        bc, lap at a cell adjacent to a zero-gradient face reads a copy of
        its own updated neighbor, i.e. that difference term vanishes;
        Dirichlet planes are invariant under the interior-only update.
        The first iteration reads the incoming (possibly BC-inconsistent)
        boundary planes exactly like the reference, so it runs in exact
        form before the Dirichlet planes are frozen.
        """
        grid, phys, num = self.grid, self.cfg.physics, self.cfg.numerics
        rho, dt, dtau, damp = phys.rho, grid.dt, grid.dtau, grid.damp
        dx, dy, dz = grid.dx, grid.dy, grid.dz
        eps_it = num.eps_it
        nchunks = grid.niter // grid.nchk
        rem = grid.niter - nchunks * grid.nchk
        if max_chunks is not None:
            nchunks = min(nchunks, max_chunks)
            rem = 0
        dtype = self.dtype
        lap_folded = self._folded_lap_fn()

        extended = self.accuracy == "extended" and dtype == jnp.float32
        zh = self._z_hoist[1:-1] if self.pressure_split else None
        if extended:
            # (hi, lo) RHS pair: hi is bit-identical to the plain f32
            # computation below (same trajectory); lo carries its
            # first-order rounding, consumed by the compensated residual
            # of the defect-correction finisher (ops/ds.rhs_pair).
            rhs, rhs_lo = dsops.rhs_pair(divv[1:-1, 1:-1, 1:-1],
                                         rho / dt, zh)
        else:
            rhs = ((rho / dt) * divv[1:-1, 1:-1, 1:-1]).astype(dtype)
            if zh is not None:
                # affine z BC (bc.affine_grad_z): the dropped boundary-
                # neighbor term is the CONSTANT -+rho*g*dz, hoisted here
                rhs = rhs - jnp.asarray(zh, dtype)[None, None, :]

        err_scale = (grid.ly * grid.ly) / phys.psc
        if extended:
            # Double-single iterate (NumericsConfig.extended_precision):
            # pr is carried as a (hi, lo) float32 pair. lap(hi)+lap(lo) ==
            # lap(hi+lo) in real arithmetic, and f32-evaluating lap(hi) is
            # nearly exact (neighbor differences of close values round to
            # ~eps*|difference|, not eps*|value|) — so the pair's residual
            # is free of the stored field's representation noise.
            def two_sum(a, b):
                s = a + b
                ap = s - b
                bp = s - ap
                return s, (a - ap) + (b - bp)

            def step_fn(carry, it):
                hi, lo, dpr = carry
                resid = (lap_folded(hi) - rhs) + lap_folded(lo)
                dpr = dpr.at[1:-1, 1:-1, 1:-1].set(
                    dpr[1:-1, 1:-1, 1:-1] * (1.0 - damp) + dtau * resid)
                hi, lo = two_sum(hi, lo + dtau * dpr)
                return ((hi, lo, dpr),
                        jnp.max(jnp.abs(resid)) * err_scale, jnp.int32(1))
        else:
            def step_fn(carry, it):
                pr, dpr = carry
                resid = lap_folded(pr) - rhs
                dpr = dpr.at[1:-1, 1:-1, 1:-1].set(
                    dpr[1:-1, 1:-1, 1:-1] * (1.0 - damp) + dtau * resid)
                pr = pr + dtau * dpr
                return ((pr, dpr),
                        jnp.max(jnp.abs(resid)) * err_scale, jnp.int32(1))

        # iteration 1 in exact form (reads incoming boundary planes),
        # then freeze the Dirichlet planes via set_bc_pr.
        pr, dprdtau = ph.poisson_iter(pr, dprdtau, divv, rho, dt, dtau,
                                      damp, dx, dy, dz)
        pr = self.set_bc_pr(pr)
        carry0 = ((pr, jnp.zeros_like(pr), dprdtau) if extended
                  else (pr, dprdtau))

        carry, it1, err1, hist1 = pt_loop_fused(
            step_fn, carry0, 1, nchunks * grid.nchk + rem, grid.nchk,
            nchunks, eps_it, dtype, stall=self._stall)
        if not extended:
            pr, dprdtau = carry
            # materialize the zero-gradient boundary planes
            pr = self.set_bc_pr(pr)
            return pr, dprdtau, StepStats(iters=it1, err=err1,
                                          err_hist=hist1)

        # ---- defect-correction finisher (extended path) ----
        # The double-single loop's observable residual carries plain-f32
        # evaluation noise ~eps32*|rhs| (~2e-3 err units at 127+-class
        # gpu grids), so at large grids the loop exits via the stall
        # detector ABOVE eps_it even though f64 converges. So
        # evaluate the true residual r0 once with compensated arithmetic
        # (error ~eps32*|r0|, against the (hi, lo) RHS pair) and solve
        # lap(delta) = -r0 with the plain loop — the correction problem's
        # scale is |r0|, so plain f32 genuinely reaches eps_it. err0
        # seeding makes it a no-op when the pair loop already converged
        # (iteration counts then keep their f64 parity,
        # tests/test_precision.py::test_extended_f32_converges_like_f64).
        hi1, lo1, dpr1 = carry
        comp = self._comp_residual_fn()
        r0, emax = comp(hi1, lo1, rhs, rhs_lo)
        errh = emax * jnp.asarray(err_scale, dtype)
        rhs_c = -r0

        def stepd(c2, it):
            d, dpr = c2
            resid = lap_folded(d) - rhs_c
            dpr = dpr.at[1:-1, 1:-1, 1:-1].set(
                dpr[1:-1, 1:-1, 1:-1] * (1.0 - damp) + dtau * resid)
            d = d + dtau * dpr
            return ((d, dpr),
                    jnp.max(jnp.abs(resid)) * err_scale, jnp.int32(1))

        # delta starts at 0 (its BCs are the homogeneous image of the
        # pressure BCs, already folded into lap_folded/rhs) but dprdtau
        # CARRIES OVER: by linearity the correction continues the
        # phase-1 PT trajectory exactly, just evaluated against |r0|.
        (dl, dprdtau), it2, err2, hist2 = pt_loop_fused(
            stepd, (jnp.zeros_like(hi1), dpr1), 0,
            nchunks * grid.nchk + rem, grid.nchk, nchunks, eps_it,
            dtype, stall=self._stall, err0=errh)
        iters = it1 + it2
        # honest err: the compensated entry evaluation when the pair loop
        # had converged (it2 == 0), else the correction loop's exit
        # residual (evaluated at |r0| scale — noise-free by construction)
        err = jnp.where(it2 > 0, err2, errh)
        hist = jnp.where(jnp.isnan(hist1),
                         jnp.roll(hist2, it1 // grid.nchk), hist1)
        hi2, lo2 = _two_sum(hi1, lo1 + dl)
        if want_pair:
            # the converged iterate crosses the step boundary as the
            # stored (hi, lo) pair (FlowState.pr_lo): the STORED state —
            # not just the in-solve iterate — meets eps_it
            hi2, lo2 = self.set_bc_pr_pair(hi2, lo2)
            return hi2, dprdtau, StepStats(iters=iters, err=err,
                                           err_hist=hist, iters_ext=it2,
                                           pr_lo=lo2)
        # hi absorbs lo through the two_sum renormalization, so hi IS
        # the correctly-rounded f32 field
        pr = self.set_bc_pr(hi2)
        return pr, dprdtau, StepStats(iters=iters, err=err,
                                      err_hist=hist, iters_ext=it2)

    def _poisson_solve_jnp(self, pr, dprdtau, divv):
        grid, phys = self.grid, self.cfg.physics
        num = self.cfg.numerics
        rho, dt, dtau, damp = phys.rho, grid.dt, grid.dtau, grid.damp
        dx, dy, dz = grid.dx, grid.dy, grid.dz
        eps_it = num.eps_it
        nchunks = grid.niter // grid.nchk
        rem = grid.niter - nchunks * grid.nchk

        def one_iter(_, carry):
            pr, dpr = carry
            pr, dpr = ph.poisson_iter(pr, dpr, divv, rho, dt, dtau, damp,
                                      dx, dy, dz)
            pr = self.set_bc_pr(pr)
            return (pr, dpr)

        def run_iters(pr, dpr, n):
            return lax.fori_loop(0, n, one_iter, (pr, dpr))

        def residual_err(pr):
            # err = max|Rp| * ly^2 / psc, in the reference's evaluation
            # order (NavierStokes3D_gpu.jl:132).
            rp = ph.poisson_residual(pr, divv, rho, dt, dx, dy, dz)
            return jnp.max(jnp.abs(rp)) * (grid.ly * grid.ly) / phys.psc

        # the exact backend serves the compat path: reference loop
        # semantics exactly, no stall exit
        pr, dprdtau, iters, err, hist = pt_loop(
            lambda p, d, n, k: run_iters(p, d, n), residual_err,
            pr, dprdtau, nchunks, grid.nchk, rem, eps_it, self.dtype,
            stall=None)
        return pr, dprdtau, StepStats(iters=iters, err=err, err_hist=hist)

    def step_shard_map_jit(self, mesh):
        """Jitted step whose Poisson hot loop runs under shard_map with
        explicit ppermute halo exchanges and in-loop pmax reductions
        (parallel/halo.py); the rest of the step stays global-view (XLA
        partitions it). The communication-honest scaling path."""
        from ..parallel.halo import build_poisson_shard_map
        from ..parallel.mesh import replicated, state_shardings
        solve = build_poisson_shard_map(
            mesh, self.grid, self.cfg.physics, self.cfg.numerics.eps_it,
            self.cfg.variant, self.dtype,
            halo_width=self.cfg.parallel.halo,
            pressure_split=self.pressure_split, stall=self._stall)
        rho, dt = self.cfg.physics.rho, self.grid.dt

        def poisson(pr, dprdtau, divv):
            pr, dprdtau, iters, err, hist = solve(pr, dprdtau,
                                                  (rho / dt) * divv)
            return pr, dprdtau, StepStats(iters=iters, err=err,
                                          err_hist=hist)

        sh = state_shardings(mesh, self.grid.shape_c)
        rep = replicated(mesh)
        stats_sh = StepStats(iters=rep, err=rep, err_hist=rep,
                             advect_clamped=rep)
        return jax.jit(lambda state: self._step_impl(state, poisson),
                       donate_argnums=0,
                       in_shardings=(sh,), out_shardings=(sh, stats_sh))

    def step_fullstep_jit(self, mesh):
        """Jitted step with the ENTIRE Chorin step under one shard_map:
        owned-face staggered velocity storage (every field shards on all
        three mesh axes) and explicit ppermute halo exchanges for every
        stage — the communication-complete analog of the reference's
        update_halo! schedule (multi_gpu.jl:446-477). Operates on the
        DistState layout of parallel/fullstep.py (to_dist/from_dist
        convert at I/O boundaries)."""
        from ..parallel.fullstep import build_fullstep
        return build_fullstep(self, mesh)

    # ---- full step ----

    def step(self, state: FlowState) -> Tuple[FlowState, StepStats]:
        return self._step_impl(state, self.poisson_solve)

    def _predict(self, state: FlowState):
        """Stress + predictor + cylinder + divergence (update_τ!,
        predict_V!, set_cylinder!, update_∇V!): the step's prelude.
        Returns (c, vx, vy, vz, divv)."""
        grid, phys = self.grid, self.cfg.physics
        dx, dy, dz = grid.dx, grid.dy, grid.dz
        # Under the hydrostatic split the predictor's -rho*g body force
        # cancels exactly against d/dz P_static in the corrector (both are
        # dt*g per step); folding the cancellation out keeps it exact in
        # float32 instead of round-tripping through two large terms.
        g_eff = 0.0 if self.pressure_split else phys.g
        taus = ph.update_tau(state.vx, state.vy, state.vz, phys.mu,
                             dx, dy, dz)
        vx, vy, vz = ph.predict_v(state.vx, state.vy, state.vz, *taus,
                                  phys.rho, g_eff, grid.dt, dx, dy, dz)
        c, vx, vy, vz = apply_cylinder(state.c, vx, vy, vz, self.masks)
        return c, vx, vy, vz, ph.update_divv(vx, vy, vz, dx, dy, dz)

    def _correct(self, c, vx, vy, vz, pr):
        """Velocity correction + cylinder + velocity BCs (correct_V!,
        set_cylinder!, set_bc_Vel!). Returns (c, vx, vy, vz)."""
        g, rho = self.grid, self.cfg.physics.rho
        vx, vy, vz = ph.correct_v(vx, vy, vz, pr, g.dt, rho, g.dx, g.dy,
                                  g.dz)
        c, vx, vy, vz = apply_cylinder(c, vx, vy, vz, self.masks)
        return (c,) + tuple(self.set_bc_vel(vx, vy, vz))

    def predictor_divv(self, state: FlowState):
        """The predictor-velocity divergence a step taken FROM `state`
        hands to its Poisson solve (the _step_impl prelude, bit-exact
        with every step variant). Jit-safe; use to snapshot the RHS
        before a donating step_jit call deletes `state`
        (stored_residual_err consumes it)."""
        return self._predict(state)[4]

    def stored_residual_err(self, state_after: FlowState, *,
                            state_before: FlowState = None, divv=None):
        """Re-evaluate the reference's convergence criterion on the
        STORED pressure of `state_after` (the state `step` returned):
        max |lap(pr (+) pr_lo) - rhs| * ly^2/psc, with rhs rebuilt
        bit-exactly from the pre-step predictor divergence (pass either
        `state_before` or its `predictor_divv`) and both operands
        evaluated in compensated (double-single) arithmetic — f64-grade
        accuracy in pure f32. The reference evaluates this on its
        Float64 stored field (NavierStokes3D_gpu.jl:132-135); this is
        the independent check that the (hi, lo) stored pair actually
        meets err < eps_it across the step boundary. Jit-safe."""
        if divv is None:
            divv = self.predictor_divv(state_before)
        grid, phys = self.grid, self.cfg.physics
        zh = self._z_hoist[1:-1] if self.pressure_split else None
        rhs_hi, rhs_lo = dsops.rhs_pair(divv[1:-1, 1:-1, 1:-1],
                                        phys.rho / grid.dt, zh)
        comp = self._comp_residual_fn()
        lo = (state_after.pr_lo if state_after.pr_lo is not None
              else jnp.zeros_like(state_after.pr))
        _, emax = comp(state_after.pr, lo, rhs_hi, rhs_lo)
        return emax * (grid.ly * grid.ly) / phys.psc

    def _step_impl(self, state: FlowState, poisson_fn
                   ) -> Tuple[FlowState, StepStats]:
        grid = self.grid
        dt, dx, dy, dz = grid.dt, grid.dx, grid.dy, grid.dz
        c, vx, vy, vz, divv = self._predict(state)
        pr, dprdtau, stats = poisson_fn(state.pr, state.dprdtau, divv)
        # pop the stored-pair low word out of the internal stats channel
        # into the state (the corrector and the next solve's warm start
        # use hi only — the pair's job is making the STORED pressure meet
        # eps_it across the step boundary, docs/numerics.md)
        pr_lo = stats.pr_lo
        stats = stats.replace(pr_lo=None)
        c, vx, vy, vz = self._correct(c, vx, vy, vz, pr)
        # advect_method is read at trace time: clamp escalation (run.py)
        # may flip it to 'gather' and re-jit
        vx, vy, vz, c, n_clamped = advect(vx, vy, vz, c, dt, dx, dy, dz,
                                          compat=self.cfg.compat,
                                          method=self.advect_method,
                                          with_stats=True, k=self.advect_k)
        new_state = FlowState(pr=pr, vx=vx, vy=vy, vz=vz, c=c,
                              dprdtau=dprdtau, pr_lo=pr_lo)
        return new_state, stats.replace(advect_clamped=n_clamped)

    # ---- convenience driver (host loop; I/O hooks live in run.py) ----

    def run(self, nt: int | None = None, state: FlowState | None = None,
            callback=None):
        nt = self.cfg.numerics.nt if nt is None else nt
        state = self.init_state() if state is None else state
        all_stats = []
        for it in range(1, nt + 1):
            state, stats = self.step_jit(state)
            all_stats.append(stats)
            if callback is not None:
                callback(it, state, stats)
        return state, all_stats


def gather_inner(state: FlowState):
    """Global inner fields as returned by the reference's final gather
    (NavierStokes3D_multi_gpu.jl:528-535): C,Pr (nx-2,ny-2,nz-2) and the
    velocities with their staggered dim one larger."""
    sl = slice(1, -1)
    return (
        np.asarray(state.c[sl, sl, sl]),
        np.asarray(state.pr[sl, sl, sl]),
        np.asarray(state.vx[sl, sl, sl]),
        np.asarray(state.vy[sl, sl, sl]),
        np.asarray(state.vz[sl, sl, sl]),
    )

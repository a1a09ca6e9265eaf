"""Flow state pytree.

The reference mutates device arrays in place (Pr, V*, C, dPrdτ allocated at
NavierStokes3D_gpu.jl:65-82). Here state is a functional pytree: every step
maps FlowState -> FlowState, which makes checkpoint/resume trivial and lets
XLA manage buffer aliasing (donation) for in-place updates.

dprdtau is stored at full cell-centered shape (nx,ny,nz) with an inactive
boundary ring (always zero), rather than the reference's (nx-2,ny-2,nz-2)
(NavierStokes3D_gpu.jl:66): uniform shapes shard evenly over a device mesh
and let the pressure update fuse into a single full-array AXPY.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .grid import Grid


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree whose fields are all
    children (a None field is an empty subtree), with `.replace(**kw)`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names,
                                            meta_fields=[])


@pytree_dataclass
class FlowState:
    pr: jax.Array        # pressure, (nx, ny, nz)
    vx: jax.Array        # (nx+1, ny, nz)
    vy: jax.Array        # (nx, ny+1, nz)
    vz: jax.Array        # (nx, ny, nz+1)
    c: jax.Array         # tracer concentration, (nx, ny, nz)
    dprdtau: jax.Array   # pseudo-time pressure derivative, (nx, ny, nz)
    # Low word of the stored pressure pair (float32 accuracy phases
    # only): pr + pr_lo is the converged solution ITERATE, carried
    # across the step boundary so the STORED state — not just the
    # in-solve iterate — meets the reference's err < eps_it criterion
    # (gpu.jl:132-135); a single f32 field re-adds ~eps*|p|*6/h^2 of
    # representation noise at 255-class grids (docs/numerics.md).
    # None on f64 / compat / distributed paths. Appears after the
    # first step (init_state starts it at None).
    pr_lo: jax.Array | None = None


@pytree_dataclass
class StepStats:
    """Per-step observability record.

    err_hist[k] is the Poisson residual at the k-th convergence check
    (every nchk iterations, NavierStokes3D_gpu.jl:130-136); NaN for checks
    that never ran because the loop converged earlier.

    advect_clamped counts grid points whose semi-Lagrangian departure
    displacement exceeded the select-shift backend's bounded window
    (ops/advect.SELECTSHIFT_K) this step — nonzero means the fast advection
    path silently diverges from the reference's gather semantics (only
    possible when the run is already blowing up; this makes it observable).
    Always 0 for the 'gather' backend.
    """
    iters: jax.Array      # Poisson iterations executed (scalar int32)
    err: jax.Array        # final residual (scalar)
    err_hist: jax.Array   # (niter // nchk,)
    advect_clamped: jax.Array | None = None  # scalar int32 (None inside
    #                                           poisson-only solves)
    iters_ext: jax.Array | None = None  # iterations of the folded f32
    #   solve's defect-correction finisher (plain sweeps); the (hi, lo)
    #   pair sweeps are iters - iters_ext. None outside that path.
    pr_lo: jax.Array | None = None  # INTERNAL channel: the Poisson
    #   backends return the stored-pair low word here; _step_impl pops
    #   it into FlowState.pr_lo (never visible to step callers).


def zeros_state(grid: Grid, dtype) -> FlowState:
    z = lambda s: jnp.zeros(s, dtype=dtype)
    return FlowState(
        pr=z(grid.shape_c),
        vx=z(grid.shape_vx),
        vy=z(grid.shape_vy),
        vz=z(grid.shape_vz),
        c=z(grid.shape_c),
        dprdtau=z(grid.shape_c),
    )

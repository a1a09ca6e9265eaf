"""Physics kernels of the Chorin projection step, as pure jnp functions.

Each function replicates one @parallel kernel of the reference
(scripts/NavierStokes3D_gpu.jl:177-219 == NavierStokes3D_multi_gpu.jl:36-102;
the two scripts' kernels are identical). Where a ParallelStencil statement's
iteration range (the LHS array's shape) crops an operand, the crop appears
here as an explicit slice, with the Julia macro named in a comment.

These are the solver's step and its correctness oracle; XLA fuses them.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from . import stencil as st


def _pad1(a):
    """Zero-pad an interior-shaped array back to full shape. Interior
    updates are written as `full + _pad1(delta)` instead of
    `.at[1:-1,1:-1,1:-1].add(delta)`: bit-identical (boundary + 0.0 is
    exact), and an elementwise form the compiler fuses with its
    producer instead of a read-modify-write of the full array."""
    return jnp.pad(a, 1)


def update_tau(vx, vy, vz, mu, dx, dy, dz):
    """Deviatoric viscous stress on the staggered grid.

    Reference: update_τ! (NavierStokes3D_gpu.jl:177-185).
    Returns (txx, tyy, tzz) at centers (nx,ny,nz) and (txy, txz, tyz) at
    edges (nx-1,ny-1,nz-1).
    """
    dvxdx = st.d_xa(vx) / dx            # (nx,ny,nz)
    dvydy = st.d_ya(vy) / dy
    dvzdz = st.d_za(vz) / dz
    divv = dvxdx + dvydy + dvzdz        # @∇V
    txx = 2.0 * mu * (dvxdx - divv / 3.0)
    tyy = 2.0 * mu * (dvydy - divv / 3.0)
    tzz = 2.0 * mu * (dvzdz - divv / 3.0)
    # τxy = μ(@d_yi(Vx)/dy + @d_xi(Vy)/dx), out (nx-1,ny-1,nz-1).
    # Vx is (nx+1,ny,nz): inner-x slice is [1:-1]; y diff; z crops to [1:].
    txy = mu * ((vx[1:-1, 1:, 1:] - vx[1:-1, :-1, 1:]) / dy
                + (vy[1:, 1:-1, 1:] - vy[:-1, 1:-1, 1:]) / dx)
    # τxz = μ(@d_zi(Vx)/dz + @d_xi(Vz)/dx)
    txz = mu * ((vx[1:-1, 1:, 1:] - vx[1:-1, 1:, :-1]) / dz
                + (vz[1:, 1:, 1:-1] - vz[:-1, 1:, 1:-1]) / dx)
    # τyz = μ(@d_zi(Vy)/dz + @d_yi(Vz)/dy)
    tyz = mu * ((vy[1:, 1:-1, 1:] - vy[1:, 1:-1, :-1]) / dz
                + (vz[1:, 1:, 1:-1] - vz[1:, :-1, 1:-1]) / dy)
    return txx, tyy, tzz, txy, txz, tyz


def predict_v(vx, vy, vz, txx, tyy, tzz, txy, txz, tyz, rho, g, dt, dx, dy, dz):
    """Chorin step 1: V* = V + dt/ρ (∇·τ), with gravity on Vz.

    Reference: predict_V! (NavierStokes3D_gpu.jl:187-192). Interior-only
    (@inn) updates; boundary faces untouched.
    """
    # @inn(Vx) region: (nx-1, ny-2, nz-2)
    fx = (  (txx[1:, 1:-1, 1:-1] - txx[:-1, 1:-1, 1:-1]) / dx   # @d_xi(τxx)
          + (txy[:, 1:, :-1]     - txy[:, :-1, :-1]) / dy       # @d_ya(τxy)
          + (txz[:, :-1, 1:]     - txz[:, :-1, :-1]) / dz)      # @d_za(τxz)
    vx = vx + _pad1(dt / rho * fx)
    # @inn(Vy) region: (nx-2, ny-1, nz-2)
    fy = (  (tyy[1:-1, 1:, 1:-1] - tyy[1:-1, :-1, 1:-1]) / dy   # @d_yi(τyy)
          + (txy[1:, :, :-1]     - txy[:-1, :, :-1]) / dx       # @d_xa(τxy)
          + (tyz[:-1, :, 1:]     - tyz[:-1, :, :-1]) / dz)      # @d_za(τyz)
    vy = vy + _pad1(dt / rho * fy)
    # @inn(Vz) region: (nx-2, ny-2, nz-1); body force -ρg inside the bracket
    fz = (  (tzz[1:-1, 1:-1, 1:] - tzz[1:-1, 1:-1, :-1]) / dz   # @d_zi(τzz)
          + (txz[1:, :-1, :]     - txz[:-1, :-1, :]) / dx       # @d_xa(τxz)
          + (tyz[:-1, 1:, :]     - tyz[:-1, :-1, :]) / dy       # @d_ya(τyz)
          - rho * g)
    vz = vz + _pad1(dt / rho * fz)
    return vx, vy, vz


def update_divv(vx, vy, vz, dx, dy, dz):
    """Velocity divergence at cell centers, the Poisson RHS input.

    Reference: update_∇V! (NavierStokes3D_gpu.jl:194-197).
    """
    return st.divergence(vx, vy, vz, dx, dy, dz)


def poisson_iter(pr, dprdtau, divv, rho, dt, dtau, damp, dx, dy, dz):
    """One damped pseudo-transient iteration of the pressure Poisson solve.

    Reference: update_dPrdτ! + update_Pr! (NavierStokes3D_gpu.jl:199-207):
      dPrdτ <- dPrdτ (1-damp) + dτ (∇²Pr - ρ/dt ∇·V)   on the interior
      Pr    <- Pr + dτ dPrdτ
    dprdtau is stored full-shape with a zero boundary ring, so the pressure
    update is a full-array AXPY (equivalent to the reference's @inn update).
    """
    lap = st.laplacian_inner(pr, dx, dy, dz)
    resid = lap - (rho / dt) * st.inn(divv)
    # ring values are zero by invariant, so the full-array form
    # decay*ring + 0 == 0 reproduces the interior-set exactly
    dprdtau = dprdtau * (1.0 - damp) + dtau * _pad1(resid)
    pr = pr + dtau * dprdtau
    return pr, dprdtau


def poisson_residual(pr, divv, rho, dt, dx, dy, dz):
    """Poisson residual on the interior, (nx-2,ny-2,nz-2).

    Reference: compute_res! (NavierStokes3D_gpu.jl:209-212).
    """
    return st.laplacian_inner(pr, dx, dy, dz) - (rho / dt) * st.inn(divv)


def correct_v(vx, vy, vz, pr, dt, rho, dx, dy, dz):
    """Chorin step 2: project out the pressure gradient (interior only).

    Reference: correct_V! (NavierStokes3D_gpu.jl:214-219).
    """
    vx = vx + _pad1(
        -dt / rho * (pr[1:, 1:-1, 1:-1] - pr[:-1, 1:-1, 1:-1]) / dx)
    vy = vy + _pad1(
        -dt / rho * (pr[1:-1, 1:, 1:-1] - pr[1:-1, :-1, 1:-1]) / dy)
    vz = vz + _pad1(
        -dt / rho * (pr[1:-1, 1:-1, 1:] - pr[1:-1, 1:-1, :-1]) / dz)
    return vx, vy, vz

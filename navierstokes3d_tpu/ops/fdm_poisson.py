"""Fast-diagonalization direct Poisson solver (optional backend).

The pressure-Poisson operator of the reference is separable:
A = Ax (x) I (x) I + I (x) Ay (x) I + I (x) I (x) Az, where each 1D
operator is the second difference with the folded boundary conditions
(zero-gradient faces drop the boundary coupling; the outlet face is
Dirichlet; see models/chorin.py::_poisson_solve_jnp_folded). Each Ak is a
symmetric tridiagonal matrix, so A is diagonalized by the tensor product
of their eigenbases:

    p = Qx (x) Qy (x) Qz  [ (Qx' (x) Qy' (x) Qz' f) / (lx+ly+lz) ]

The transforms are dense (n_k x n_k) matmuls over ~6M-cell fields,
solving the system EXACTLY in ~6 matmul passes instead of the
reference's thousands of pseudo-transient iterations (gpu.jl:126-137);
benchmarks/fdm_speed_probe.py times one solve, and PERF.md records the
step on the GPU. Iterative refinement in the same basis absorbs float32
round-off (stats.iters counts its rounds).

This is a capability the reference does not have; the pseudo-transient
backend remains the parity default ('pt').
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _axis_operator(m: int, d: float, lo_zero_grad: bool,
                   hi_zero_grad: bool) -> np.ndarray:
    """1D interior operator (m = n-2 cells) with folded BCs: a
    zero-gradient end drops the boundary coupling (diag -1 instead of -2);
    a Dirichlet end keeps -2 (the frozen boundary value contributes to the
    RHS; for the homogeneous outlet it contributes 0)."""
    a = np.zeros((m, m))
    for i in range(m):
        diag = -2.0
        if i == 0 and lo_zero_grad:
            diag = -1.0
        if i == m - 1 and hi_zero_grad:
            diag = -1.0
        a[i, i] = diag
        if i > 0:
            a[i, i - 1] = 1.0
        if i < m - 1:
            a[i, i + 1] = 1.0
    return a / (d * d)


def _axis_eigs(grid, variant: str):
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    if variant == "multi":
        ax = _axis_operator(nx - 2, grid.dx, True, False)
    else:
        ax = _axis_operator(nx - 2, grid.dx, False, False)
    ay = _axis_operator(ny - 2, grid.dy, True, True)
    az = _axis_operator(nz - 2, grid.dz, True, True)
    return (np.linalg.eigh(ax), np.linalg.eigh(ay), np.linalg.eigh(az))


def solve_host_f64(grid, variant: str, rhs: np.ndarray) -> np.ndarray:
    """One-off exact host solve in float64 (for static boundary-driven
    parts that must not pollute float32 device solves). optimize=True
    routes the contractions through BLAS — at the 511-class grid the
    naive c_einsum path takes minutes, the dgemm path seconds."""
    (lx, qx), (ly, qy), (lz, qz) = _axis_eigs(grid, variant)
    t = np.einsum("ia,ajk->ijk", qx.T, rhs, optimize=True)
    t = np.einsum("jb,ibk->ijk", qy.T, t, optimize=True)
    t = np.einsum("kc,ijc->ijk", qz.T, t, optimize=True)
    t /= (lx[:, None, None] + ly[None, :, None] + lz[None, None, :])
    p = np.einsum("ai,ijk->ajk", qx, t, optimize=True)
    p = np.einsum("jb,ibk->ijk", qy, p, optimize=True)
    return np.einsum("kc,ijc->ijk", qz, p, optimize=True)


def build_fdm_solver(grid, variant: str, dtype):
    """Returns solve(rhs_interior) -> p_interior, both (nx-2,ny-2,nz-2).

    variant 'multi': x zero-grad at inlet, Dirichlet-0 at outlet
    (multi_gpu.jl:175-184); 'gpu': Dirichlet both x faces (the hydrostatic
    plane values enter through the RHS; see the solver integration).
    y/z are zero-gradient in both variants.
    """
    # host-side float64 eigendecompositions (symmetric tridiagonal).
    # The closed-over constants stay NumPy: build_fdm_solver may be
    # called lazily inside a jit trace (models/chorin._poisson_solve_fdm),
    # and a jnp.asarray created there would cache leaked tracers into the
    # closure, crashing every later trace that reuses the solver (same
    # pattern as chorin._folded_masks).
    (lx, qx), (ly, qy), (lz, qz) = _axis_eigs(grid, variant)
    # The pure-Neumann direction pair leaves no zero mode here because the
    # x axis always has at least one Dirichlet end in both variants.
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    # Keep only the 1-D eigenvalue vectors as trace constants and build
    # the 3-D eigenvalue sum ON DEVICE inside the solve: materializing
    # inv_lam = 1/lam as a host constant inlines a full-grid array into
    # the compiled program (189 MB at the 511 grid), which bloats every
    # compile of the step. The broadcast
    # add + divide is one fused elementwise pass, trivial next to the
    # transforms; in f64 the on-device (lx+ly)+lz matches the host
    # computation bit-for-bit (same IEEE ops, same order), in f32 it
    # differs from the old f64-computed-then-rounded constant by ~2 ulp
    # of lam, which the residual-driven refinement absorbs.
    lx_c = np.asarray(lx, np_dtype)
    ly_c = np.asarray(ly, np_dtype)
    lz_c = np.asarray(lz, np_dtype)
    qx_c, qy_c, qz_c = (np.asarray(q, np_dtype) for q in (qx, qy, qz))
    # materialized transposes shared across all to_modal call sites: the
    # tracer dedupes closure constants by object identity, so a fresh
    # `.T` view per call would emit one (n x n) literal per use (6-12
    # copies of the 1 MB x-matrix at the 511 grid) instead of one.
    qxT_c, qyT_c, qzT_c = (np.ascontiguousarray(q.T)
                           for q in (qx_c, qy_c, qz_c))
    acc_t = jnp.float32 if jnp.dtype(dtype) == jnp.float32 else jnp.dtype(dtype)

    # HIGHEST precision: on a Hopper GPU an f32 matmul at the default
    # precision may run in TF32 (10 mantissa bits), which loses orders
    # of magnitude in the direct solve's residual and caps the
    # per-refinement contraction of the compensated refinement loop.
    # HIGHEST keeps the six transforms in true float32 (outside the
    # tensor cores) and float64 in float64.
    prec = jax.lax.Precision.HIGHEST

    def to_modal(f):
        t = jnp.einsum("ia,ajk->ijk", qxT_c, f,
                       preferred_element_type=acc_t, precision=prec)
        t = jnp.einsum("jb,ibk->ijk", qyT_c, t,
                       preferred_element_type=acc_t, precision=prec)
        return jnp.einsum("kc,ijc->ijk", qzT_c, t,
                          preferred_element_type=acc_t, precision=prec)

    def from_modal(t):
        p = jnp.einsum("ai,ijk->ajk", qx_c, t,
                       preferred_element_type=acc_t, precision=prec)
        p = jnp.einsum("jb,ibk->ijk", qy_c, p,
                       preferred_element_type=acc_t, precision=prec)
        return jnp.einsum("kc,ijc->ijk", qz_c, p,
                          preferred_element_type=acc_t, precision=prec)

    def apply_a(p):
        """A p via the same folded stencil (for iterative refinement)."""
        pad = jnp.pad(p, 1)
        cx = 1.0 / (grid.dx * grid.dx)
        cy = 1.0 / (grid.dy * grid.dy)
        cz = 1.0 / (grid.dz * grid.dz)
        pc = p
        m = p.shape
        xl = (pad[:-2, 1:-1, 1:-1] - pc)
        xr = (pad[2:, 1:-1, 1:-1] - pc)
        yl = (pad[1:-1, :-2, 1:-1] - pc)
        yr = (pad[1:-1, 2:, 1:-1] - pc)
        zl = (pad[1:-1, 1:-1, :-2] - pc)
        zr = (pad[1:-1, 1:-1, 2:] - pc)
        # drop the boundary-coupling term where zero-gradient (the pad
        # zeros already model homogeneous Dirichlet ends)
        i = jnp.arange(m[0])[:, None, None]
        j = jnp.arange(m[1])[None, :, None]
        k = jnp.arange(m[2])[None, None, :]
        if variant == "multi":
            xl = jnp.where(i == 0, 0.0, xl)           # inlet zero-grad
            # outlet Dirichlet-0: xr keeps (pad 0 == boundary value 0)
        else:
            pass  # gpu: Dirichlet both (homogeneous part; planes via RHS)
        yl = jnp.where(j == 0, 0.0, yl)
        yr = jnp.where(j == m[1] - 1, 0.0, yr)
        zl = jnp.where(k == 0, 0.0, zl)
        zr = jnp.where(k == m[2] - 1, 0.0, zr)
        return cx * (xl + xr) + cy * (yl + yr) + cz * (zl + zr)

    def modal_scale(t, eigs):
        lx_v, ly_v, lz_v = eigs
        lam = (lx_v[:, None, None] + ly_v[None, :, None]
               + lz_v[None, None, :])
        return t / lam

    @jax.jit
    def solve(rhs, eigs=None, refine: int = 1):
        """eigs: optional (lx, ly, lz) 1-D eigenvalue vectors as RUNTIME
        values (tracers/device arrays). Pass them when calling inside an
        outer jit trace: with the closure's concrete NumPy vectors the
        lam broadcast-add executes EAGERLY at trace time, materializing
        a fresh full-grid literal per call site (4 x 189 MB at the 511
        grid). With traced operands the add is staged and lam is
        built on device: one fused elementwise pass, trivial next to the
        transforms. Numerically identical ops in the same order; in f32
        the on-device sum differs from the old f64-computed-then-rounded
        constant by ~2 ulp of lam, which the residual-driven refinement
        absorbs."""
        if eigs is None:
            eigs = (lx_c, ly_c, lz_c)
        p = from_modal(modal_scale(to_modal(rhs), eigs))
        for _ in range(refine):
            r = rhs - apply_a(p)
            p = p + from_modal(modal_scale(to_modal(r), eigs))
        return p

    solve.apply_a = apply_a
    # 1-D eigenvalue vectors for callers that thread them through a jit
    # boundary as runtime arguments (models/chorin.ChorinSolver.__init__)
    solve.eig_consts = (lx_c, ly_c, lz_c)
    return solve

"""Explicit halo exchange + distributed Poisson loop under shard_map.

This is the hand-scheduled counterpart of the reference's communication
layer: ImplicitGlobalGrid's `update_halo!` becomes per-axis
`lax.ppermute` face shifts over the device mesh (NCCL on GPUs), and `MPI.Allreduce(MAX)`
(max_g, NavierStokes3D_multi_gpu.jl:21) becomes an in-jit `lax.pmax` —
zero host round-trips for the entire pseudo-transient solve
(the reference syncs to host at every residual check, gpu.jl:132).

Data layout: each device owns an un-haloed block of the global grid
(identical to the global-view sharding in parallel/mesh.py, so states
move freely between the two paths). Halos are fetched transiently per
iteration; at physical boundaries ppermute's missing links yield zeros,
which only ever feed masked ring cells.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ptloop import pt_loop_fused

AXES = ("x", "y", "z")


def _shift(x, axis_name: str, direction: int):
    """Neighbor shift along a mesh axis: returns this device's face data
    received from its -direction neighbor (zeros at the open boundary)."""
    n = lax.axis_size(axis_name)
    if n == 1:
        return jnp.zeros_like(x)
    if direction > 0:
        perm = [(i, i + 1) for i in range(n - 1)]
    else:
        perm = [(i + 1, i) for i in range(n - 1)]
    return lax.ppermute(x, axis_name, perm)


def halo_pad(block, axis_names=AXES, width: int = 1):
    """Pad a local block by `width` cells per side per sharded axis with
    neighbor face slabs (zeros at open global boundaries).

    The reference exchanges whole halos after every kernel
    (update_halo!, multi_gpu.jl:450-477); here the exchange is fused into
    the consuming stencil's padding. 6 ppermutes of `width`-deep faces —
    width>1 enables batching several Poisson iterations per exchange
    (the generalization of the reference's declared-but-unused b_width,
    multi_gpu.jl:326).
    """
    out = block
    for dim, ax in enumerate(axis_names):
        n = out.shape[dim]
        lo_face = lax.slice_in_dim(out, 0, width, axis=dim)
        hi_face = lax.slice_in_dim(out, n - width, n, axis=dim)
        from_left = _shift(hi_face, ax, +1)   # left neighbor's last planes
        from_right = _shift(lo_face, ax, -1)  # right neighbor's first planes
        out = jnp.concatenate([from_left, out, from_right], axis=dim)
    return out


def halo_pad_asym(block, widths, axis_names=AXES):
    """halo_pad with per-axis (lo, hi) widths — the owned-face staggered
    layout (parallel/fullstep.py) pads the staggered axis one deeper on
    the hi side so the padded array carries the (n+1)-th face family.
    widths: sequence of (lo, hi) per axis; an axis may also be skipped
    with (0, 0). Axes are exchanged sequentially, so corner pads carry
    diagonal-neighbor data exactly as in halo_pad."""
    out = block
    for dim, ax in enumerate(axis_names):
        lo_w, hi_w = widths[dim]
        n = out.shape[dim]
        parts = []
        if lo_w:
            hi_face = lax.slice_in_dim(out, n - lo_w, n, axis=dim)
            parts.append(_shift(hi_face, ax, +1))   # left nbr's last planes
        parts.append(out)
        if hi_w:
            lo_face = lax.slice_in_dim(out, 0, hi_w, axis=dim)
            parts.append(_shift(lo_face, ax, -1))   # right nbr's first planes
        if len(parts) > 1:
            out = jnp.concatenate(parts, axis=dim)
    return out


def _device_pos(axis_names=AXES):
    idx = [lax.axis_index(a) for a in axis_names]
    num = [lax.axis_size(a) for a in axis_names]
    return idx, num


def _bc_pr_local(pr, variant: str, xlo_plane, xhi_plane,
                 z_lo_add=0.0, z_hi_add=0.0):
    """The reference's set_bc_Pr! on a local block, guarded by global
    position exactly as the multi script guards by rank
    (multi_gpu.jl:175-184). Requires local block >= 2 cells per sharded
    axis (copy source planes are then always owned). z_*_add are the
    affine offsets of the split-pressure bc_z! (bc.affine_grad_z)."""
    (ix, iy, iz), (npx, npy, npz) = _device_pos()
    if variant == "multi":
        pr = jnp.where(ix == 0, pr.at[0].set(pr[1]), pr)
        pr = jnp.where(ix == npx - 1, pr.at[-1].set(pr[-2]), pr)
        pr = jnp.where(iy == 0, pr.at[:, 0].set(pr[:, 1]), pr)
        pr = jnp.where(iy == npy - 1, pr.at[:, -1].set(pr[:, -2]), pr)
        pr = jnp.where(iz == 0, pr.at[:, :, 0].set(pr[:, :, 1]), pr)
        pr = jnp.where(iz == npz - 1, pr.at[:, :, -1].set(pr[:, :, -2]), pr)
        pr = jnp.where(ix == npx - 1, pr.at[-1].set(0.0), pr)
    else:  # gpu variant: bc_y, bc_z, hydrostatic x planes (gpu.jl:281-286)
        pr = jnp.where(iy == 0, pr.at[:, 0].set(pr[:, 1]), pr)
        pr = jnp.where(iy == npy - 1, pr.at[:, -1].set(pr[:, -2]), pr)
        pr = jnp.where(iz == 0,
                       pr.at[:, :, 0].set(pr[:, :, 1] + z_lo_add), pr)
        pr = jnp.where(iz == npz - 1,
                       pr.at[:, :, -1].set(pr[:, :, -2] + z_hi_add), pr)
        pr = jnp.where(ix == 0, pr.at[0].set(xlo_plane), pr)
        pr = jnp.where(ix == npx - 1, pr.at[-1].set(xhi_plane), pr)
    return pr


def _bc_pr_local_padded(pr, variant: str, xlo_plane, xhi_plane, m: int,
                        z_lo_add=0.0, z_hi_add=0.0):
    """_bc_pr_local generalized to m-deep halo-padded blocks: global
    boundary planes sit at padded index m / -(1+m) on edge devices (a
    halo never contains a foreign BC plane for m <= block-1)."""
    (ix, iy, iz), (npx, npy, npz) = _device_pos()
    lo, hi = m, -1 - m
    if variant == "multi":
        pr = jnp.where(ix == 0, pr.at[lo].set(pr[lo + 1]), pr)
        pr = jnp.where(ix == npx - 1, pr.at[hi].set(pr[hi - 1]), pr)
        pr = jnp.where(iy == 0, pr.at[:, lo].set(pr[:, lo + 1]), pr)
        pr = jnp.where(iy == npy - 1, pr.at[:, hi].set(pr[:, hi - 1]), pr)
        pr = jnp.where(iz == 0, pr.at[:, :, lo].set(pr[:, :, lo + 1]), pr)
        pr = jnp.where(iz == npz - 1, pr.at[:, :, hi].set(pr[:, :, hi - 1]), pr)
        pr = jnp.where(ix == npx - 1, pr.at[hi].set(0.0), pr)
    else:
        pr = jnp.where(iy == 0, pr.at[:, lo].set(pr[:, lo + 1]), pr)
        pr = jnp.where(iy == npy - 1, pr.at[:, hi].set(pr[:, hi - 1]), pr)
        pr = jnp.where(iz == 0,
                       pr.at[:, :, lo].set(pr[:, :, lo + 1] + z_lo_add), pr)
        pr = jnp.where(iz == npz - 1,
                       pr.at[:, :, hi].set(pr[:, :, hi - 1] + z_hi_add), pr)
        pr = jnp.where(ix == 0, pr.at[lo].set(xlo_plane), pr)
        pr = jnp.where(ix == npx - 1, pr.at[hi].set(xhi_plane), pr)
    return pr


def build_poisson_shard_map(mesh: Mesh, grid, phys, eps_it: float,
                            variant: str, dtype, halo_width: int = 1,
                            pressure_split: bool = False,
                            stall=None, wrap: bool = True):
    """Distributed pseudo-transient Poisson solve: the ENTIRE chunked
    while_loop runs inside one shard_map — per iteration: 6 face
    ppermutes (Pr halo) + local fused stencil + position-guarded BCs;
    per residual check: one more halo + lax.pmax over the mesh.

    halo_width k > 1 batches k iterations per exchange: Pr, dPrdτ and the
    RHS are exchanged with k-deep halos and k iterations run locally, the
    halo validity shrinking one cell per iteration (overlapping
    temporal blocking — the generalization of the reference's unused
    b_width comm/compute-overlap, multi_gpu.jl:326). Owned cells follow
    the same arithmetic as k=1 (identical up to compiler FMA scheduling);
    the cost is (k-1) redundant halo-cell updates per side, the win is
    1/k as many messages.

    pressure_split: the fields are p' = Pr - P_static(z) (gpu variant;
    NumericsConfig.pressure_split) — x Dirichlet planes become constants
    and bc_z! gains affine offsets. stall: (ratio, checks) plateau exit
    (ptloop.pt_loop_fused) or None.

    Returns solve(pr, dprdtau, rhs3d) -> (pr, dprdtau, iters, err, hist)
    operating on globally-sharded arrays.

    wrap=False returns the LOCAL solve function instead (operating on
    per-device blocks, using lax.axis_index/ppermute over the mesh axes) —
    for composition inside an outer shard_map (parallel/fullstep.py runs
    the whole time step under one shard_map and calls this solver for the
    Poisson stage).
    """
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    dx, dy, dz = grid.dx, grid.dy, grid.dz
    dtau, damp = grid.dtau, grid.damp
    nchk, niter = grid.nchk, grid.niter
    nchunks = niter // nchk
    rem = niter - nchunks * nchk
    err_scale = (grid.ly * grid.ly) / phys.psc
    npx, npy, npz = (mesh.shape[a] for a in AXES)
    if nx % npx or ny % npy or nz % npz:
        raise ValueError("grid dims must divide mesh dims")
    bx, by, bz = nx // npx, ny // npy, nz // npz
    if min(bx, by, bz) < 2:
        raise ValueError("local blocks must be >= 2 cells per axis")
    k = int(halo_width)
    if k < 1 or (k > 1 and k > min(bx, by, bz) - 1):
        raise ValueError(
            f"halo_width {k} must be in [1, min(block)-1={min(bx,by,bz)-1}] "
            "(a wider halo would contain foreign BC planes)")

    # gpu-variant hydrostatic x planes, as local (by,bz) tiles per device:
    # value depends only on global z (gpu.jl:257-261). Under the split the
    # planes are constants (0 here, +100 added at use) and bc_z! carries
    # affine offsets instead.
    z_lo_add = z_hi_add = 0.0
    if variant == "gpu" and pressure_split:
        prof_full = np.zeros((ny, nz), dtype)
        rho_g_dz = phys.rho * phys.g * dz
        z_lo_add, z_hi_add = -rho_g_dz, +rho_g_dz
    elif variant == "gpu":
        izg = np.arange(1, nz + 1, dtype=np.float64)
        prof = phys.rho * phys.g * (nz - izg + 0.5) * dz
        prof_full = np.broadcast_to(prof[None, :], (ny, nz)).astype(dtype)
    else:
        prof_full = np.zeros((ny, nz), dtype)

    def local_interior_mask(sh, off=0):
        """True on global-interior cells of the local block; `off` is the
        halo padding depth when sh is a padded block shape."""
        (ix, iy, iz), (Px, Py, Pz) = _device_pos()
        gx = ix * bx - off + lax.broadcasted_iota(jnp.int32, sh, 0)
        gy = iy * by - off + lax.broadcasted_iota(jnp.int32, sh, 1)
        gz = iz * bz - off + lax.broadcasted_iota(jnp.int32, sh, 2)
        m = ((gx >= 1) & (gx <= nx - 2) & (gy >= 1) & (gy <= ny - 2)
             & (gz >= 1) & (gz <= nz - 2))
        return m

    def lap_of(pad):
        c = pad[1:-1, 1:-1, 1:-1]
        return ((pad[2:, 1:-1, 1:-1] - 2 * c + pad[:-2, 1:-1, 1:-1]) / dx / dx
                + (pad[1:-1, 2:, 1:-1] - 2 * c + pad[1:-1, :-2, 1:-1]) / dy / dy
                + (pad[1:-1, 1:-1, 2:] - 2 * c + pad[1:-1, 1:-1, :-2]) / dz / dz)

    def run_batch(pr, dpr, rhs, m, prof_pad):
        """m iterations on m-deep halo-padded blocks: one exchange of
        Pr/dPrdτ/rhs, then m local width-1 sweeps whose halo validity
        shrinks inward one cell per sweep (owned cells stay exact).
        Also returns the owned-cell masked max|resid| of the LAST sweep
        (the pt_loop_fused check quantity; at owned cells it equals the
        width-1 schedule's value up to FMA scheduling)."""
        (_, iyd, izd), _ = _device_pos()
        # padded-extent hydrostatic tiles (values at domain-edge pads are
        # never consumed)
        xplane = lax.dynamic_slice(
            prof_pad, (iyd * by + (k - m), izd * bz + (k - m)),
            (by + 2 * m, bz + 2 * m))
        xlo_p = xplane + jnp.asarray(100.0, pr.dtype)
        xhi_p = xplane
        prp = halo_pad(pr, width=m)
        dpp = halo_pad(dpr, width=m)
        rhp = halo_pad(rhs, width=m)
        maskp = local_interior_mask(prp.shape, off=m)[1:-1, 1:-1, 1:-1]
        ish = tuple(d - 2 for d in prp.shape)
        own = jnp.ones(ish, bool)
        for ax, b_ax in enumerate((bx, by, bz)):
            ii = lax.broadcasted_iota(jnp.int32, ish, ax)
            own = own & (ii >= m - 1) & (ii < m - 1 + b_ax)
        e = jnp.zeros((), pr.dtype)
        for _ in range(m):
            resid = lap_of(prp) - rhp[1:-1, 1:-1, 1:-1]
            e = jnp.max(jnp.where(maskp & own, jnp.abs(resid), 0.0))
            inner = jnp.where(
                maskp,
                dpp[1:-1, 1:-1, 1:-1] * (1.0 - damp) + dtau * resid,
                jnp.zeros_like(resid))
            dpp = dpp.at[1:-1, 1:-1, 1:-1].set(inner)
            prp = prp + dtau * dpp
            prp = _bc_pr_local_padded(prp, variant, xlo_p, xhi_p, m,
                                      z_lo_add, z_hi_add)
        sl = slice(m, -m)
        return prp[sl, sl, sl], dpp[sl, sl, sl], e

    # kmax-padded global hydrostatic profile (edge-replicated; edge pads
    # are never consumed)
    prof_padded = np.pad(prof_full, k, mode="edge") if k > 1 else prof_full

    def solve_local(pr, dpr, rhs):
        mask = local_interior_mask(pr.shape)
        (ixd, iyd, izd), _ = _device_pos()
        # local tile of the hydrostatic profile for this device
        profj = jnp.asarray(prof_full)
        prof_pad = jnp.asarray(prof_padded)
        ys = iyd * by
        zs = izd * bz
        xplane = lax.dynamic_slice(profj, (ys, zs), (by, bz))
        xlo = xplane + jnp.asarray(100.0, dtype)
        xhi = xplane
        pall = lambda e: lax.pmax(lax.pmax(lax.pmax(e, "x"), "y"), "z")

        # flat iteration-level loop on the in-body residual
        # (ptloop.pt_loop_fused); the all-reduced err keeps the while
        # condition replicated across the mesh.
        if k == 1:
            def step_fn(c, it):
                pr, dpr = c
                pad = halo_pad(pr)
                resid = lap_of(pad) - rhs
                e = jnp.max(jnp.where(mask, jnp.abs(resid), 0.0))
                dpr = jnp.where(mask, dpr * (1.0 - damp) + dtau * resid,
                                jnp.zeros_like(dpr))
                pr = pr + dtau * dpr
                pr = _bc_pr_local(pr, variant, xlo, xhi, z_lo_add,
                                  z_hi_add)
                return (pr, dpr), pall(e) * err_scale, jnp.int32(1)
        else:
            # batches of up to k sweeps per exchange, clipped so no batch
            # crosses a chunk boundary or the iteration budget (checks
            # stay aligned with the width-1 schedule)
            branches = [
                (lambda c, _j=j: run_batch(c[0], c[1], rhs, _j, prof_pad))
                for j in range(1, k + 1)]

            def step_fn(c, it):
                pos = it % nchk
                m = jnp.minimum(jnp.minimum(jnp.int32(k), nchk - pos),
                                niter - it)
                m = jnp.maximum(m, 1)
                pr, dpr, e = lax.switch(m - 1, branches, c)
                return (pr, dpr), pall(e) * err_scale, m

        (pr, dpr), iters, err, hist = pt_loop_fused(
            step_fn, (pr, dpr), 0, niter, nchk, nchunks, eps_it, dtype,
            stall=stall)
        return pr, dpr, iters, err, hist

    if not wrap:
        return solve_local
    spec = P(*AXES)
    rep = P()
    solve = shard_map(
        solve_local, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, rep, rep, rep),
        check_vma=False)
    return solve

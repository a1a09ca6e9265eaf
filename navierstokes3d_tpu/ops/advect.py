"""Semi-Lagrangian advection: method of characteristics + trilinear interp.

Reference: advect!/backtrack!/lerp (NavierStokes3D_gpu.jl:288-334;
NavierStokes3D_multi_gpu.jl:190-243). Each staggered component averages the
other two velocity components onto its own face, backtracks the departure
point one dt, and trilinearly interpolates the *_o snapshot there. Departure
indices clamp to the array bounds (gpu.jl:290-293), which on a sharded grid
clamps into the halo exactly as the reference's per-rank clamp does.

compat=True replicates the reference bug where the third branch advects Vy a
second time with Vz-face-averaged velocities and Vz-derived bounds, so Vz is
never advected (gpu.jl:321-326) — the golden regression values encode this.
compat=False advects Vz properly.

Two backends: 'gather' (8 XLA gathers per field — the literal semantics)
and 'selectshift' (bounded-window select-weighted stencil of static
shifted slices; see _backtrack_selectshift). The solver defaults to
the gather, measured faster on the GPU (PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _lerp(a, b, t):
    """lerp(a,b,t) = b t + a (1-t) (NavierStokes3D_gpu.jl:306)."""
    return b * t + a * (1.0 - t)


def _backtrack(a_o, vxc, vyc, vzc, ix, iy, iz, dt, dx, dy, dz,
               origin=(0, 0, 0), gshape=None):
    """Vectorized backtrack! (NavierStokes3D_gpu.jl:288-304).

    a_o: source snapshot (the local array; on a sharded grid a halo-padded
    block of the global field).
    vxc/vyc/vzc: face-centered velocities over the write region.
    ix/iy/iz: 1-based LOCAL indices of the write region (broadcastable).
    origin/gshape: 0-based global index of a_o's element [0,0,0] and the
    GLOBAL field shape — departure indices clamp at the global bounds
    exactly like the reference's per-rank clamp into halos. The defaults
    reproduce the single-device semantics (local == global).
    Returns interpolated values over the write region.
    """
    n1, n2, n3 = gshape if gshape is not None else a_o.shape
    o1_, o2_, o3_ = origin
    dtype = a_o.dtype
    dlx = dt * vxc / dx
    dly = dt * vyc / dy
    dlz = dt * vzc / dz
    ix1 = jnp.clip(jnp.floor((ix + o1_) - dlx), 1, n1).astype(jnp.int32)
    iy1 = jnp.clip(jnp.floor((iy + o2_) - dly), 1, n2).astype(jnp.int32)
    iz1 = jnp.clip(jnp.floor((iz + o3_) - dlz), 1, n3).astype(jnp.int32)
    ix2 = jnp.minimum(ix1 + 1, n1) - o1_
    iy2 = jnp.minimum(iy1 + 1, n2) - o2_
    iz2 = jnp.minimum(iz1 + 1, n3) - o3_
    ix1 = ix1 - o1_
    iy1 = iy1 - o2_
    iz1 = iz1 - o3_
    # Julia: δ = (δ>0) - (δ%1); % is truncated remainder == fmod.
    tx = (dlx > 0).astype(dtype) - jnp.fmod(dlx, 1.0)
    ty = (dly > 0).astype(dtype) - jnp.fmod(dly, 1.0)
    tz = (dlz > 0).astype(dtype) - jnp.fmod(dlz, 1.0)

    ix1, iy1, iz1, ix2, iy2, iz2 = jnp.broadcast_arrays(ix1, iy1, iz1, ix2, iy2, iz2)

    def at(i, j, k):  # 1-based -> 0-based gather
        return a_o[i - 1, j - 1, k - 1]

    fy1z1 = _lerp(at(ix1, iy1, iz1), at(ix2, iy1, iz1), tx)
    fy1z2 = _lerp(at(ix1, iy1, iz2), at(ix2, iy1, iz2), tx)
    fy2z1 = _lerp(at(ix1, iy2, iz1), at(ix2, iy2, iz1), tx)
    fy2z2 = _lerp(at(ix1, iy2, iz2), at(ix2, iy2, iz2), tx)
    fz1 = _lerp(fy1z1, fy2z1, ty)
    fz2 = _lerp(fy1z2, fy2z2, ty)
    return _lerp(fz1, fz2, tz)


def _ranges(dtype, *specs):
    """1-based index axes, shaped for broadcasting: specs are (start, stop)."""
    out = []
    for axis, (start, stop) in enumerate(specs):
        shape = [1, 1, 1]
        r = jnp.arange(start, stop + 1, dtype=dtype)
        shape[axis] = r.shape[0]
        out.append(r.reshape(shape))
    return out


# Max departure displacement (cells) handled by the select-shift backend;
# |dt v / h| beyond this is clamped (the reference would sample farther,
# but only reaches |δ|>3 when the run is already diverging).
SELECTSHIFT_K = 3


def _backtrack_selectshift(a_o, vxc, vyc, vzc, starts, dt, dx, dy, dz,
                           k=SELECTSHIFT_K, origin=(0, 0, 0), gshape=None,
                           count_box=None):
    """Gather-free backtrack!: the trilinear corners lie within a bounded
    (2k+2)^3 neighborhood, so the interpolation becomes a select-weighted
    stencil of static shifted slices (no gather). Matches _backtrack to
    rounding whenever
    |dt v / h| <= k. `starts` are the 1-based LOCAL region starts per axis.

    origin/gshape: as in _backtrack — departure indices clamp at GLOBAL
    bounds; offsets into the local array stay local. Requires the local
    array to carry >= k+1 cells of valid halo around any output consumed
    (pads beyond the global domain get exactly zero weight, because the
    clamp keeps samples inside the global bounds).

    Returns (values, n_clamped): n_clamped counts region points whose
    displacement exceeded k on any axis (where the result diverges from
    the reference's gather semantics). count_box: optional per-axis
    (lo, hi) half-open 0-based LOCAL index bounds restricting the count
    (a sharded caller passes its owned block so halo points — computed
    redundantly on several devices — are not multi-counted)."""
    n1, n2, n3 = gshape if gshape is not None else a_o.shape
    og = origin
    dtype = a_o.dtype
    sx, sy, sz = starts
    rs = jnp.broadcast_shapes(vxc.shape, vyc.shape, vzc.shape)

    def axis_terms(v, d, axis, start, extent, n, o0):
        idx = jnp.arange(start, start + extent, dtype=dtype)
        shape = [1, 1, 1]
        shape[axis] = extent
        idx = idx.reshape(shape) + o0                # global 1-based
        dl_raw = dt * v / d
        dl = jnp.clip(dl_raw, -k, k)
        i1 = jnp.clip(jnp.floor(idx - dl), 1, n)
        t = (dl > 0).astype(dtype) - jnp.fmod(dl, 1.0)
        o1 = (i1 - idx).astype(jnp.int32)            # in [-k-1, k]
        o2 = (jnp.minimum(i1 + 1, n) - idx).astype(jnp.int32)
        return o1, o2, t, jnp.abs(dl_raw) > k

    ox1, ox2, tx, cx = axis_terms(vxc, dx, 0, sx, rs[0], n1, og[0])
    oy1, oy2, ty, cy = axis_terms(vyc, dy, 1, sy, rs[1], n2, og[1])
    oz1, oz2, tz, cz = axis_terms(vzc, dz, 2, sz, rs[2], n3, og[2])
    clamped = cx | cy | cz
    if count_box is not None:
        for axis, (lo, hi) in enumerate(count_box):
            local0 = jnp.arange(rs[axis]) + (starts[axis] - 1)
            shape = [1, 1, 1]
            shape[axis] = rs[axis]
            clamped = clamped & ((local0 >= lo)
                                 & (local0 < hi)).reshape(shape)
    n_clamped = jnp.sum(clamped.astype(jnp.int32))
    P = k + 1
    ap = jnp.pad(a_o, P)
    one = jnp.ones((), dtype)
    zero = jnp.zeros((), dtype)
    acc = jnp.zeros(rs, dtype)
    # slice origin of region cell 0 in the padded array along each axis
    bx, by, bz = P + sx - 1, P + sy - 1, P + sz - 1
    # Term order is (p, q, o) — y, then z, then x innermost — with the
    # term evaluated as (wx * (wy*wz)) * sample.
    wxs = [(jnp.where(ox1 == o, one - tx, zero)
            + jnp.where(ox2 == o, tx, zero))
           for o in range(-P, k + 1)]
    for p in range(-P, k + 1):
        wy = (jnp.where(oy1 == p, one - ty, zero)
              + jnp.where(oy2 == p, ty, zero))
        for q in range(-P, k + 1):
            wz = (jnp.where(oz1 == q, one - tz, zero)
                  + jnp.where(oz2 == q, tz, zero))
            wyz = wy * wz
            for io, o in enumerate(range(-P, k + 1)):
                sl = ap[bx + o:bx + o + rs[0],
                        by + p:by + p + rs[1],
                        bz + q:bz + q + rs[2]]
                acc = acc + (wxs[io] * wyz) * sl
        # split the (2k+2)^3-term accumulation into one fused kernel per
        # y-offset: one fusion over all (2k+2)^3 terms grows without
        # bound in k
        acc = jax.lax.optimization_barrier(acc)
    return acc, n_clamped


def advect(vx, vy, vz, c, dt, dx, dy, dz, *, compat: bool,
           method: str = "gather", with_stats: bool = False,
           origin=(0, 0, 0), gshape=None, set_fn=None,
           k: int = SELECTSHIFT_K, count_box=None):
    """Advect all staggered velocity components and the tracer C.

    Inputs are the post-BC fields of this step; they serve as both the *_o
    snapshots (reference copies at gpu.jl:141) and the write targets.
    method: 'gather' (exact reference semantics, XLA gather) or
    'selectshift' (bounded-window stencil, displacement clamped to k
    cells).
    with_stats=True additionally returns the number of points whose
    displacement hit the select-shift clamp (always 0 for 'gather').
    k: select-shift displacement window in cells ((2k+2)^3 accumulation
    terms — the dominant VPU cost of the step's non-Poisson ops). The
    solver defaults to k=2: the reference's fixed dt already assumes
    |V| <= vin with CFL_adv = 1 (~1 cell/step), so 2 cells is a 2x
    margin, and the clamp counter flags any excursion beyond it.

    Sharded composition (parallel/fullstep.py): the inputs may be
    halo-padded LOCAL blocks of the global fields. origin = per-axis
    0-based global CELL index of local element [0,0,0]; gshape = global
    cell-centered shape (nx,ny,nz) — departure-point clamping then uses
    global bounds (faces share the cell origin; each branch derives its
    field's global staggered shape). set_fn(target, region, vals,
    gbounds) overrides the write `target.at[region].set(vals)` — gbounds
    is the branch's per-axis GLOBAL 1-based inclusive write range on the
    target's staggered index space (None = the axis's full range),
    letting a sharded caller mask writes to the branch's global region.
    count_box: see _backtrack_selectshift — restricts the clamp count to
    the caller's owned local cells.
    """
    nx1, ny, nz = vx.shape          # (nx+1, ny, nz)
    nx = nx1 - 1
    dtype = vx.dtype
    vx_o, vy_o, vz_o, c_o = vx, vy, vz, c
    n_clamped = jnp.zeros((), jnp.int32)
    if gshape is None:
        gnx, gny, gnz = nx, ny, nz
    else:
        gnx, gny, gnz = gshape
    if set_fn is None:
        def set_fn(target, region, vals, gbounds):
            return target.at[region].set(vals)

    if method == "selectshift":
        def bt(a_o, vxc, vyc, vzc, starts, gsh):
            nonlocal n_clamped
            vals, nc = _backtrack_selectshift(a_o, vxc, vyc, vzc, starts,
                                              dt, dx, dy, dz, k=k,
                                              origin=origin, gshape=gsh,
                                              count_box=count_box)
            n_clamped = n_clamped + nc
            return vals
    else:
        def bt(a_o, vxc, vyc, vzc, starts, gsh):
            stops = tuple(st + n - 1 for st, n in zip(
                starts, jnp.broadcast_shapes(vxc.shape, vyc.shape,
                                             vzc.shape)))
            ix, iy, iz = _ranges(dtype, *zip(starts, stops))
            return _backtrack(a_o, vxc, vyc, vzc, ix, iy, iz,
                              dt, dx, dy, dz, origin=origin, gshape=gsh)

    # -- branch 1: Vx over ix in 2..nx (gpu.jl:308-314) --
    vxc = vx_o[1:-1, :, :]
    vyc = 0.25 * (vy_o[:-1, :-1, :] + vy_o[:-1, 1:, :]
                  + vy_o[1:, :-1, :] + vy_o[1:, 1:, :])
    vzc = 0.25 * (vz_o[:-1, :, :-1] + vz_o[:-1, :, 1:]
                  + vz_o[1:, :, :-1] + vz_o[1:, :, 1:])
    vx_new = set_fn(vx, (slice(1, -1), slice(None), slice(None)),
                    bt(vx_o, vxc, vyc, vzc, (2, 1, 1),
                       (gnx + 1, gny, gnz)),
                    ((2, gnx), None, None))

    # -- branch 2: Vy over iy in 2..ny (gpu.jl:315-320) --
    vxc = 0.25 * (vx_o[:-1, :-1, :] + vx_o[1:, :-1, :]
                  + vx_o[:-1, 1:, :] + vx_o[1:, 1:, :])
    vyc = vy_o[:, 1:-1, :]
    vzc = 0.25 * (vz_o[:, :-1, :-1] + vz_o[:, :-1, 1:]
                  + vz_o[:, 1:, :-1] + vz_o[:, 1:, 1:])
    vy_new = set_fn(vy, (slice(None), slice(1, -1), slice(None)),
                    bt(vy_o, vxc, vyc, vzc, (1, 2, 1),
                       (gnx, gny + 1, gnz)),
                    (None, (2, gny), None))

    # -- branch 3: iz in 2..nz with Vz-face velocities (gpu.jl:321-326) --
    vxc = 0.25 * (vx_o[:-1, :, :-1] + vx_o[1:, :, :-1]
                  + vx_o[:-1, :, 1:] + vx_o[1:, :, 1:])
    vyc = 0.25 * (vy_o[:, :-1, :-1] + vy_o[:, 1:, :-1]
                  + vy_o[:, :-1, 1:] + vy_o[:, 1:, 1:])
    vzc = vz_o[:, :, 1:-1]
    if compat:
        # Reference bug: writes Vy (with Vy_o source and Vy clamp bounds)
        # instead of Vz (gpu.jl:325). Overwrites branch-2 results wherever
        # both regions overlap, exactly as the sequential Julia kernel does.
        vals = bt(vy_o, vxc, vyc, vzc, (1, 1, 2), (gnx, gny + 1, gnz))
        vy_new = set_fn(vy_new,
                        (slice(None), slice(None, -1), slice(1, None)),
                        vals, (None, (1, gny), (2, gnz)))
        vz_new = vz
    else:
        vals = bt(vz_o, vxc, vyc, vzc, (1, 1, 2), (gnx, gny, gnz + 1))
        vz_new = set_fn(vz, (slice(None), slice(None), slice(1, -1)),
                        vals, (None, None, (2, gnz)))

    # -- branch 4: tracer C over all cells (gpu.jl:327-332) --
    vxc = 0.5 * (vx_o[:-1, :, :] + vx_o[1:, :, :])
    vyc = 0.5 * (vy_o[:, :-1, :] + vy_o[:, 1:, :])
    vzc = 0.5 * (vz_o[:, :, :-1] + vz_o[:, :, 1:])
    c_new = set_fn(c, (slice(None), slice(None), slice(None)),
                   bt(c_o, vxc, vyc, vzc, (1, 1, 1), (gnx, gny, gnz)),
                   (None, None, None))

    if with_stats:
        return vx_new, vy_new, vz_new, c_new, n_clamped
    return vx_new, vy_new, vz_new, c_new

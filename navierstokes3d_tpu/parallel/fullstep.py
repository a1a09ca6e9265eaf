"""Full-step explicit-communication path: the ENTIRE Chorin time step
runs inside one shard_map over the 3D device mesh, with owned-face
staggered velocity storage and hand-scheduled ppermute halo exchanges
for every stage.

This is the analog of the reference's per-step communication
schedule (NavierStokes3D_multi_gpu.jl:446-477):

  reference                      here
  ---------                      ----
  update_halo!(τxx,τyy,τzz) :450  velocity k=2 halo BEFORE update_τ/predict
                                  (τ is recomputed locally in the pad ring,
                                  so its own exchange disappears)
  update_halo!(C,Vx,Vy,Vz)  :453  (cylinder masks are position-local —
                                  no exchange needed)
  update_halo!(∇V)          :455  ∇V is computed locally from the (0,1)
                                  staggered-face halo — one face ppermute
  Pr halo in the loop       :462  parallel/halo.py solve (6 face
                                  ppermutes/iter)
  update_halo!(Vx,Vy,Vz)    :477  velocity k=advect_k+1 halo BEFORE advect
                                  (covers the select-shift footprint + the
                                  trilinear corner)

Owned-face layout: each velocity stores its n (not n+1) "owned" faces per
global cell row — face i lives with cell i — so all six volumetric fields
are (nx,ny,nz) and shard evenly over P('x','y','z'); Vx memory shrinks
with every mesh axis (the global-view path replicates each velocity along
its own staggered axis, parallel/mesh.py:state_shardings). The global
(n+1)-th face family is a 2D plane of STATE (it carries pre-advect BC
copies across steps), stored replicated along its own axis and sharded
over the other two (vx_hi: P('y','z'), ...).

Stencil stages build halo-padded local canonical arrays (the staggered
axis padded one deeper on the hi side, with the hi-face plane inserted on
the edge device), apply the SAME ops as the single-device path
(ops/physics.py, ops/advect.py), then crop the owned block and restore
cells outside each op's global write region via position masks — so the
owned-cell arithmetic is identical to the single-device step at rounding
level. Advection clamps departure points at GLOBAL bounds (ops/advect's
origin/gshape) and masks writes to each branch's global region (set_fn).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import physics as ph
from ..ops.advect import advect
from ..state import FlowState, StepStats, pytree_dataclass
from .halo import (AXES, _device_pos, _shift, build_poisson_shard_map,
                   halo_pad, halo_pad_asym)

# Halo depth of the advection stage is DERIVED per solver as
# solver.advect_k + 1: the select-shift displacement bound k plus the
# trilinear +1 corner (ops/advect._backtrack_selectshift requires >= k+1
# cells of valid halo). The same depth bounds the 'gather' backend's
# correct displacement range (its global clamp keeps reads in the halo
# only for |dt v / h| <= k).


@pytree_dataclass
class DistState:
    """Sharded flow state in owned-face layout (see module docstring)."""
    pr: jax.Array       # (nx, ny, nz) blocks, P('x','y','z')
    vx: jax.Array       # owned faces 0..nx-1 of Vx
    vy: jax.Array
    vz: jax.Array
    c: jax.Array
    dprdtau: jax.Array
    vx_hi: jax.Array    # global face nx plane (ny, nz), P('y','z')
    vy_hi: jax.Array    # global face ny plane (nx, nz), P('x','z')
    vz_hi: jax.Array    # global face nz plane (nx, ny), P('x','y')


def dist_shardings(mesh: Mesh) -> DistState:
    cell = NamedSharding(mesh, P(*AXES))
    return DistState(
        pr=cell, vx=cell, vy=cell, vz=cell, c=cell, dprdtau=cell,
        vx_hi=NamedSharding(mesh, P("y", "z")),
        vy_hi=NamedSharding(mesh, P("x", "z")),
        vz_hi=NamedSharding(mesh, P("x", "y")))


def to_dist(state: FlowState, mesh: Mesh) -> DistState:
    """Canonical FlowState -> owned-face DistState laid out over the mesh."""
    d = DistState(
        pr=state.pr, vx=state.vx[:-1], vy=state.vy[:, :-1],
        vz=state.vz[:, :, :-1], c=state.c, dprdtau=state.dprdtau,
        vx_hi=state.vx[-1], vy_hi=state.vy[:, -1], vz_hi=state.vz[:, :, -1])
    return jax.tree.map(jax.device_put, d, dist_shardings(mesh))


def from_dist(dist: DistState) -> FlowState:
    """Owned-face DistState -> canonical FlowState (host-side gather)."""
    g = lambda a: np.asarray(a)
    return FlowState(
        pr=jnp.asarray(g(dist.pr)),
        vx=jnp.asarray(np.concatenate([g(dist.vx), g(dist.vx_hi)[None]], 0)),
        vy=jnp.asarray(np.concatenate([g(dist.vy), g(dist.vy_hi)[:, None]],
                                      1)),
        vz=jnp.asarray(np.concatenate([g(dist.vz),
                                       g(dist.vz_hi)[:, :, None]], 2)),
        c=jnp.asarray(g(dist.c)),
        dprdtau=jnp.asarray(g(dist.dprdtau)))


def stag_pad_local(vo, vh, axis, k, blocks):
    """Halo-padded local canonical staggered array (runs INSIDE
    shard_map): faces [go-k, go+b+k] on `axis` (k lo / k+1 hi), cells
    [go-k, go+b+k) on the others. The global hi-face plane vh is inserted
    at its true position on the axis-edge device; pads beyond the global
    domain hold zeros (buffer cells, never consumed with effect)."""
    widths = [(k, k), (k, k), (k, k)]
    widths[axis] = (k, k + 1)
    p = halo_pad_asym(vo, widths)
    # 2D-pad the hi plane over its own axes so corners align
    other = [d for d in range(3) if d != axis]
    vh_p = halo_pad_asym(vh, [(k, k), (k, k)],
                         axis_names=tuple(AXES[d] for d in other)) \
        if k > 0 else vh
    idx = k + blocks[axis]
    ax_name = AXES[axis]
    is_edge = lax.axis_index(ax_name) == lax.axis_size(ax_name) - 1
    if axis == 0:
        with_plane = p.at[idx].set(vh_p)
    elif axis == 1:
        with_plane = p.at[:, idx].set(vh_p)
    else:
        with_plane = p.at[:, :, idx].set(vh_p)
    return jnp.where(is_edge, with_plane, p)


def build_fullstep(solver, mesh: Mesh):
    """Build the jitted full-step function over `mesh` for `solver`.

    Returns step(dist: DistState) -> (DistState, StepStats), jitted with
    donated input. The Poisson stage reuses the distributed solver of
    parallel/halo.py (ppermute-halo loop); every other stage exchanges halos explicitly
    as described in the module docstring.
    """
    cfg, grid = solver.cfg, solver.grid
    phys = cfg.physics
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    dx, dy, dz = grid.dx, grid.dy, grid.dz
    rho, mu, dt, vin = phys.rho, phys.mu, grid.dt, phys.vin
    g_eff = 0.0 if solver.pressure_split else phys.g
    variant, compat = cfg.variant, cfg.compat
    dtype = solver.dtype
    npx, npy, npz = (mesh.shape[a] for a in AXES)
    if nx % npx or ny % npy or nz % npz:
        raise ValueError("grid dims must divide mesh dims")
    bx, by, bz = nx // npx, ny // npy, nz // npz
    adv_k = solver.advect_k
    K = adv_k + 1   # advection halo depth (see module comment)
    if min(bx, by, bz) < K + 1:
        raise ValueError(
            f"full-step shard_map needs local blocks >= {K + 1} cells per "
            f"axis (advection halo depth); got {(bx, by, bz)}")
    poisson_local = build_poisson_shard_map(
        mesh, grid, phys, cfg.numerics.eps_it, variant, dtype,
        halo_width=cfg.parallel.halo, pressure_split=solver.pressure_split,
        stall=solver._stall, wrap=False)

    method = solver.advect_method
    masks = solver.masks
    mc_g = jnp.asarray(np.asarray(masks.mask_c))          # (nx, ny)
    mvx_g = jnp.asarray(np.asarray(masks.mask_vx))        # (nx+1, ny)
    mvy_g = jnp.asarray(np.asarray(masks.mask_vy))        # (nx, ny+1)
    mvz_g = jnp.asarray(np.asarray(masks.mask_vz))        # (nx, ny)
    one = jnp.ones((), dtype)
    zero = jnp.zeros((), dtype)

    # ---- local helpers (all run INSIDE shard_map) ----

    def offs():
        (ix, iy, iz), _ = _device_pos()
        return (ix * bx, iy * by, iz * bz)

    def range_mask(sh, ranges, off0):
        """Bool mask over a local block: per-axis GLOBAL 0-based inclusive
        [lo, hi] ranges (None = unconstrained); off0 = global 0-based
        index of the block's element 0 per axis."""
        m = jnp.ones(sh, bool)
        for d, r in enumerate(ranges):
            if r is None:
                continue
            lo, hi = r
            g = off0[d] + lax.broadcasted_iota(jnp.int32, sh, d)
            m = m & (g >= lo) & (g <= hi)
        return m

    def stag_pad(vo, vh, axis, k):
        return stag_pad_local(vo, vh, axis, k, (bx, by, bz))

    def local2d(mask, o0, o1, s0, s1):
        return lax.dynamic_slice(mask, (jnp.int32(o0), jnp.int32(o1)),
                                 (s0, s1))

    def cylinder_local(c, vx, vy, vz, vxh, vyh, vzh):
        """apply_cylinder on owned blocks + hi-face planes (set_cylinder!,
        gpu.jl:336-368, via precomputed masks, ops/cylinder.py)."""
        ox, oy, _ = offs()
        mcl = local2d(mc_g, ox, oy, bx, by)
        mvxl = local2d(mvx_g, ox, oy, bx, by)
        mvyl = local2d(mvy_g, ox, oy, bx, by)
        mvzl = local2d(mvz_g, ox, oy, bx, by)
        c = jnp.where(mcl[:, :, None], one, c)
        vx = jnp.where(mvxl[:, :, None], zero, vx)
        vy = jnp.where(mvyl[:, :, None], zero, vy)
        vz = jnp.where(mvzl[:, :, None], zero, vz)
        # hi-face planes: Vx face nx (mask row nx), Vy face ny, Vz face nz
        # (z-extruded: same 2D mask as the block)
        mvx_hi = local2d(mvx_g, nx, oy, 1, by)[0]          # (by,)
        mvy_hi = local2d(mvy_g, ox, ny, bx, 1)[:, 0]       # (bx,)
        vxh = jnp.where(mvx_hi[:, None], zero, vxh)
        vyh = jnp.where(mvy_hi[:, None], zero, vyh)
        vzh = jnp.where(mvzl, zero, vzh)
        return c, vx, vy, vz, vxh, vyh, vzh

    # ---- boundary conditions (position-guarded; bc.py orders) ----

    def _pick(plane, ax):
        """The axis-hi device's plane, delivered to every device on the
        axis (the hi-face plane is replicated along its own axis)."""
        i = lax.axis_index(ax)
        n = lax.axis_size(ax)
        return lax.psum(jnp.where(i == n - 1, plane,
                                  jnp.zeros_like(plane)), ax)

    def zg3(a, d):
        """zero_grad along block axis d, guarded to the global edges."""
        (i0, i1, i2), (n0, n1, n2) = _device_pos()
        i = (i0, i1, i2)[d]
        n = (n0, n1, n2)[d]
        idx_lo = [slice(None)] * 3
        idx_lo[d] = 0
        idx_lo2 = [slice(None)] * 3
        idx_lo2[d] = 1
        idx_hi = [slice(None)] * 3
        idx_hi[d] = -1
        idx_hi2 = [slice(None)] * 3
        idx_hi2[d] = -2
        a = jnp.where(i == 0, a.at[tuple(idx_lo)].set(a[tuple(idx_lo2)]), a)
        a = jnp.where(i == n - 1,
                      a.at[tuple(idx_hi)].set(a[tuple(idx_hi2)]), a)
        return a

    def zg2(p, mesh_axis, d2):
        """zero_grad on a 2D hi-face plane block along its axis d2 (which
        is mesh axis `mesh_axis`)."""
        i = lax.axis_index(mesh_axis)
        n = lax.axis_size(mesh_axis)
        if d2 == 0:
            p = jnp.where(i == 0, p.at[0].set(p[1]), p)
            p = jnp.where(i == n - 1, p.at[-1].set(p[-2]), p)
        else:
            p = jnp.where(i == 0, p.at[:, 0].set(p[:, 1]), p)
            p = jnp.where(i == n - 1, p.at[:, -1].set(p[:, -2]), p)
        return p

    def zg_stag(a, ah, d):
        """zero_grad along the field's OWN staggered axis d: lo face from
        the block, hi face (the ah plane) from the axis-hi device's last
        owned face."""
        (i0, i1, i2), _ = _device_pos()
        i = (i0, i1, i2)[d]
        idx_lo = [slice(None)] * 3
        idx_lo[d] = 0
        idx_lo2 = [slice(None)] * 3
        idx_lo2[d] = 1
        a = jnp.where(i == 0, a.at[tuple(idx_lo)].set(a[tuple(idx_lo2)]), a)
        idx_last = [slice(None)] * 3
        idx_last[d] = -1
        ah = _pick(a[tuple(idx_last)], AXES[d])
        return a, ah

    def nbst3(a, d2_is_cells: bool, a_hi=None):
        """noslip_bottom_slip_top (bc_zV!, gpu.jl:239-243) along z.
        For z-cell fields (Vx, Vy): block planes only (their hi-face
        planes handle z via nbst2). For the z-staggered Vz: face 0 = 0,
        face nz = face nz-1 (picked across z)."""
        (_, _, iz), (_, _, Pz) = _device_pos()
        a = jnp.where(iz == 0, a.at[:, :, 0].set(zero), a)
        if d2_is_cells:
            a = jnp.where(iz == Pz - 1, a.at[:, :, -1].set(a[:, :, -2]), a)
            return a
        a_hi = _pick(a[:, :, -1], "z")
        return a, a_hi

    def nbst2(p):
        """bc_zV! on a 2D (·, z-cells) hi-face plane."""
        i = lax.axis_index("z")
        n = lax.axis_size("z")
        p = jnp.where(i == 0, p.at[:, 0].set(zero), p)
        p = jnp.where(i == n - 1, p.at[:, -1].set(p[:, -2]), p)
        return p

    def bc_vel_local(vx, vy, vz, vxh, vyh, vzh):
        (ix, _, _), _ = _device_pos()
        if variant == "multi":
            # Order: NavierStokes3D_multi_gpu.jl:156-169 (bc.py analog)
            vx, vxh = zg_stag(vx, vxh, 0)      # bc_x!(Vx) incl. face nx
            vx = zg3(vx, 1)
            vxh = zg2(vxh, "y", 0)             # x=nx plane is part of Vx
            vx = zg3(vx, 2)
            vxh = zg2(vxh, "z", 1)
            vy = zg3(vy, 0)
            vyh = zg2(vyh, "x", 0)
            if not compat:
                vy, vyh = zg_stag(vy, vyh, 1)  # omitted in ref (:160-161)
            vy = zg3(vy, 2)
            vyh = zg2(vyh, "z", 1)
            vz = zg3(vz, 0)
            vzh = zg2(vzh, "x", 0)
            vz = zg3(vz, 1)
            vzh = zg2(vzh, "y", 1)
            if not compat:
                vz, vzh = zg_stag(vz, vzh, 2)  # omitted in ref (:162-163)
            # inlet Dirichlet Vx (rank-guarded in the ref, :164-166)
            vx = jnp.where(ix == 0, vx.at[0].set(jnp.asarray(vin, dtype)),
                           vx)
        else:  # gpu: NavierStokes3D_gpu.jl:264-279
            vx, vxh = zg_stag(vx, vxh, 0)
            vx = zg3(vx, 1)
            vxh = zg2(vxh, "y", 0)
            vx = nbst3(vx, True)
            vxh = nbst2(vxh)
            vy = zg3(vy, 0)
            vyh = zg2(vyh, "x", 0)
            vy, vyh = zg_stag(vy, vyh, 1)
            vy = nbst3(vy, True)
            vyh = nbst2(vyh)
            vz = zg3(vz, 0)
            vzh = zg2(vzh, "x", 0)
            vz = zg3(vz, 1)
            vzh = zg2(vzh, "y", 1)
            vz, vzh = nbst3(vz, False)
        return vx, vy, vz, vxh, vyh, vzh

    # ---- the step ----

    def step_local(pr, vx, vy, vz, c, dpr, vxh, vyh, vzh):
        off0 = offs()
        # @inn write-region masks (global 0-based) of predict/correct
        inn_vx = range_mask((bx, by, bz),
                            [(1, nx - 1), (1, ny - 2), (1, nz - 2)], off0)
        inn_vy = range_mask((bx, by, bz),
                            [(1, nx - 2), (1, ny - 1), (1, nz - 2)], off0)
        inn_vz = range_mask((bx, by, bz),
                            [(1, nx - 2), (1, ny - 2), (1, nz - 1)], off0)

        # -- stress + predictor (velocity k=2 halo; τ recomputed locally,
        #    replacing update_halo!(τxx,τyy,τzz), multi_gpu.jl:450) --
        vxp = stag_pad(vx, vxh, 0, 2)
        vyp = stag_pad(vy, vyh, 1, 2)
        vzp = stag_pad(vz, vzh, 2, 2)
        taus = ph.update_tau(vxp, vyp, vzp, mu, dx, dy, dz)
        nvx, nvy, nvz = ph.predict_v(vxp, vyp, vzp, *taus, rho, g_eff, dt,
                                     dx, dy, dz)
        sl = (slice(2, 2 + bx), slice(2, 2 + by), slice(2, 2 + bz))
        vx = jnp.where(inn_vx, nvx[sl], vx)
        vy = jnp.where(inn_vy, nvy[sl], vy)
        vz = jnp.where(inn_vz, nvz[sl], vz)
        # hi-face planes are outside @inn: unchanged by the predictor

        # -- cylinder (position-local; no exchange) --
        c, vx, vy, vz, vxh, vyh, vzh = cylinder_local(
            c, vx, vy, vz, vxh, vyh, vzh)

        # -- divergence (one staggered-face halo per velocity: the
        #    update_halo!(∇V) analog, multi_gpu.jl:455) --
        vxp0 = stag_pad(vx, vxh, 0, 0)
        vyp0 = stag_pad(vy, vyh, 1, 0)
        vzp0 = stag_pad(vz, vzh, 2, 0)
        divv = ((vxp0[1:] - vxp0[:-1]) / dx
                + (vyp0[:, 1:] - vyp0[:, :-1]) / dy
                + (vzp0[:, :, 1:] - vzp0[:, :, :-1]) / dz)

        # -- pressure Poisson (parallel/halo.py distributed solve) --
        pr, dpr, iters, err, hist = poisson_local(pr, dpr,
                                                  (rho / dt) * divv)

        # -- corrector (pr width-1 halo) --
        prp = halo_pad(pr, width=1)
        gdx = (prp[1:bx + 1, 1:by + 1, 1:bz + 1]
               - prp[0:bx, 1:by + 1, 1:bz + 1])
        gdy = (prp[1:bx + 1, 1:by + 1, 1:bz + 1]
               - prp[1:bx + 1, 0:by, 1:bz + 1])
        gdz = (prp[1:bx + 1, 1:by + 1, 1:bz + 1]
               - prp[1:bx + 1, 1:by + 1, 0:bz])
        vx = vx + jnp.where(inn_vx, -dt / rho * gdx / dx, zero)
        vy = vy + jnp.where(inn_vy, -dt / rho * gdy / dy, zero)
        vz = vz + jnp.where(inn_vz, -dt / rho * gdz / dz, zero)

        # -- cylinder + velocity BCs --
        c, vx, vy, vz, vxh, vyh, vzh = cylinder_local(
            c, vx, vy, vz, vxh, vyh, vzh)
        vx, vy, vz, vxh, vyh, vzh = bc_vel_local(vx, vy, vz, vxh, vyh, vzh)

        # -- semi-Lagrangian advection (velocity k=advect_k+1 halo: the
        #    update_halo!(Vx,Vy,Vz) analog, multi_gpu.jl:477) --
        vxp4 = stag_pad(vx, vxh, 0, K)
        vyp4 = stag_pad(vy, vyh, 1, K)
        vzp4 = stag_pad(vz, vzh, 2, K)
        cp4 = halo_pad(c, width=K)
        origin = tuple(o - K for o in off0)

        def set_masked(target, region, vals, gbounds):
            sub = target[region]
            m = jnp.ones(vals.shape, bool)
            for d, b in enumerate(gbounds):
                if b is None:
                    continue
                lo1, hi1 = b
                start = region[d].start or 0
                g1 = (origin[d] + start + 1
                      + lax.broadcasted_iota(jnp.int32, vals.shape, d))
                m = m & (g1 >= lo1) & (g1 <= hi1)
            return target.at[region].set(jnp.where(m, vals, sub))

        owned = ((K, K + bx), (K, K + by), (K, K + bz))
        avx, avy, avz, ac, n_clamped = advect(
            vxp4, vyp4, vzp4, cp4, dt, dx, dy, dz, compat=compat,
            method=method, with_stats=True, origin=origin,
            gshape=(nx, ny, nz), set_fn=set_masked,
            k=adv_k, count_box=owned)
        slK = (slice(K, K + bx), slice(K, K + by), slice(K, K + bz))
        vx, vy, vz, c = avx[slK], avy[slK], avz[slK], ac[slK]
        # advect never writes the hi-face planes (regions end at face n-1)
        n_clamped = lax.psum(lax.psum(lax.psum(n_clamped, "x"), "y"), "z")

        return (pr, vx, vy, vz, c, dpr, vxh, vyh, vzh,
                iters, err, hist, n_clamped)

    cell = P(*AXES)
    rep = P()
    state_specs = (cell, cell, cell, cell, cell, cell,
                   P("y", "z"), P("x", "z"), P("x", "y"))
    mapped = shard_map(
        step_local, mesh=mesh,
        in_specs=state_specs,
        out_specs=state_specs + (rep, rep, rep, rep),
        check_vma=False)

    def step(dist: DistState):
        out = mapped(dist.pr, dist.vx, dist.vy, dist.vz, dist.c,
                     dist.dprdtau, dist.vx_hi, dist.vy_hi, dist.vz_hi)
        (pr, vx, vy, vz, c, dpr, vxh, vyh, vzh,
         iters, err, hist, n_clamped) = out
        new = DistState(pr=pr, vx=vx, vy=vy, vz=vz, c=c, dprdtau=dpr,
                        vx_hi=vxh, vy_hi=vyh, vz_hi=vzh)
        return new, StepStats(iters=iters, err=err, err_hist=hist,
                              advect_clamped=n_clamped)

    return jax.jit(step, donate_argnums=0)

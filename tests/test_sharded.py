"""Sharded-vs-single-device equivalence on an 8-way virtual CPU mesh.

The reference's implicit claim — the MPI-decomposed solver computes the
same fields as a single rank — is tested here directly: one full step from
a random developed state on a (2,2,2) mesh must match the single-device
step. Random O(1) velocities keep semi-Lagrangian departure points away
from the floor() discontinuities (see test_step_oracle.py), so the match
is tight.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.parallel import make_mesh, shard_state
from navierstokes3d_tpu.state import FlowState


def _random_state(solver, seed=0):
    rng = np.random.default_rng(seed)
    g = solver.grid
    f = lambda s: jnp.asarray(rng.uniform(-0.7, 0.7, s))
    st = FlowState(
        pr=f(g.shape_c), vx=f(g.shape_vx), vy=f(g.shape_vy),
        vz=f(g.shape_vz), c=f(g.shape_c), dprdtau=f(g.shape_c))
    # dprdtau boundary ring must be zero (class invariant)
    return st.replace(dprdtau=st.dprdtau.at[0].set(0.).at[-1].set(0.)
                      .at[:, 0].set(0.).at[:, -1].set(0.)
                      .at[:, :, 0].set(0.).at[:, :, -1].set(0.))


@pytest.mark.parametrize("compat", [True, False])
def test_step_sharded_equals_single(compat):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = ns.preset_multi(nx=16, nt=1, compat=compat)
    # Short Poisson budget: from *random* input the pseudo-transient
    # iteration is at its CFL stability edge and amplifies roundoff ~x1.5
    # per iteration (physical runs converge and do not), so more
    # iterations would compare two chaotic trajectories.
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, niter_scale=1))
    solver = ns.ChorinSolver(cfg)

    # step_jit donates its input, so build the state independently per path
    ref_state, ref_stats = solver.step_jit(_random_state(solver))

    mesh = make_mesh(devices=jax.devices()[:8])
    st_sh = shard_state(_random_state(solver), mesh)
    sh_state, sh_stats = solver.step_sharded_jit(mesh)(st_sh)

    assert int(ref_stats.iters) == int(sh_stats.iters)
    np.testing.assert_allclose(float(ref_stats.err), float(sh_stats.err),
                               rtol=1e-10)
    for name in ("pr", "vx", "vy", "vz", "c", "dprdtau"):
        a = np.asarray(getattr(ref_state, name))
        b = np.asarray(getattr(sh_state, name))
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-12,
                                   err_msg=name)


def test_three_steps_sharded_from_init():
    """Multi-step sharded run from the real init stays finite, matches
    the single-device trajectory for the first two steps, and keeps
    matching Poisson iteration counts while the trajectories agree.

    The uniform-inflow init puts semi-Lagrangian departure points exactly
    on the backtrack formula's floor() discontinuity (docs/numerics.md),
    where a 1-ulp cross-compilation difference between the single-device
    and SPMD-partitioned programs legitimately flips an O(field) jump —
    so per-step equality is asserted with a small tolerance and only
    while the fields still agree (step 3 may diverge chaotically;
    generic-state 3-step equality is covered by
    test_step_sharded_equals_single)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = ns.preset_multi(nx=16, nt=3, compat=False)
    solver = ns.ChorinSolver(cfg)
    mesh = make_mesh(devices=jax.devices()[:8])
    step_sh = solver.step_sharded_jit(mesh)

    st_single = solver.init_state()
    st_shard = shard_state(solver.init_state(), mesh)
    for k in range(3):
        st_single, stats_single = solver.step_jit(st_single)
        st_shard, stats_shard = step_sh(st_shard)
        if k < 2:
            assert int(stats_single.iters) == int(stats_shard.iters)
            for name in ("pr", "vx", "vy", "vz", "c"):
                a = np.asarray(getattr(st_single, name))
                b = np.asarray(getattr(st_shard, name))
                scale = max(1.0, np.abs(a).max())
                np.testing.assert_allclose(b / scale, a / scale, rtol=0,
                                           atol=1e-5, err_msg=name)
    assert not np.isnan(np.asarray(st_shard.pr)).any()
    assert np.isfinite(float(stats_shard.err))


def _integer_delta_margin(solver, state):
    """Min distance to the nearest integer over every semi-Lagrangian
    displacement the step's advection will see, computed on the EXACT
    pre-advect velocities (the tau/predict/cylinder/poisson/correct/bc
    chain of ChorinSolver._step_impl applied to `state`).

    The backtrack formula t = (δ>0) - δ%1 with i1 = floor(idx-δ)
    (gpu.jl:288-304) is discontinuous at EVERY integer δ — including 0:
    for 0 < δ < ulp(idx), idx-δ rounds back to idx so all weight lands on
    offset +1, a full-cell jump. Exact zeros (BC/cylinder-assigned) are
    deterministic on both programs and excluded from the margin."""
    import jax.numpy as jnp
    from navierstokes3d_tpu.ops import physics as ph
    from navierstokes3d_tpu.ops.cylinder import apply_cylinder
    g, phys = solver.grid, solver.cfg.physics
    g_eff = 0.0 if solver.pressure_split else phys.g
    taus = ph.update_tau(state.vx, state.vy, state.vz, phys.mu,
                         g.dx, g.dy, g.dz)
    vx, vy, vz = ph.predict_v(state.vx, state.vy, state.vz, *taus,
                              phys.rho, g_eff, g.dt, g.dx, g.dy, g.dz)
    c, vx, vy, vz = apply_cylinder(state.c, vx, vy, vz, solver.masks)
    divv = ph.update_divv(vx, vy, vz, g.dx, g.dy, g.dz)
    pr, _, _ = solver.poisson_solve(state.pr, state.dprdtau, divv)
    vx, vy, vz = ph.correct_v(vx, vy, vz, pr, g.dt, phys.rho,
                              g.dx, g.dy, g.dz)
    c, vx, vy, vz = apply_cylinder(c, vx, vy, vz, solver.masks)
    vx, vy, vz = solver.set_bc_vel(vx, vy, vz)

    def branch_avgs():
        # the four advected branches' face-averaged advecting velocities
        # (ops/advect.py / gpu.jl:308-332, compat=False)
        yield (vx[1:-1], 0.25 * (vy[:-1, :-1] + vy[:-1, 1:]
                                 + vy[1:, :-1] + vy[1:, 1:]),
               0.25 * (vz[:-1, :, :-1] + vz[:-1, :, 1:]
                       + vz[1:, :, :-1] + vz[1:, :, 1:]))
        yield (0.25 * (vx[:-1, :-1] + vx[1:, :-1]
                       + vx[:-1, 1:] + vx[1:, 1:]),
               vy[:, 1:-1],
               0.25 * (vz[:, :-1, :-1] + vz[:, :-1, 1:]
                       + vz[:, 1:, :-1] + vz[:, 1:, 1:]))
        yield (0.25 * (vx[:-1, :, :-1] + vx[1:, :, :-1]
                       + vx[:-1, :, 1:] + vx[1:, :, 1:]),
               0.25 * (vy[:, :-1, :-1] + vy[:, 1:, :-1]
                       + vy[:, :-1, 1:] + vy[:, 1:, 1:]),
               vz[:, :, 1:-1])
        yield (0.5 * (vx[:-1] + vx[1:]), 0.5 * (vy[:, :-1] + vy[:, 1:]),
               0.5 * (vz[:, :, :-1] + vz[:, :, 1:]))

    margin = np.inf
    for vxc, vyc, vzc in branch_avgs():
        for v, d in ((vxc, g.dx), (vyc, g.dy), (vzc, g.dz)):
            delta = np.asarray(g.dt * v / jnp.asarray(d))
            live = delta != 0.0   # bitwise zeros (BC/cylinder-assigned)
            if live.any():
                dist = np.abs(delta[live] - np.round(delta[live]))
                margin = min(margin, float(dist.min()))
    return margin


def test_three_steps_sharded_strict_off_integer_delta():
    """Strict multi-step sharded equality (VERDICT r2 #7): away from the
    backtrack formula's integer-δ discontinuities the SPMD-partitioned
    program tracks the single-device trajectory at roundoff level for
    three chained steps, with identical Poisson iteration counts every
    step and the off-ℤ premise ASSERTED, not assumed.

    Why not from-init: the init state has vy = vz ≡ 0, and δ = 0 is
    itself on the discontinuity set of t = (δ>0) - δ%1 (gpu.jl:301) —
    cancellation noise at the 1e-20 level decides a full-cell weight
    flip wherever a velocity crosses zero, so two differently-fused
    compilations legitimately diverge at O(field) on the second step
    (observed: 4%-of-field vy jumps). Any physical trajectory of this
    flow grows tiny transverse velocities with spatial zero crossings,
    so the strict claim is only well-posed on states whose in-step
    displacements stay bounded away from every integer — here the
    generic-state machinery of test_step_sharded_equals_single, whose
    margins are ~1e-4 cells (asserted > 1e-8 each step; cross-program
    δ noise is ~1e-15, seven orders smaller; bitwise-zero δs are
    BC/cylinder assignments, identical in both programs).

    Tolerance schedule, not raw f64 rounding: with the short Poisson
    budget the random state is never fully projected and the fields grow
    ~400x/step, carrying cross-compilation roundoff with them
    (measured worst relative diffs: 2e-14, 7e-12, 8e-9). The schedule
    tracks that linear amplification with ~25x headroom while staying
    5+ orders below the O(1e-2-relative) full-cell weight flips the
    relaxed from-init test must tolerate — so a single flip anywhere in
    three steps fails the test, which is its point."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = ns.preset_multi(nx=16, nt=3, compat=False)
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, niter_scale=1))
    solver = ns.ChorinSolver(cfg)
    mesh = make_mesh(devices=jax.devices()[:8])
    step_sh = solver.step_sharded_jit(mesh)

    st_single = _random_state(solver, seed=3)
    st_shard = shard_state(_random_state(solver, seed=3), mesh)
    atol = (1e-12, 2e-10, 2e-7)
    for k in range(3):
        m = _integer_delta_margin(solver, st_single)
        assert m > 1e-8, f"premise violated at step {k}: δ margin {m}"
        st_single, stats_single = solver.step_jit(st_single)
        st_shard, stats_shard = step_sh(st_shard)
        assert int(stats_single.iters) == int(stats_shard.iters)
        for name in ("pr", "vx", "vy", "vz", "c", "dprdtau"):
            a = np.asarray(getattr(st_single, name))
            b = np.asarray(getattr(st_shard, name))
            scale = max(1.0, np.abs(a).max())
            np.testing.assert_allclose(b / scale, a / scale, rtol=0,
                                       atol=atol[k], err_msg=name)


@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_shard_map_poisson_equals_single(variant):
    """The explicit ppermute-halo shard_map Poisson path (parallel/halo.py)
    must match the single-device solve."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    preset = ns.preset_multi if variant == "multi" else ns.preset_gpu
    cfg = preset(nx=16, nt=1, compat=False)
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, niter_scale=1))
    solver = ns.ChorinSolver(cfg)
    ref_state, ref_stats = solver.step_jit(_random_state(solver))
    mesh = make_mesh(devices=jax.devices()[:8])
    st_sh = shard_state(_random_state(solver), mesh)
    sm_state, sm_stats = solver.step_shard_map_jit(mesh)(st_sh)
    assert int(ref_stats.iters) == int(sm_stats.iters)
    np.testing.assert_allclose(float(ref_stats.err), float(sm_stats.err),
                               rtol=1e-10)
    for name in ("pr", "vx", "vy", "vz", "c", "dprdtau"):
        a = np.asarray(getattr(ref_state, name))
        b = np.asarray(getattr(sm_state, name))
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("halo_width", [2, 3])
def test_halo_width_batching_matches_width1(halo_width):
    """k Poisson iterations per k-deep halo exchange (temporal blocking,
    the b_width generalization) must match the width-1 schedule on owned
    cells up to compiler FMA noise."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from navierstokes3d_tpu.config import ParallelConfig
    cfg0 = ns.preset_multi(nx=16, nt=1, compat=False)
    cfg0 = cfg0.replace(numerics=dataclasses.replace(
        cfg0.numerics, niter_scale=1))
    mesh = make_mesh(devices=jax.devices()[:8])
    results = {}
    for hw in (1, halo_width):
        solver = ns.ChorinSolver(cfg0.replace(parallel=ParallelConfig(halo=hw)))
        st = shard_state(_random_state(solver), mesh)
        stt, stats = solver.step_shard_map_jit(mesh)(st)
        results[hw] = (stt, int(stats.iters))
    assert results[1][1] == results[halo_width][1]
    for name in ("pr", "vx", "vy", "vz", "dprdtau"):
        a = np.asarray(getattr(results[1][0], name))
        b = np.asarray(getattr(results[halo_width][0], name))
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-9,
                                   err_msg=name)


def _rand_pois(g, seed=5):
    rng = np.random.default_rng(seed)
    f = lambda s, sc: jnp.asarray(rng.uniform(-sc, sc, s).astype(np.float32))
    pr = f(g.shape_c, 100.0)
    dpr = jnp.zeros(g.shape_c, jnp.float32)
    rhs = f(g.shape_c, 50.0)
    return pr, dpr, rhs


@pytest.mark.parametrize("variant", ["multi", "gpu"])
def test_shard_map_x_only_matches_one_device(variant):
    """The shard_map Poisson loop on an x-only mesh (the shape --mesh
    auto prefers) matches the same distributed algorithm on a 1-device
    mesh iteration for iteration, and its compiled HLO contains no
    all-gather (communication is face-plane collective-permutes + the
    residual all-reduce only)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from navierstokes3d_tpu.parallel.halo import build_poisson_shard_map
    preset = ns.preset_gpu if variant == "gpu" else ns.preset_multi
    cfg = preset(nx=40, nt=1, compat=False, dtype="float32")
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, niter_scale=1, stall_exit=False))
    solver = ns.ChorinSolver(cfg)
    g = solver.grid
    pr, dpr, rhs = _rand_pois(g)

    def build(shape):
        mesh = make_mesh(shape=shape,
                         devices=jax.devices()[:int(np.prod(shape))])
        return jax.jit(build_poisson_shard_map(
            mesh, g, cfg.physics, cfg.numerics.eps_it, cfg.variant,
            jnp.float32, pressure_split=solver.pressure_split, stall=None))

    p_ref, _, it_ref, err_ref, _ = build((1, 1, 1))(pr, dpr, rhs)
    fn = build((4, 1, 1))
    p_sh, _, iters, err, _ = fn(pr, dpr, rhs)
    assert int(iters) == int(it_ref) > 0
    scale = max(1.0, float(jnp.abs(p_ref).max()))
    np.testing.assert_allclose(np.asarray(p_sh) / scale,
                               np.asarray(p_ref) / scale,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(err), float(err_ref),
                               rtol=1e-3, atol=1e-6)
    hlo = fn.lower(pr, dpr, rhs).compile().as_text()
    assert "all-gather" not in hlo, "Pr must never be gathered"
    assert "collective-permute" in hlo, "halo exchange must be ppermute"

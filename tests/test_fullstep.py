"""Full-step explicit-communication shard_map (parallel/fullstep.py):
whole-step equivalence vs the single-device path at FULL iteration
budget, in the owned-face staggered layout, on an 8-virtual-device mesh.

The reference's multi-GPU script is the same solver with halo exchanges
interleaved (NavierStokes3D_multi_gpu.jl:446-477); these tests assert the
distributed full step reproduces the single-device trajectory to f64
rounding, which is the strongest available analog of the reference's
single-rank == multi-rank property.

The comparison starts from a RANDOM state, not the presets' init: the
presets run at CFL_adv = 1.0 with an exactly-uniform inflow, which puts
semi-Lagrangian displacements EXACTLY on the backtrack formula's
integer-δ discontinuity (gpu.jl:295-304: at δ == 1.0 the interpolation
weight t = 1 selects A[ix] instead of the limit A[ix-1]) — there a 1-ulp
rounding difference flips an O(field) jump, in any two implementations.
Random O(1) velocities keep departure points away from that measure-zero
set (same device as tests/test_precision._random_state). The sharded
advect itself was verified bit-exact against the global advect of an
identical state.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.parallel.fullstep import (build_fullstep, from_dist,
                                                  to_dist)
from navierstokes3d_tpu.parallel.mesh import make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

FIELDS = ("pr", "vx", "vy", "vz", "c", "dprdtau")


def _random_state(solver, seed=0, vscale=0.7):
    """Generic state away from the integer-δ set (module docstring);
    same construction as tests/test_precision._random_state."""
    from navierstokes3d_tpu.state import FlowState
    rng = np.random.default_rng(seed)
    g = solver.grid
    f = lambda s, sc=vscale: jnp.asarray(rng.uniform(-sc, sc, s))
    st = FlowState(
        pr=f(g.shape_c, 50.0), vx=f(g.shape_vx), vy=f(g.shape_vy),
        vz=f(g.shape_vz), c=f(g.shape_c, 1.0), dprdtau=f(g.shape_c, 0.1))
    return st.replace(dprdtau=st.dprdtau.at[0].set(0.).at[-1].set(0.)
                      .at[:, 0].set(0.).at[:, -1].set(0.)
                      .at[:, :, 0].set(0.).at[:, :, -1].set(0.))


def _solver(variant, compat, nx=40):
    preset = ns.preset_multi if variant == "multi" else ns.preset_gpu
    cfg = preset(nx=nx, nt=2, compat=compat, dtype="float64")
    return ns.ChorinSolver(cfg)


def _assert_states_close(st_ref, st_sh, atol=1e-9):
    for f in FIELDS:
        a = np.asarray(getattr(st_ref, f))
        b = np.asarray(getattr(st_sh, f))
        scale = max(1.0, np.abs(a).max())
        # dprdtau integrates the Poisson residual, whose rounding differs
        # between the folded single-device lap and the sharded exact lap
        tol = 100 * atol if f == "dprdtau" else atol
        np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=tol,
                                   err_msg=f)


def test_dist_roundtrip():
    s = _solver("multi", False)
    st = s.init_state()
    mesh = make_mesh((2, 2, 2))
    d = to_dist(st, mesh)
    st2 = from_dist(d)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                      np.asarray(getattr(st2, f)), f)


@pytest.mark.parametrize("variant,compat", [("multi", False),
                                            ("multi", True),
                                            ("gpu", False)])
@pytest.mark.parametrize("shape", [(2, 2, 2), (8, 1, 1)])
def test_fullstep_equals_single(variant, compat, shape):
    """Two FULL-budget steps: the distributed step (owned-face layout,
    every stage under one shard_map) matches the single-device step —
    same Poisson iteration counts, fields to f64 rounding."""
    s = _solver(variant, compat)
    mesh = make_mesh(shape)
    step = build_fullstep(s, mesh)
    st_ref = _random_state(s)
    d = to_dist(_random_state(s), mesh)
    for _ in range(2):
        st_ref, stats_ref = s.step_jit(st_ref)
        d, stats_sh = step(d)
        assert int(stats_sh.advect_clamped) == 0
    # Poisson loop semantics differ in rounding only -> identical chunked
    # iteration counts in f64
    assert int(stats_ref.iters) == int(stats_sh.iters)
    _assert_states_close(st_ref, from_dist(d))


def test_fullstep_hlo_has_no_all_gather():
    """The whole-step shard_map must communicate only via neighbor
    collective-permutes and scalar/plane all-reduces — never by gathering
    a volumetric field (which would mean the owned-face layout leaked
    through to the partitioner)."""
    s = _solver("multi", False)
    mesh = make_mesh((2, 2, 2))
    step = build_fullstep(s, mesh)
    d = to_dist(s.init_state(), mesh)
    hlo = step.lower(d).compile().as_text()
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo, "volumetric gather in full-step HLO"


def test_fullstep_x_only_matches_shard_map_path():
    """The full step under one shard_map on an x-only mesh (the shape
    --mesh auto prefers when nx splits evenly) matches the standalone
    shard_map Poisson path (rest of the step global-view) iteration for
    iteration, and its HLO gathers no volumetric field.

    Reference analog: the multi script's fully-interleaved step,
    NavierStokes3D_multi_gpu.jl:446-477."""
    import dataclasses
    from navierstokes3d_tpu.parallel.mesh import shard_state
    cfg = ns.preset_multi(nx=40, nt=1, compat=False, dtype="float32")
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, niter_scale=1, stall_exit=False))
    solver = ns.ChorinSolver(cfg)
    solver.advect_method = "selectshift"  # gather all-gathers by design
    mesh = make_mesh((8, 1, 1))

    step_fs = build_fullstep(solver, mesh)
    d = to_dist(_random_state(solver), mesh)
    d, stats_fs = step_fs(d)

    solver2 = ns.ChorinSolver(cfg)
    solver2.advect_method = "selectshift"
    step_sm = solver2.step_shard_map_jit(mesh)
    st = shard_state(_random_state(solver2), mesh)
    st, stats_sm = step_sm(st)

    assert int(stats_fs.iters) == int(stats_sm.iters)
    assert int(stats_fs.iters) > 0
    np.testing.assert_allclose(float(stats_fs.err), float(stats_sm.err),
                               rtol=1e-3, atol=1e-6)
    st_fs = from_dist(d)
    for f in FIELDS:
        a = np.asarray(getattr(st, f))
        b = np.asarray(getattr(st_fs, f))
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(b / scale, a / scale, rtol=0,
                                   atol=2e-5, err_msg=f)

    # communication audit: neighbor permutes only, no volumetric gather
    d2 = to_dist(solver.init_state(), mesh)
    hlo = step_fs.lower(d2).compile().as_text()
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo, "volumetric gather in fullstep HLO"


def test_fullstep_selectshift_matches_gather_mode_sharded():
    """The select-shift advection backend under the sharded full step
    matches its own single-device result (global-bound clamping and
    region masking are the sharding-sensitive parts)."""
    s = _solver("multi", False)
    s.advect_method = "selectshift"
    mesh = make_mesh((2, 2, 2))
    step = build_fullstep(s, mesh)
    st_ref = _random_state(s)
    d = to_dist(_random_state(s), mesh)
    for _ in range(2):
        st_ref, _ = s.step_jit(st_ref)
        d, _ = step(d)
    _assert_states_close(st_ref, from_dist(d))

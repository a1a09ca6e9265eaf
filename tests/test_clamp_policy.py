"""--on-clamp escalation policy (run.clamp_escalation): when a step
reports clamped select-shift advection departure points — values there
already diverged from the reference's global-clamp gather semantics
(gpu.jl:290-293) — the driver can warn (default), abort, or switch the
advection backend to the exact gather for all subsequent steps.
Safety envelope (docs/numerics.md): with the advective CFL constraint
binding, k=2 covers |V| <= 2*vin/CFL_adv."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.run import clamp_escalation


def _hot_solver():
    """Small solver whose hot_state() Vx displacement is ~8 cells/step —
    far beyond the select-shift window k=2."""
    cfg = ns.preset_multi(nx=16, nt=1, compat=False, dtype="float32")
    solver = ns.ChorinSolver(cfg)
    # the default is 'gather'; force the windowed backend (the jit
    # traces self.advect_method on first call, so setting it here is
    # enough)
    solver.advect_method = "selectshift"

    def hot_state():
        st = solver.init_state()
        big = 8.0 * solver.grid.dx / solver.grid.dt
        return st.replace(vx=jnp.full_like(st.vx, big))

    return solver, hot_state


def test_hot_state_trips_counter_and_abort_policy():
    solver, hot_state = _hot_solver()
    _, stats = solver.step_jit(hot_state())
    n = int(stats.advect_clamped)
    assert n > 0, "8-cell displacement must trip the clamp counter"
    with pytest.raises(SystemExit, match="ABORT"):
        clamp_escalation("abort", solver, 1, n, lambda: None)


def test_gather_fallback_policy(capsys):
    solver, hot_state = _hot_solver()
    _, stats = solver.step_jit(hot_state())
    n = int(stats.advect_clamped)
    assert n > 0

    rebuilds = []

    def rebuild():
        # fresh closure, not the bound method — equal bound methods share
        # jax's trace cache and would reuse the stale selectshift trace
        # (run.build_step does the same)
        fn = jax.jit(lambda s: solver.step(s), donate_argnums=0)
        rebuilds.append(fn)
        return fn

    new_step = clamp_escalation("gather", solver, 1, n, rebuild)
    assert new_step is rebuilds[0]
    assert solver.advect_method == "gather"
    # the swapped backend has exact global-clamp semantics: no clamp stat
    st3, stats3 = new_step(hot_state())
    assert int(stats3.advect_clamped) == 0
    assert np.isfinite(np.asarray(st3.pr)).all()
    # second report must not rebuild again
    assert clamp_escalation("gather", solver, 2, 1, rebuild) is None
    assert len(rebuilds) == 1


def test_warn_policy_is_noop():
    solver, _ = _hot_solver()
    assert clamp_escalation("warn", solver, 1, 3, lambda: None) is None
    assert solver.advect_method == "selectshift"
    # zero clamps: silent no-op under every policy
    assert clamp_escalation("abort", solver, 1, 0, lambda: None) is None

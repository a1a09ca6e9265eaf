"""chip_smoke.py's comparison helpers on the CPU: the jump mask of
backtrack! (clamp_jump_mask, departure_points), the NaN guard, and the
one-step comparison of phases (c1)/(c2) with float32 against float64."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.ops.advect import advect

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
try:
    import chip_smoke as cs
finally:
    sys.path.remove(ROOT)


F32, F64 = (float(np.finfo(t).eps) for t in (np.float32, np.float64))


@pytest.mark.parametrize("i,dla,dlb,eps,marked", [
    (1, 0.1, -0.1, F64, True),    # p crosses 1: the clamp flips t
    (1, 1.2, 0.9, F64, True),     # p crosses 0, below the first cell
    (1, 0.0, 0.0, F64, True),     # on the clamp jump itself (within eta)
    (1, 0.7, 0.3, F64, False),    # clamped on both sides, same branch
    (2, 0.8, 0.2, F64, False),
    (3, 1.1, 0.9, F64, False),    # an interior integer: continuous
    (31, 1e-7, -1e-7, F32, True),  # float32: 31 - 1e-7 rounds to 31
    (31, 1e-7, 1e-7, F64, False),  # float64 resolves it
    (31, 1.0, 1.0, F64, True),    # dl an integer: t = 1, one cell on
    (8, 0.5, 0.5, F32, False),
])
def test_jump_mask_points(i, dla, dlb, eps, marked):
    def disp(dl):
        return tuple((np.full((1, 1, 1), float(k)), np.full((1, 1, 1), d))
                     for k, d in ((i, dl), (5, 0.5), (5, 0.5)))
    m = cs.jump_mask("c", (1, 1, 1), disp(dla), disp(dlb), eps, eps)
    assert m[0, 0, 0] == marked


def test_jump_mask_covers_the_written_region_only():
    shape = (6, 4, 3)                       # a vy-shaped field
    one = np.ones((6, 2, 3))
    d = ((one, 0 * one),) * 3               # p = 1 on every axis
    m = cs.jump_mask("vy", shape, d, d, F64, F64)
    assert m[:, 1:-1].all() and not m[:, 0].any() and not m[:, -1].any()


@pytest.mark.parametrize("dtype_b,vz_b", [
    ("float64", 1e-12),   # signs of a near-zero velocity: clamp jumps
    ("float32", 1e-9),    # float32 rounding of i - dl for dl > 0 tiny
])
def test_jump_mask_explains_advection_jumps(dtype_b, vz_b):
    """Two advections, float64 with vz = 0 against a run whose vz is
    +-vz_b: cells move by O(1) where jump_mask says backtrack! jumps,
    and elsewhere by vz_b times a slope plus round-off of run b's
    dtype."""
    rng = np.random.default_rng(0)
    nx, ny, nz = 10, 7, 6
    dt = dx = dy = dz = 1.0
    vx = rng.uniform(-0.8, 0.8, (nx + 1, ny, nz))
    vy = rng.uniform(-0.8, 0.8, (nx, ny + 1, nz))
    vz = np.zeros((nx, ny, nz + 1))        # as at the presets' start
    c = rng.uniform(0, 1, (nx, ny, nz))
    vzb = rng.choice([-vz_b, vz_b], vz.shape)
    b = [jnp.asarray(a, dtype_b) for a in (vx, vy, vzb, c)]
    out_a = advect(*map(jnp.asarray, (vx, vy, vz, c)), dt, dx, dy, dz,
                   compat=False)
    out_b = advect(*b, dt, dx, dy, dz, compat=False)
    da = cs.departure_points(vx, vy, vz, dt, dx, dy, dz)
    db = cs.departure_points(*b[:3], dt, dx, dy, dz)
    eps_b = float(np.finfo(dtype_b).eps)
    jumped = 0
    for f, a, bb in zip(("vx", "vy", "vz", "c"), out_a, out_b):
        d = np.abs(np.asarray(a) - np.asarray(bb, np.float64))
        mask = cs.jump_mask(f, d.shape, da[f], db[f], F64, eps_b)
        assert d[~mask].max() < 10 * vz_b + 1e3 * eps_b, f
        jumped += int((d[mask] > 1e-3).sum())
    assert jumped > 0


def test_rel_refuses_nan():
    a = np.array([1.0, np.nan])
    with pytest.raises(AssertionError, match="non-finite"):
        cs.rel(a, np.ones(2))
    assert cs.rel(np.ones(2), np.ones(2)) == 0.0


@pytest.mark.parametrize("backend", ["pt", "fdm"])
def test_f32_step_against_f64_outside_jumps(backend):
    """Phase (c2) on the CPU at a small grid: float32 against float64,
    one step, within the stated bound outside the jump cells; the split
    step that yields the departure points reproduces step_jit to
    float32 rounding (fdm's step_jit passes its eigenvalues as
    arguments, the split step closes over them: another program)."""
    import jax
    cpu = jax.devices("cpu")[0]

    def cfg_of(dtype):
        c = ns.preset_gpu(nx=30, compat=False, dtype=dtype)
        return c.replace(numerics=dataclasses.replace(
            c.numerics, poisson_backend=backend))

    rep, dmax = cs.compare_step(cfg_of("float32"), cpu, cfg_of("float64"),
                                cpu)
    assert dmax <= cs.TOLERANCES["f32_velocity_max"], rep
    assert max(rep["prelude_vs_step"].values()) <= 1e-5, rep
    assert sum(rep["jump_cells"].values()) > 0

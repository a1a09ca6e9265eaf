"""The two advection backends of ops/advect.py: the bounded-window
select-shift stencil against the reference's per-point trilinear gather
(backtrack! + lerp, NavierStokes3D_gpu.jl:288-334), in float64.

Inside its window (|dt v / h| <= k on every axis) select-shift equals
the gather to round-off and counts no clamps; beyond it the departure
points are clamped and counted, and a wide enough window restores the
gather's values.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from navierstokes3d_tpu.ops.advect import advect

DIMS = [(17, 9, 9), (12, 7, 5), (13, 6, 7)]


def _fields(dims, disp, seed=0):
    """Staggered velocities and tracer on an nx x ny x nz grid with
    h = 1/nx per axis and dt = 0.5 h, scaled so that |dt v / h| <= disp."""
    nx, ny, nz = dims
    rng = np.random.default_rng(seed)
    h = 1.0 / nx
    dt = 0.5 * h
    vmax = disp * h / dt
    f = lambda s, sc: jnp.asarray(rng.uniform(-sc, sc, s))
    return (f((nx + 1, ny, nz), vmax), f((nx, ny + 1, nz), vmax),
            f((nx, ny, nz + 1), vmax), f((nx, ny, nz), 1.0), dt, h)


def _run(fields, method, k, compat):
    # eager: the (2k+2)^3-term select-shift graph compiles slowly on the
    # CPU backend, while its op-by-op dispatch is quick at these sizes
    vx, vy, vz, c, dt, h = fields
    return advect(vx, vy, vz, c, dt, h, h, h, compat=compat,
                  method=method, with_stats=True, k=k)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dims", DIMS)
def test_selectshift_matches_gather_inside_window(dims, k, compat):
    fields = _fields(dims, disp=0.95 * k)
    got = _run(fields, "selectshift", k, compat)
    ref = _run(fields, "gather", k, compat)
    assert int(got[4]) == 0 and int(ref[4]) == 0
    for name, a, b in zip(("vx", "vy", "vz", "c"), got[:4], ref[:4]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("dims", DIMS)
def test_selectshift_clamps_beyond_window(dims, compat):
    """Displacements up to 2.9 cells against a k=1 window: clamped points
    are counted (the gather never counts); a k=3 window covers them and
    matches the gather again."""
    fields = _fields(dims, disp=2.9, seed=3)
    narrow = _run(fields, "selectshift", 1, compat)
    wide = _run(fields, "selectshift", 3, compat)
    ref = _run(fields, "gather", 2, compat)
    assert int(narrow[4]) > 0
    assert int(wide[4]) == 0 and int(ref[4]) == 0
    for name, a, b in zip(("vx", "vy", "vz", "c"), wide[:4], ref[:4]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=name)

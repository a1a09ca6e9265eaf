"""The folded `pt` Poisson solve (models/chorin._poisson_solve_jnp_folded,
the loop every non-compat run takes on every device) against the
reference's update-then-BC loop: the unfolded jnp solve
(_poisson_solve_jnp, the compat path) and the scalar-loop transcription
of the reference (tests/oracle_scalar.py), all in float64.

eps_it is set so high that both loops exit at their first residual
check, i.e. after exactly nchk sweeps, so the three see the same
iteration count and the fields must agree to round-off.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import oracle_scalar as orc
import navierstokes3d_tpu as ns

# (variant, hydrostatic pressure split)
CASES = [("multi", False), ("gpu", False), ("gpu", True)]


def _solver(variant, split, nx):
    preset = ns.preset_gpu if variant == "gpu" else ns.preset_multi
    cfg = preset(nx=nx, nt=1, compat=False, dtype="float64")
    cfg = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, pressure_split=split, eps_it=1e29, stall_exit=False))
    s = ns.ChorinSolver(cfg)
    assert s.pressure_split == split
    return s


def _inputs(s, seed=1):
    """Smooth random pressure (stored representation) and divergence,
    zero dPr/dtau (its ring is always zero)."""
    rng = np.random.default_rng(seed)
    g = s.grid

    def smooth(scale):
        a = rng.standard_normal(g.shape_c)
        for ax in range(3):
            a = 0.5 * a + 0.25 * (np.roll(a, 1, ax) + np.roll(a, -1, ax))
        return a * scale

    return (jnp.asarray(smooth(50.0)), jnp.zeros(g.shape_c),
            jnp.asarray(smooth(0.05)))


@pytest.mark.parametrize("nx", [13, 17, 24, 49])
@pytest.mark.parametrize("variant,split", CASES)
def test_folded_matches_unfolded(variant, split, nx):
    s = _solver(variant, split, nx)
    pr, dpr, divv = _inputs(s)
    p1, d1, st1 = jax.jit(s._poisson_solve_jnp_folded)(pr, dpr, divv)
    p2, d2, st2 = jax.jit(s._poisson_solve_jnp)(pr, dpr, divv)
    assert int(st1.iters) == int(st2.iters) == s.grid.nchk
    scale = float(jnp.abs(p2).max())
    np.testing.assert_allclose(np.asarray(p1) / scale,
                               np.asarray(p2) / scale, rtol=0, atol=1e-12)
    dscale = float(jnp.abs(d2).max())
    np.testing.assert_allclose(np.asarray(d1) / dscale,
                               np.asarray(d2) / dscale, rtol=0, atol=1e-12)
    # (err differs by design: the folded loop's check value is the
    # residual ENTERING the last sweep, ptloop.pt_loop_fused)


@pytest.mark.parametrize("nx", [13, 17, 24])
@pytest.mark.parametrize("variant,split", CASES)
def test_folded_matches_scalar_oracle(variant, split, nx):
    s = _solver(variant, split, nx)
    g, phys = s.grid, s.cfg.physics
    pr, dpr, divv = _inputs(s, seed=2)
    p1, _, st = jax.jit(s._poisson_solve_jnp_folded)(pr, dpr, divv)
    # the oracle iterates the PHYSICAL pressure with the reference's BCs
    p = np.asarray(s.full_pressure(pr))
    d = np.zeros((g.nx - 2, g.ny - 2, g.nz - 2))
    dv = np.asarray(divv)
    for _ in range(int(st.iters)):
        p, d = orc.poisson_iter(p, d, dv, phys.rho, g.dt, g.dtau, g.damp,
                                g.dx, g.dy, g.dz)
        p = (orc.set_bc_pr_gpu(p, g.dz, g.nz, phys.g, phys.rho)
             if variant == "gpu" else orc.set_bc_pr_multi(p))
    got = np.asarray(s.full_pressure(p1))
    scale = np.abs(p).max()
    np.testing.assert_allclose(got / scale, p / scale, rtol=0, atol=1e-11)

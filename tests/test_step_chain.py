"""The non-Poisson chain of a step, as the solver runs it on every
device: the predictor (ChorinSolver._predict: update_τ!, predict_V!,
set_cylinder!, update_∇V!) and the corrector (ChorinSolver._correct:
correct_V!, set_cylinder!, set_bc_Vel!), against the scalar-loop
transcription of the reference (tests/oracle_scalar.py) in float64."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import oracle_scalar as orc
import navierstokes3d_tpu as ns
from navierstokes3d_tpu.state import FlowState


def _setup(variant, nx, seed=11):
    preset = ns.preset_gpu if variant == "gpu" else ns.preset_multi
    s = ns.ChorinSolver(preset(nx=nx, nt=1, compat=False, dtype="float64"))
    g = s.grid
    rng = np.random.default_rng(seed)
    f = lambda shape, sc=1.0: rng.uniform(-sc, sc, shape)
    return s, g, dict(vx=f(g.shape_vx), vy=f(g.shape_vy), vz=f(g.shape_vz),
                      c=f(g.shape_c), pr=f(g.shape_c, 50.0))


def _cylinder(s, g, c, vx, vy, vz):
    """set_cylinder! through the solver's own masks (the masks themselves
    are checked against the oracle in test_kernels.test_cylinder; the
    compat=False gpu masks drop the reference's yc quirk, config.py)."""
    m = s.masks
    mc, mvx, mvy, mvz = (np.asarray(a)[:, :, None] for a in
                         (m.mask_c, m.mask_vx, m.mask_vy, m.mask_vz))
    return (np.where(mc, 1.0, c), np.where(mvx, 0.0, vx),
            np.where(mvy, 0.0, vy), np.where(mvz, 0.0, vz))


def _close(got, ref, name):
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12,
                               atol=1e-12 * max(1.0, np.abs(ref).max()),
                               err_msg=name)


@pytest.mark.parametrize("variant", ["gpu", "multi"])
@pytest.mark.parametrize("nx", [17, 24])
def test_predictor_chain_matches_oracle(nx, variant):
    s, g, f = _setup(variant, nx)
    phys = s.cfg.physics
    # under the hydrostatic split the body force cancels out of the step
    g_eff = 0.0 if s.pressure_split else phys.g
    taus = orc.update_tau(f["vx"], f["vy"], f["vz"], phys.mu,
                          g.dx, g.dy, g.dz)
    vx, vy, vz = orc.predict_v(f["vx"], f["vy"], f["vz"], *taus, phys.rho,
                               g_eff, g.dt, g.dx, g.dy, g.dz)
    c, vx, vy, vz = _cylinder(s, g, f["c"], vx, vy, vz)
    divv = orc.update_divv(vx, vy, vz, g.dx, g.dy, g.dz)
    st = FlowState(**{k: jnp.asarray(v) for k, v in f.items()},
                   dprdtau=jnp.zeros(g.shape_c))
    got = jax.jit(s._predict)(st)
    for name, a, b in zip(("c", "vx", "vy", "vz", "divv"), got,
                          (c, vx, vy, vz, divv)):
        _close(a, b, name)


@pytest.mark.parametrize("variant", ["gpu", "multi"])
@pytest.mark.parametrize("nx", [17, 24])
def test_corrector_chain_matches_oracle(nx, variant):
    s, g, f = _setup(variant, nx, seed=12)
    phys = s.cfg.physics
    vx, vy, vz = orc.correct_v(f["vx"], f["vy"], f["vz"], f["pr"], g.dt,
                               phys.rho, g.dx, g.dy, g.dz)
    c, vx, vy, vz = _cylinder(s, g, f["c"], vx, vy, vz)
    if variant == "gpu":
        vx, vy, vz = orc.set_bc_vel_gpu(vx, vy, vz)
    else:
        vx, vy, vz = orc.set_bc_vel_multi(vx, vy, vz, phys.vin,
                                          compat=False)
    got = jax.jit(s._correct)(*(jnp.asarray(f[k])
                                for k in ("c", "vx", "vy", "vz", "pr")))
    for name, a, b in zip(("c", "vx", "vy", "vz"), got, (c, vx, vy, vz)):
        _close(a, b, name)

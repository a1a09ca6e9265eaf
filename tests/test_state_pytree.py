"""The state records (FlowState, StepStats, DistState) are frozen
dataclasses registered as JAX pytrees (state.pytree_dataclass): every
field is a child, a None field is an empty subtree, and `.replace`
returns a new record."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.parallel.fullstep import DistState
from navierstokes3d_tpu.state import FlowState, StepStats


def _state(with_lo=False):
    z = lambda *s: jnp.zeros(s, jnp.float32)
    return FlowState(pr=z(3, 2, 2), vx=z(4, 2, 2), vy=z(3, 3, 2),
                     vz=z(3, 2, 3), c=z(3, 2, 2), dprdtau=z(3, 2, 2),
                     pr_lo=z(3, 2, 2) if with_lo else None)


@pytest.mark.parametrize("with_lo,n", [(False, 6), (True, 7)])
def test_flatten_roundtrip(with_lo, n):
    st = _state(with_lo)
    leaves, tree = jax.tree_util.tree_flatten(st)
    assert len(leaves) == n
    back = jax.tree_util.tree_unflatten(tree, leaves)
    assert isinstance(back, FlowState)
    assert (back.pr_lo is None) == (not with_lo)


def test_replace_is_functional_and_frozen():
    st = _state()
    st2 = st.replace(pr=st.pr + 1)
    assert float(st.pr.sum()) == 0.0 and float(st2.pr.sum()) == 12.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.pr = st2.pr
    stats = StepStats(iters=jnp.int32(3), err=jnp.float32(0.5),
                      err_hist=jnp.zeros(2))
    assert stats.replace(pr_lo=None).iters == 3
    assert stats.advect_clamped is None and stats.iters_ext is None


def test_tree_map_and_jit_donation():
    st = _state(True)
    f = jax.jit(lambda s: jax.tree.map(lambda a: a + 1, s), donate_argnums=0)
    out = f(st)
    assert isinstance(out, FlowState)
    assert float(out.pr_lo.sum()) == 12.0
    assert st.pr.is_deleted()  # the donated input buffers were consumed


def test_dist_state_is_a_pytree():
    z = jnp.zeros((2, 2, 2))
    p = jnp.zeros((2, 2))
    d = DistState(pr=z, vx=z, vy=z, vz=z, c=z, dprdtau=z, vx_hi=p,
                  vy_hi=p, vz_hi=p)
    assert len(jax.tree_util.tree_leaves(d)) == 9
    assert d.replace(vx_hi=p + 1).vx_hi.sum() == 4


def test_solver_step_carries_pair_through_jit():
    """step_jit (donating) returns a FlowState whose pr_lo appears after
    the first f32 step and survives a second step."""
    s = ns.ChorinSolver(ns.preset_multi(nx=9, nt=2, compat=False,
                                        dtype="float32"))
    st = s.init_state()
    assert st.pr_lo is None
    st, _ = s.step_jit(st)
    assert st.pr_lo is not None and st.pr_lo.dtype == jnp.float32
    st, stats = s.step_jit(st)
    assert np.isfinite(float(stats.err))

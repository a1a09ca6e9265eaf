"""Unit tests for the chunked convergence loops (ptloop.py), focused on
the flat loop's exit/tail semantics — the reference control flow is
`for iter=1:niter ... break on err<eps at every nchk-th iteration, then
a trailing partial chunk` (NavierStokes3D_gpu.jl:126-137). The post-loop
rem/tail_fn path (added for bodies that advance >1 iteration) must
reproduce the in-loop trailing chunk exactly.
"""

import jax.numpy as jnp
import numpy as np

from navierstokes3d_tpu.ptloop import pt_loop_fused

DT = jnp.float32


def geometric_step(rate=0.9):
    """Carry is a scalar 'residual' x; one iteration multiplies by rate.
    The emitted err is the value ENTERING the iteration performed (the
    kernel-emitted definition)."""
    def step_fn(carry, it):
        return carry * rate, carry, jnp.int32(1)
    return step_fn


def test_converges_before_budget():
    nchk, nchunks = 4, 10
    x0 = jnp.asarray(1.0, DT)
    carry, it, err, hist = pt_loop_fused(
        geometric_step(0.5), x0, 0, nchunks * nchk, nchk, nchunks,
        eps_it=1e-3, dtype=DT)
    # err at check k is x entering iteration k*nchk = 0.5^(k*nchk - 1);
    # < 1e-3 first at k=3 (0.5^11 = 4.9e-4) -> exits at 12 iterations
    assert int(it) == 12
    np.testing.assert_allclose(float(err), 0.5 ** 11, rtol=1e-6)
    # no tail machinery involved
    np.testing.assert_allclose(float(carry), 0.5 ** 12, rtol=1e-6)


def test_tail_runs_on_budget_exhaustion():
    """Unconverged: the loop runs its checked budget, then the tail_fn
    advances the trailing partial chunk and iters reflects it."""
    nchk, nchunks, rem = 4, 3, 3
    x0 = jnp.asarray(1.0, DT)

    def tail(c):
        return c * (0.99 ** rem)

    carry, it, err, hist = pt_loop_fused(
        geometric_step(0.99), x0, 0, nchunks * nchk, nchk, nchunks,
        eps_it=1e-8, dtype=DT, rem=rem, tail_fn=tail)
    assert int(it) == nchunks * nchk + rem
    np.testing.assert_allclose(float(carry), 0.99 ** (nchunks * nchk + rem),
                               rtol=1e-5)


def test_tail_skipped_when_converged():
    nchk, nchunks, rem = 4, 3, 3
    x0 = jnp.asarray(1.0, DT)
    called = {"tail": False}

    def tail(c):
        # traced under lax.cond either way; the semantics we check is the
        # RESULT: carry must not include the tail factor
        return c * jnp.asarray(1000.0, DT)

    carry, it, err, hist = pt_loop_fused(
        geometric_step(0.1), x0, 0, nchunks * nchk, nchk, nchunks,
        eps_it=1e-2, dtype=DT, rem=rem, tail_fn=tail)
    # converges at the first check (0.1^3 = 1e-3 < 1e-2) -> 4 iterations
    assert int(it) == 4
    assert float(carry) < 1.0  # tail's x1000 not applied


def test_tail_matches_in_loop_rem():
    """The tail formulation (budget = nchunks*nchk, rem via tail_fn)
    must be iteration-for-iteration identical to the legacy in-loop
    formulation (budget = nchunks*nchk + rem, checks gated to the first
    nchunks boundaries) for an unconverged run."""
    nchk, nchunks, rem = 4, 3, 2
    x0 = jnp.asarray(1.0, DT)
    rate = 0.97

    c1, it1, err1, hist1 = pt_loop_fused(
        geometric_step(rate), x0, 0, nchunks * nchk + rem, nchk, nchunks,
        eps_it=1e-8, dtype=DT)
    c2, it2, err2, hist2 = pt_loop_fused(
        geometric_step(rate), x0, 0, nchunks * nchk, nchk, nchunks,
        eps_it=1e-8, dtype=DT, rem=rem,
        tail_fn=lambda c: c * jnp.asarray(rate, DT) ** rem)
    assert int(it1) == int(it2)
    np.testing.assert_allclose(float(c1), float(c2), rtol=1e-6)
    assert float(err1) == float(err2)
    np.testing.assert_array_equal(np.asarray(hist1), np.asarray(hist2))


def test_stall_exit_skips_tail():
    """A stalled run (flat residual) must exit early AND skip the tail
    (iterating at the noise floor buys nothing — same as pt_loop)."""
    nchk, nchunks, rem = 2, 50, 2
    x0 = jnp.asarray(1.0, DT)

    def flat_step(carry, it):
        return carry, carry, jnp.int32(1)   # residual never improves

    carry, it, err, hist = pt_loop_fused(
        flat_step, x0, 0, nchunks * nchk, nchk, nchunks,
        eps_it=1e-8, dtype=DT, stall=(0.95, 3), rem=rem,
        tail_fn=lambda c: c * jnp.asarray(0.0, DT))
    assert int(it) < nchunks * nchk          # stalled out early
    assert float(carry) == 1.0               # tail (x0.0) skipped

"""Chunked pseudo-transient convergence loop (shared by every PT backend).

Replicates the reference's `for iter=1:niter ... break` control flow
(NavierStokes3D_gpu.jl:126-137) as one lax.while_loop: run chunks of nchk
iterations, check the residual after each chunk, stop on convergence
(err < eps_it), non-finite error, or chunk budget; if never converged, run
the trailing niter % nchk iterations unchecked (the reference's final
partial chunk).

Optional stall exit (no reference analog; see NumericsConfig.stall_exit):
stop when the residual improved by less than ratio**window over the last
`window` residual checks — the iteration has hit its noise floor and the
remaining budget is pure waste. The window (rather than per-chunk
comparison) separates floor noise (per-chunk ratios fluctuating around
1.0 with dips to ~0.8) from genuinely slow asymptotic convergence
(steady 0.89-0.94 per chunk).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax.numpy as jnp
from jax import lax


def pt_loop_fused(step_fn: Callable, carry, it0: int, niter: int,
                  nchk: int, nchunks: int, eps_it: float, dtype,
                  stall: Optional[Tuple[float, int]] = None,
                  err0=None, rem: int = 0, tail_fn: Callable = None):
    """Flat single-level while_loop over ITERATIONS, for backends whose
    iteration emits its own residual max.

    step_fn(carry, it) -> (carry, err_raw, nadv): advance nadv iterations
    (1 for plain backends; the halo-batched path advances k per exchange,
    breaking batches at chunk boundaries so checks stay aligned), with
    err_raw the masked max|lap(p) - rhs| of the state ENTERING the last
    iteration performed (the quantity the damped update already computes
    — so convergence checks cost nothing). In a sharded context step_fn
    must all-reduce err_raw (pmax) so the loop condition is replicated.

    Why flat: one sweep per while-loop body, with only scalar/small
    carries beside the field carries, keeps the convergence check free
    (the sweep already computes the residual) and avoids a nested
    chunk loop whose carries the compiler may copy per iteration. On a
    GPU each body is a few loop fusions, and the loop predicate is
    evaluated every sweep (PERF.md records what that costs).

    Convergence semantics (vs pt_loop): the k-th check value is the
    residual of the state entering iteration k*nchk — one iteration
    staler than pt_loop's post-chunk evaluation. Exit decisions still
    happen only at chunk boundaries (err only changes there); past the
    last full chunk the remaining niter budget runs unchecked (the
    reference's trailing partial chunk, NavierStokes3D_gpu.jl:126-137).
    All fused backends share this definition so cross-backend
    iteration-count equality holds.

    it0: iterations already performed outside the loop (the folded
    protocol's exact first iteration). err0: initial err (default: a
    sentinel that cannot trigger the eps exit) — pass the caller's
    already-known residual to make the loop a no-op when it is below
    eps_it, instead of wrapping the loop in lax.cond around it.
    Returns (carry, iters, err, hist).
    """
    big = jnp.asarray(1e30, dtype)
    stall_on = stall is not None
    ratio, window = stall if stall_on else (0.0, 1)
    window = max(int(window), 1)
    thresh = ratio ** window
    nhist = max(nchunks, 1)
    n_checked = nchunks * nchk

    def stalled_of(err, errbuf):
        return (err > thresh * errbuf[0]) & (errbuf[0] < big)

    def cond(st):
        _, it, err, _, errbuf = st
        ok = (it < niter) & (err >= eps_it) & jnp.isfinite(err)
        if stall_on:
            ok = ok & jnp.logical_not(stalled_of(err, errbuf))
        return ok

    def body(st):
        carry, it, err, hist, errbuf = st
        carry, e, nadv = step_fn(carry, it)
        it = it + nadv
        at_chk = ((it % nchk) == 0) & (it <= n_checked)
        k = jnp.clip(it // nchk - 1, 0, nhist - 1)
        err = jnp.where(at_chk, e.astype(dtype), err)
        hist = hist.at[k].set(jnp.where(at_chk, e.astype(hist.dtype),
                                        hist[k]))
        errbuf = jnp.where(at_chk,
                           jnp.concatenate([errbuf[1:],
                                            e.astype(dtype)[None]]),
                           errbuf)
        return carry, it, err, hist, errbuf

    hist0 = jnp.full((nhist,), jnp.nan, dtype)
    errbuf0 = jnp.full((window + 1,), big, dtype)
    e0 = big if err0 is None else jnp.asarray(err0, dtype).reshape(())
    carry, it, err, hist, errbuf = lax.while_loop(
        cond, body, (carry, jnp.int32(it0), e0, hist0, errbuf0))
    if rem > 0 and tail_fn is not None:
        # the reference's trailing partial chunk, hoisted OUT of the flat
        # loop (so `niter` can stay a multiple of the body advance):
        # runs only on budget exhaustion without convergence or stall —
        # the same do_tail predicate as pt_loop. The lax.cond wraps a
        # post-loop region, not the hot loop body.
        do_tail = (it >= niter) & (err >= eps_it) & jnp.isfinite(err)
        if stall_on:
            do_tail = do_tail & jnp.logical_not(stalled_of(err, errbuf))
        carry = lax.cond(do_tail, tail_fn, lambda c: c, carry)
        it = it + jnp.where(do_tail, jnp.int32(rem), 0)
    return carry, it, err, hist


def pt_loop(run_iters: Callable, residual_err: Callable, pr, dpr,
            nchunks: int, nchk: int, rem: int, eps_it: float, dtype,
            stall: Optional[Tuple[float, int]] = None):
    """run_iters(pr, dpr, n, k) -> (pr, dpr): n iterations (k = chunk index,
    so a backend may treat the first chunk specially); residual_err(pr) ->
    scalar err (including any cross-device reduction). stall is
    (ratio, window) or None: exit when err > ratio**window * err_from_
    `window`_checks_ago. Returns (pr, dpr, iters, err, hist)."""
    big = jnp.asarray(1e30, dtype)
    stall_on = stall is not None
    ratio, window = stall if stall_on else (0.0, 1)
    window = max(int(window), 1)
    thresh = ratio ** window

    def stalled_of(err, errbuf):
        # errbuf[0] is the err from `window` checks ago; it starts at
        # `big`, so the first `window` checks can never trip the exit
        return (err > thresh * errbuf[0]) & (errbuf[0] < big)

    def cond(st):
        _, _, k, err, _, errbuf = st
        ok = (k < nchunks) & (err >= eps_it) & jnp.isfinite(err)
        if stall_on:
            ok = ok & jnp.logical_not(stalled_of(err, errbuf))
        return ok

    def body(st):
        pr, dpr, k, err, hist, errbuf = st
        pr, dpr = run_iters(pr, dpr, nchk, k)
        new_err = residual_err(pr)
        hist = hist.at[k].set(new_err)
        errbuf = jnp.concatenate([errbuf[1:], new_err[None]])
        return (pr, dpr, k + 1, new_err, hist, errbuf)

    hist0 = jnp.full((max(nchunks, 1),), jnp.nan, dtype)
    # errbuf holds the last window+1 check values (bigs until enough
    # checks have run): errbuf[-1] == the carried err, errbuf[0] == the
    # err from exactly `window` intervals earlier (matching ratio**window)
    errbuf0 = jnp.full((window + 1,), big, dtype)
    pr, dpr, k, err, hist, errbuf = lax.while_loop(
        cond, body, (pr, dpr, jnp.int32(0), big, hist0, errbuf0))
    iters = k * nchk
    stalled = stalled_of(err, errbuf) if stall_on else jnp.bool_(False)
    if rem > 0:
        # The reference's trailing partial chunk runs only if the loop
        # reached niter without converging (gpu.jl:126-137); a stall exit
        # also skips it (iterating at the noise floor buys nothing).
        do_tail = (k >= nchunks) & (err >= eps_it) & jnp.isfinite(err)
        if stall_on:
            do_tail = do_tail & jnp.logical_not(stalled)
        pr, dpr = lax.cond(
            do_tail,
            lambda c: run_iters(*c, rem, k),
            lambda c: c,
            (pr, dpr))
        iters = iters + jnp.where(do_tail, rem, 0)
    return pr, dpr, iters, err, hist

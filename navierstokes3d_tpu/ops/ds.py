"""Double-single (float32 hi/lo pair) building blocks.

Error-free transformations used by the f32 accuracy machinery: the
extended Poisson iterate, the compensated residual evaluations, and the
RHS pair. All run in pure float32 (no f64 ops).

References: Knuth two_sum; Dekker/Veltkamp product splitting.
The reference solves everything in Float64 (NavierStokes3D_gpu.jl) and
needs none of this; these transformations are what lets a float32 solve
meet the reference's Float64-evaluated convergence criterion. Whether a
float64 residual on the GPU can replace them is ROADMAP design item 2.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Veltkamp split factor for float32 (2^12 + 1)
_SPLIT = np.float32(4097.0)


def two_sum(a, b):
    """s = fl(a + b), e with a + b = s + e exactly (branch-free Knuth)."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def split(a):
    """Veltkamp split: a = hi + lo with hi, lo representable in 12 bits
    (so hi*hi products are exact in f32)."""
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p = fl(a * b), e with a * b = p + e exactly (Dekker, no FMA)."""
    p = a * b
    a1, a2 = split(a)
    b1, b2 = split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def const_pair(c64):
    """Round a float64 scalar/array to an f32 (hi, lo) pair."""
    hi = np.float32(c64) if np.isscalar(c64) else np.asarray(
        c64, np.float64).astype(np.float32)
    lo = np.asarray(np.asarray(c64, np.float64)
                    - np.asarray(hi, np.float64)).astype(np.float32)
    if np.isscalar(c64):
        return np.float32(hi), np.float32(lo)
    return hi, lo


def rhs_pair(divv, c64, z_hoist64=None, axis=-1):
    """(hi, lo) pair for the Poisson RHS  c * divv  -  z_hoist.

    hi is BIT-IDENTICAL to the plain f32 computation the hot loops use
    (`(c) * divv - f32(z_hoist)` with c weakly typed), so the iteration
    trajectory is unchanged; lo carries that computation's first-order
    rounding error, which the compensated residual evaluations subtract.
    Without it the f32 rounding of the RHS alone contributes
    ~eps32*|rhs| of irreducible residual (~7e-4 err units at the 255
    showcase grid — most of the 1e-3 criterion)."""
    c_hi, c_lo = const_pair(float(c64))
    t, e = two_prod(divv, c_hi)
    e = e + divv * c_lo
    if z_hoist64 is None:
        return t, e
    zh_hi, zh_lo = const_pair(np.asarray(z_hoist64, np.float64))
    shape = [1] * divv.ndim
    shape[axis] = -1
    zh_hi = jnp.asarray(zh_hi).reshape(shape)
    zh_lo = jnp.asarray(zh_lo).reshape(shape)
    s, e2 = two_sum(t, -zh_hi)
    return s, (e + e2) - zh_lo


def weight_quad(w64):
    """f64 stencil weight -> (w_hi, w_lo, w1, w2) f32 quad: w_hi + w_lo
    ~ w64, (w1, w2) the precomputed Veltkamp split of w_hi (Dekker needs
    both factors split; the weight's split is loop-invariant)."""
    w64 = np.asarray(w64, np.float64)
    w_hi = w64.astype(np.float32)
    w_lo = (w64 - w_hi).astype(np.float32)
    t = w_hi * _SPLIT
    w1 = t - (t - w_hi)
    w2 = w_hi - w1
    return w_hi, w_lo, w1, w2


def weighted_term(dh, dl, quad):
    """(dh + dl) * w64 as a (prod, err) pair, first order in dl:
    Dekker product of dh against the precomputed weight quad, with
    dh*w_lo and dl*w_hi folded into the error word."""
    w_hi, w_lo, w1, w2 = quad
    a1, a2 = split(dh)
    p = dh * w_hi
    e = ((a1 * w1 - p) + a1 * w2 + a2 * w1) + a2 * w2
    return p, e + (dh * w_lo + dl * w_hi)


def accumulate(pairs):
    """Compensated sum of (value, err) pairs -> (sum, residual err)."""
    s, c = pairs[0]
    for p_i, e_i in pairs[1:]:
        s, t = two_sum(s, p_i)
        c = c + (t + e_i)
    return s, c

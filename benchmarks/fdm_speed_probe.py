"""Probe: fdm transform speed at the showcase grid.

The six modal transforms at (253,151,151) f32 move ~276 MB per solve.
This probe times, in ONE process with chained inputs (each call sees a
new input buffer):

  (a) the shipped to_modal/from_modal einsum chain (HIGHEST)
  (b) explicit transpose+reshape-to-2D-matmul forms of the same passes
  (c) the same chain at default precision (TF32 on a Hopper GPU) —
      speed reference only, accuracy is known-insufficient (see
      ops/fdm_poisson.py)
  (d) a full _poisson_solve_fdm call and a full fdm-backend step_jit

Run:  python benchmarks/fdm_speed_probe.py [--nx 255] [--reps 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.ops.fdm_poisson import _axis_eigs


def log(m):
    print(m, file=sys.stderr, flush=True)


def timed_chain(fn, x0, reps, name):
    """Time fn by chaining: x = normalize(fn(x)). Each dispatch sees a new
    input buffer."""
    x = x0
    x = fn(x)  # warmup/compile
    jax.block_until_ready(x)
    t0 = time.time()
    for _ in range(reps):
        x = fn(x)
    jax.block_until_ready(x)
    dt = (time.time() - t0) / reps
    log(f"{name}: {dt*1e3:.3f} ms/call")
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=255)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    cfg = ns.preset_gpu(nx=args.nx, nt=4, compat=False, dtype="float32")
    solver = ns.ChorinSolver(cfg)
    g = solver.grid
    log(f"grid {g.nx}x{g.ny}x{g.nz} device={jax.devices()[0].device_kind}")

    (lx, qx), (ly, qy), (lz, qz) = _axis_eigs(g, "gpu")
    lam = (lx[:, None, None] + ly[None, :, None] + lz[None, None, :])
    inv_lam = np.asarray(1.0 / lam, np.float32)
    qx32, qy32, qz32 = (np.asarray(q, np.float32) for q in (qx, qy, qz))
    mi, mj, mk = qx32.shape[0], qy32.shape[0], qz32.shape[0]
    log(f"interior {mi}x{mj}x{mk}")

    rng = np.random.default_rng(0)
    f0 = jnp.asarray(rng.standard_normal((mi, mj, mk)), jnp.float32)

    def chain_einsum(prec):
        def solve(f):
            t = jnp.einsum("ia,ajk->ijk", qx32.T, f, precision=prec,
                           preferred_element_type=jnp.float32)
            t = jnp.einsum("jb,ibk->ijk", qy32.T, t, precision=prec,
                           preferred_element_type=jnp.float32)
            t = jnp.einsum("kc,ijc->ijk", qz32.T, t, precision=prec,
                           preferred_element_type=jnp.float32)
            t = t * inv_lam
            p = jnp.einsum("ai,ijk->ajk", qx32, t, precision=prec,
                           preferred_element_type=jnp.float32)
            p = jnp.einsum("jb,ibk->ijk", qy32, p, precision=prec,
                           preferred_element_type=jnp.float32)
            p = jnp.einsum("kc,ijc->ijk", qz32, p, precision=prec,
                           preferred_element_type=jnp.float32)
            # normalize so the chain stays O(1)
            return p / jnp.maximum(jnp.max(jnp.abs(p)), 1e-30)
        return jax.jit(solve)

    def chain_matmul(prec):
        """Same math, every pass a single 2D matmul on a reshaped view.
        Axis order rotates x->y->z so the contracted axis is always
        leading; one final transpose restores (i,j,k)."""
        def mm(q, a2):
            return jnp.matmul(q, a2, precision=prec,
                              preferred_element_type=jnp.float32)

        def apply3(f, qxm, qym, qzm):
            # f (i,j,k): contract i
            t = mm(qxm, f.reshape(f.shape[0], -1))
            t = t.reshape(qxm.shape[0], mj, mk)
            # rotate to (j,k,i), contract j
            t = jnp.transpose(t, (1, 2, 0))
            t = mm(qym, t.reshape(mj, -1)).reshape(qym.shape[0], mk, -1)
            # rotate to (k,i,j) -> contract k
            t = jnp.transpose(t, (1, 2, 0))
            t = mm(qzm, t.reshape(mk, -1)).reshape(qzm.shape[0], -1, mj)
            # now (k,i,j) -> back to (i,j,k)
            return jnp.transpose(t, (1, 2, 0))

        def solve(f):
            t = apply3(f, qx32.T, qy32.T, qz32.T)
            t = t * inv_lam
            p = apply3(t, qx32, qy32, qz32)
            return p / jnp.maximum(jnp.max(jnp.abs(p)), 1e-30)
        return jax.jit(solve)

    H = jax.lax.Precision.HIGHEST
    D = jax.lax.Precision.DEFAULT
    # correctness cross-check of the matmul form
    a = np.asarray(chain_einsum(H)(f0))
    b = np.asarray(chain_matmul(H)(f0))
    log(f"matmul-form vs einsum-form max diff: {np.abs(a-b).max():.3e}")

    timed_chain(chain_einsum(H), f0, args.reps, "(a) einsum HIGHEST")
    timed_chain(chain_matmul(H), f0, args.reps, "(b) matmul HIGHEST")
    timed_chain(chain_einsum(D), f0, args.reps, "(c) einsum DEFAULT")
    timed_chain(chain_matmul(D), f0, args.reps, "(c') matmul DEFAULT")

    # (d) the shipped solver path end-to-end
    import dataclasses
    cfg_f = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, poisson_backend="fdm"))
    sf = ns.ChorinSolver(cfg_f)
    st = sf.init_state()
    t0 = time.time()
    st, stats = sf.step_jit(st)
    jax.block_until_ready(st.pr)
    log(f"(d) fdm step warmup (compile+host-eig): {time.time()-t0:.1f}s "
        f"rounds={int(stats.iters)} err={float(stats.err):.3e}")
    per = []
    for i in range(args.reps):
        t0 = time.time()
        st, stats = sf.step_jit(st)
        jax.block_until_ready(st.pr)
        per.append(time.time() - t0)
        log(f"(d) fdm step {i}: {per[-1]*1e3:.1f} ms rounds="
            f"{int(stats.iters)} err={float(stats.err):.3e}")
    log(f"(d) fdm step median: {np.median(per)*1e3:.1f} ms")


if __name__ == "__main__":
    main()

"""Two-process jax.distributed smoke run — the testable core of a
multi-host launch (the analog of the reference's SLURM launch,
scripts/runme3D.sh:1-18, where every rank runs the same program).

Each process: initialize the distributed runtime, force the CPU backend
with N virtual local devices, build the global mesh, jit-init the sharded
state ON the mesh (no host-side scatter — computation-produced arrays are
born distributed), run one full step through the global-view sharded
path, and check the replicated stats agree.

Run (every process executes the same command):
  python launch/multihost_smoke.py --coord localhost:9876 --nproc 2 --pid 0
  python launch/multihost_smoke.py --coord localhost:9876 --nproc 2 --pid 1
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coord", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--nx", type=int, default=16)
    args = ap.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
                    f"{args.local_devices}").strip()

    import jax
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # older/newer jax: cross-process CPU collectives default
    jax.distributed.initialize(coordinator_address=args.coord,
                               num_processes=args.nproc,
                               process_id=args.pid)

    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.parallel import make_mesh
    from navierstokes3d_tpu.parallel.mesh import state_shardings

    n_global = len(jax.devices())
    assert n_global == args.nproc * args.local_devices, (
        n_global, args.nproc, args.local_devices)
    mesh = make_mesh()  # all global devices, near-cubic factorization
    cfg = ns.preset_multi(nx=args.nx, nt=1, compat=False, dtype="float32")
    cfg = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                   niter_scale=2))
    solver = ns.ChorinSolver(cfg)
    sh = state_shardings(mesh, solver.grid.shape_c)
    # jit-init with out_shardings: every process computes only its
    # addressable shards; nothing is scattered from any single host
    state = jax.jit(solver.init_state, out_shardings=sh)()
    step = solver.step_sharded_jit(mesh)
    state, stats = step(state)
    jax.block_until_ready(state.pr)
    iters, err = int(stats.iters), float(stats.err)
    assert iters > 0
    print(f"proc {args.pid}/{args.nproc}: global_devices={n_global} "
          f"mesh={dict(zip(mesh.axis_names, mesh.devices.shape))} "
          f"iters={iters} err={err:.3e}", flush=True)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

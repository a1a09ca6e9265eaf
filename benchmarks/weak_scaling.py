"""Weak-scaling harness: fixed per-device block, growing mesh.

The reference's scaling dimension is grid volume over ranks with constant
per-rank size (SURVEY.md §5, "long-context analog"). This harness measures
time/step and Poisson iters/s for a per-device block of
(bx, by, bz) across mesh shapes, reporting efficiency relative to the
single-device run.

On a multi-GPU host this measures weak-scaling efficiency; on a CPU
host it validates the harness with virtual CPU devices (pass --platform cpu with XLA_FLAGS=--xla_force_host_platform_device_count=N).

Usage:
  python benchmarks/weak_scaling.py --block 64 --meshes 1x1x1,2x1x1,2x2x1,2x2x2 \
      [--platform cpu] [--poisson-only]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=64,
                    help="per-device cells along x (y/z scaled by 0.6)")
    ap.add_argument("--meshes", default="1x1x1,2x1x1,2x2x1,2x2x2")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--halo-width", type=int, default=1)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--mode", choices=("shard_map", "global"),
                    default="shard_map")
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import math
    import numpy as np
    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.config import ParallelConfig
    from navierstokes3d_tpu.parallel import make_mesh, shard_state

    results = []
    base_rate = None
    for mesh_str in args.meshes.split(","):
        shape = tuple(int(p) for p in mesh_str.strip().split("x"))
        ndev = math.prod(shape)
        if ndev > len(jax.devices()):
            print(f"skip {mesh_str}: needs {ndev} devices", file=sys.stderr)
            continue
        # constant per-device block on every axis: global grid =
        # (bx px, by py, bz pz) with by = bz = ceil(0.6 bx) (the
        # reference aspect at the block level)
        import dataclasses as _dc
        bx = args.block
        byz = math.ceil(0.6 * bx)
        nx, ny, nz = bx * shape[0], byz * shape[1], byz * shape[2]
        cfg = ns.preset_multi(nx=nx, nt=1, compat=False, dtype=args.dtype)
        cfg = cfg.replace(numerics=_dc.replace(
            cfg.numerics, ny_override=ny, nz_override=nz))
        cfg = cfg.replace(parallel=ParallelConfig(
            mesh_shape=shape, halo=args.halo_width))
        solver = ns.ChorinSolver(cfg)
        mesh = make_mesh(shape=shape, devices=jax.devices()[:ndev])
        step = (solver.step_shard_map_jit(mesh) if args.mode == "shard_map"
                else solver.step_sharded_jit(mesh))
        state = shard_state(solver.init_state(), mesh)
        state, _ = step(state)  # warmup/compile
        jax.block_until_ready(state.pr)
        t0, iters = time.time(), 0
        for _ in range(args.steps):
            state, stats = step(state)
            jax.block_until_ready(state.pr)
            iters += int(stats.iters)
        wall = time.time() - t0
        rate = iters / wall
        cells = nx * ny * nz
        per_dev_rate = rate * cells / ndev  # cell-iters/s per device
        if base_rate is None:
            base_rate = per_dev_rate
        eff = per_dev_rate / base_rate
        rec = dict(device=jax.devices()[0].device_kind,
                   mesh=mesh_str, devices=ndev, grid=f"{nx}x{ny}x{nz}",
                   iters_per_sec=round(rate, 1),
                   cell_iters_per_sec_per_device=round(per_dev_rate, 0),
                   weak_scaling_efficiency=round(eff, 4),
                   time_per_step_s=round(wall / args.steps, 4))
        results.append(rec)
        print(json.dumps(rec), file=sys.stderr)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()

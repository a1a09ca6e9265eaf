"""Communication accounting for the distributed Poisson solve.

Real weak-scaling efficiency needs a real pod; what CAN be measured on a
single host is the communication structure the compiler actually emits:
how many collective-permutes (halo exchanges) and all-reduces (residual
max) each Poisson iteration performs, and how many bytes they move, as a
function of mesh shape and halo batching width. These counts are exact
(read from the compiled HLO while-loop body).

Usage (8 virtual devices):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/comm_accounting.py
"""

from __future__ import annotations

import json
import math
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def count_collectives(hlo: str):
    """(n_collective_permute, n_all_reduce, permute_bytes) over the HLO
    module text. Bytes are summed from each collective-permute's result
    shape (e.g. f32[1,8,8]{...})."""
    n_cp = len(re.findall(r"collective-permute(?:-start)?\(", hlo))
    n_ar = len(re.findall(r"all-reduce(?:-start)?\(", hlo))
    nbytes = 0
    for line in hlo.splitlines():
        if "collective-permute(" not in line and \
                "collective-permute-start(" not in line:
            continue
        m = re.search(r"(f32|f64|bf16)\[([\d,]*)\]", line)
        if not m:
            continue
        dt, dims = m.groups()
        size = math.prod(int(d) for d in dims.split(",") if d) if dims else 1
        nbytes += size * {"f32": 4, "f64": 8, "bf16": 2}[dt]
    return n_cp, n_ar, nbytes


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import dataclasses
    import jax.numpy as jnp
    import numpy as np
    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.parallel import make_mesh
    from navierstokes3d_tpu.parallel.halo import build_poisson_shard_map

    ndev = len(jax.devices())
    results = []
    cases = [
        # (mesh shape, halo width k)
        ((2, 2, 2), 1),
        ((2, 2, 2), 2),
        ((2, 2, 2), 4),
        ((8, 1, 1), 1),
        ((4, 1, 1), 1),
        ((2, 2, 1), 1),
    ]
    for shape, k in cases:
        n = math.prod(shape)
        if n > ndev:
            continue
        bx = byz = 16  # per-device block
        nx, ny, nz = bx * shape[0], byz * shape[1], byz * shape[2]
        cfg = ns.preset_multi(nx=nx, nt=1, compat=False, dtype="float32")
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, ny_override=ny, nz_override=nz))
        solver_grid = ns.ChorinSolver(cfg).grid
        mesh = make_mesh(shape=shape, devices=jax.devices()[:n])
        solve = build_poisson_shard_map(
            mesh, solver_grid, cfg.physics, cfg.numerics.eps_it, "multi",
            jnp.float32, halo_width=k)
        z = jnp.zeros((nx, ny, nz), jnp.float32)
        hlo = jax.jit(solve).lower(z, z, z).compile().as_text()
        # per-iteration counts: collectives inside the inner fori body
        # appear once in the unrolled-free HLO; normalize by halo batching
        n_cp, n_ar, nbytes = count_collectives(hlo)
        rec = dict(mesh="x".join(map(str, shape)), halo_width=k,
                   grid=f"{nx}x{ny}x{nz}",
                   collective_permutes_total=n_cp,
                   all_reduces_total=n_ar,
                   permute_bytes_total=nbytes,
                   note=("counts are static HLO instruction counts: the "
                         "iteration body's permutes execute every "
                         f"{'k=' + str(k) + ' iterations' if k > 1 else 'iteration'}, "
                         "the residual path every nchk iterations"))
        results.append(rec)
        print(json.dumps(rec), file=sys.stderr)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()

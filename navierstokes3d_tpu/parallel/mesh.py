"""Device mesh and sharding layout for spatial domain decomposition.

The reference decomposes the grid over MPI ranks via ImplicitGlobalGrid
(init_global_grid, NavierStokes3D_multi_gpu.jl:325) with explicit halo
exchanges. The analog used here has two tiers:

  1. Global-view path (this module): fields are global jax.Arrays laid out
     over a 3D jax.sharding.Mesh with axes ('x','y','z'); the solver's
     slicing stencils compile under jit and the XLA SPMD partitioner
     inserts the neighbor collective-permutes (the halo exchanges) and
     all-reduces (the residual max) automatically.
  2. Explicit shard_map paths (parallel/halo.py, parallel/fullstep.py):
     hand-scheduled ppermute halo exchanges and in-loop pmax reductions.

XLA hands the collectives to NCCL on GPUs. The cards of one host are
joined all to all by NVLink, so the mesh shape follows the algorithm
alone (no torus to match).

Both consume the same FlowState; a state can be resharded between them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import FlowState

AXES = ("x", "y", "z")


def choose_mesh_shape(n_devices: int, nx: Optional[int] = None,
                      min_bx: int = 8) -> Tuple[int, int, int]:
    """Factor n_devices into a mesh shape (px,py,pz).

    When the grid's streamwise extent nx is known, prefer the x-only
    shape (n,1,1): every exchange is then a contiguous (ny, nz) face
    plane between two neighbours, and run.py routes it to the explicit
    full-step schedule. Eligibility: nx must split evenly (shard_map
    requires equal blocks) with slabs of at least min_bx rows (thinner
    slabs leave the advection halos without interior backing). Which
    shape is fastest on four cards is not measured yet (ROADMAP design
    item 6).

    Without nx (or when x-only slabs would be too thin) fall back to the
    near-cubic factorization that minimizes halo surface per device,
    tie-breaking toward larger px (x has the most cells)."""
    if nx is not None and nx % n_devices == 0 and nx // n_devices >= min_bx:
        return (n_devices, 1, 1)
    best = (n_devices, 1, 1)
    best_score = None
    for px in range(1, n_devices + 1):
        if n_devices % px:
            continue
        rest = n_devices // px
        for py in range(1, rest + 1):
            if rest % py:
                continue
            pz = rest // py
            # prefer balanced shapes; tie-break toward larger px
            score = (max(px, py, pz) / min(px, py, pz), -px)
            if best_score is None or score < best_score:
                best, best_score = (px, py, pz), score
    return best


def make_mesh(shape: Optional[Tuple[int, int, int]] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = choose_mesh_shape(len(devices))
    if math.prod(shape) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, AXES)


def state_shardings(mesh: Mesh, shape_c) -> FlowState:
    """Sharding layout for the global-view path.

    Cell-centered fields shard over all three mesh axes. Staggered
    velocities have an (n+1)-sized dimension, which NamedSharding cannot
    split evenly; in this path each velocity shards over its two
    non-staggered axes and is replicated along its own staggered axis.
    The full-step explicit-comm path (parallel/fullstep.py) stores
    velocities in owned-face layout (n faces per shard + a 2D hi-face
    plane) and shards all three axes, so its memory truly scales 1/N.

    shape_c: the cell-centered grid shape (nx, ny, nz). JAX shards a
    dimension only when the mesh axis divides it, so a field stays
    replicated along every mesh axis that does not divide its dimension
    (unsharded_axes; run.py refuses a mesh on which that is every axis).
    """
    nx, ny, nz = shape_c

    def spec(names, shape):
        return NamedSharding(mesh, P(*(
            n if (n is None or shape[d] % mesh.shape[n] == 0) else None
            for d, n in enumerate(names))))

    cell = spec(AXES, (nx, ny, nz))
    return FlowState(pr=cell, c=cell, dprdtau=cell,
                     vx=spec((None, "y", "z"), (nx + 1, ny, nz)),
                     vy=spec(("x", None, "z"), (nx, ny + 1, nz)),
                     vz=spec(("x", "y", None), (nx, ny, nz + 1)))


def unsharded_axes(mesh: Mesh, shape_c) -> Tuple[str, ...]:
    """Mesh axes of size > 1 that do not divide the cell-centered grid
    dimension they would split (those fields stay replicated there)."""
    return tuple(a for a, n in zip(AXES, shape_c)
                 if mesh.shape[a] > 1 and n % mesh.shape[a])


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(state: FlowState, mesh: Mesh) -> FlowState:
    """Lay an (unsharded or differently-sharded) state out over the mesh."""
    sh = state_shardings(mesh, state.pr.shape)
    return jax.tree.map(jax.device_put, state, sh)

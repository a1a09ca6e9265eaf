"""Incompressible 3D Navier-Stokes framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
mattbuergler/NavierStokes3D (Julia + ParallelStencil + ImplicitGlobalGrid):
Chorin projection on a staggered MAC grid, damped pseudo-transient
pressure-Poisson iteration, semi-Lagrangian advection, immersed cylinder,
spatial domain decomposition over a 3D device mesh.
"""

from .compat_api import run_navierstokes3d, runme
from .config import (IOConfig, NumericsConfig, ParallelConfig, PhysicsConfig,
                     SimConfig, preset_gpu, preset_multi)
from .grid import Grid, make_grid
from .models.chorin import ChorinSolver, gather_inner
from .state import FlowState, StepStats

__version__ = "0.1.0"

__all__ = [
    "SimConfig", "PhysicsConfig", "NumericsConfig", "IOConfig",
    "ParallelConfig", "preset_gpu", "preset_multi",
    "Grid", "make_grid", "ChorinSolver", "gather_inner",
    "FlowState", "StepStats", "run_navierstokes3d", "runme",
]

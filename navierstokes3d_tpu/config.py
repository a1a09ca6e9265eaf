"""Configuration for the incompressible Navier-Stokes solver.

The reference (mattbuergler/NavierStokes3D) hardcodes all physics/numerics
constants inside its two driver scripts:
  - scripts/NavierStokes3D_gpu.jl:13-61        (single-GPU variant)
  - scripts/NavierStokes3D_multi_gpu.jl:288-341 (multi-GPU / MPI variant)

The two scripts diverged (forcing, BCs, cylinder position); here both live as
named presets of one config tree, and a single solver consumes them.

`compat=True` reproduces the reference's exact behavior including its known
quirks (documented in SURVEY.md §2.4):
  * advect! never advects Vz: the 3rd branch re-advects Vy with Vz-face
    velocities (scripts/NavierStokes3D_multi_gpu.jl:230-235).
  * multi-variant init writes the inflow velocity into Vy instead of Vx
    (scripts/NavierStokes3D_multi_gpu.jl:369).
  * gpu-variant cylinder mask computes yc with dx instead of dy
    (scripts/NavierStokes3D_gpu.jl:338).
`compat=False` fixes these (documented deltas) and is the default for new
work; the golden regression test runs with compat=True.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Physical constants. Reference: NavierStokes3D_multi_gpu.jl:288-319."""

    lx: float = 1.0          # streamwise domain size [m]
    rho: float = 1000.0      # density [kg/m^3]
    vin: float = 1.0         # inflow velocity [m/s]
    mu: float = 0.001        # dynamic viscosity [Pa s]
    re: float = 1e4          # Reynolds number (documentation only)
    fr: float = math.inf     # Froude number; g = vin^2/(Fr^2 lx)
    g_override: Optional[float] = None  # gpu script hardcodes g=9.81 (:38)
    ly_lx: float = 0.6       # lateral aspect ratio
    lz_lx: float = 0.6       # vertical aspect ratio
    a_lx: float = 0.05       # cylinder semi-axis (streamwise) / lx
    b_lx: float = 0.05       # cylinder semi-axis (lateral) / lx
    ox_lx: float = -0.4      # cylinder center x / lx (gpu script: -0.3)
    oy_lx: float = 0.0       # cylinder center y / lx
    beta: float = 0.0        # cylinder rotation about z [rad]

    @property
    def ly(self) -> float:
        return self.ly_lx * self.lx

    @property
    def lz(self) -> float:
        return self.lz_lx * self.lx

    @property
    def g(self) -> float:
        """Gravity: gpu script uses 9.81 (:38); multi derives from Fr (:316)."""
        if self.g_override is not None:
            return self.g_override
        if math.isinf(self.fr):
            return 0.0
        return (1.0 / self.fr**2) * self.vin**2 / self.lx

    @property
    def psc(self) -> float:
        """Pressure scale rho*vin^2 (NavierStokes3D_gpu.jl:21)."""
        return self.rho * self.vin**2

    @property
    def ox(self) -> float:
        return self.ox_lx * self.lx

    @property
    def oy(self) -> float:
        return self.oy_lx * self.lx

    @property
    def a2(self) -> float:
        return (self.a_lx * self.lx) ** 2

    @property
    def b2(self) -> float:
        return (self.b_lx * self.lx) ** 2


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """Discretization / iteration constants.

    Reference: NavierStokes3D_gpu.jl:43-61, NavierStokes3D_multi_gpu.jl:321-341.
    """

    nx: int = 255                   # global cells, streamwise
    eps_it: float = 1e-3            # Poisson convergence criterion
    niter_scale: int = 50           # niter = niter_scale * max(nx,ny,nz)
    cfl_tau: float = 1.0 / math.sqrt(3.1)   # pseudo-transient CFL
    cfl_visc: float = 1.0 / 4.1             # diffusion CFL
    cfl_adv: float = 1.0                    # advection CFL
    nt: int = 10
    dtype: str = "float64"          # reference runs Float64 throughout
    # Poisson backend: 'pt' = the reference's damped pseudo-transient
    # iteration (parity default); 'fdm' = exact fast-diagonalization
    # direct solve (tensor-product eigenbases, dense matmuls; a capability
    # beyond the reference — ops/fdm_poisson.py).
    poisson_backend: str = "pt"
    # 'fdm' backend: max compensated iterative-refinement rounds after
    # the direct solve (each ~12 dense transform passes; early exit on
    # err < eps_it). Rounds per step are reported as stats.iters; the
    # budget only bounds pathological states.
    fdm_refine: int = 8
    # Hydrostatic pressure split: the solver state stores
    # p' = Pr - P_static(z) with P_static the exact linear hydrostatic
    # profile (the gpu script's init/BC profile, gpu.jl:87,257-261). The
    # discrete Laplacian of a linear-in-z profile is identically zero and
    # the predictor's -rho*g body force cancels exactly against
    # d/dz P_static in the corrector, so the split is ALGEBRAICALLY
    # IDENTICAL to the reference formulation — but the stored field drops
    # from O(rho*g*lz)~6e3 to O(100), lowering the float32 stencil noise
    # floor of the residual metric by ~2 orders of magnitude (without it,
    # float32 runs of the gpu preset can never meet eps_it; docs/numerics.md).
    # None = auto: on for variant='gpu', compat=False, g!=0, 'pt' backend.
    pressure_split: Optional[bool] = None
    # Extended-precision Poisson iterate: carry the pressure as a
    # double-single (hi,lo) float32 pair through the solve. Rationale: the
    # residual metric of any plain-float32 field is floored at
    # ~eps32*max|Pr|*(6/h^2)*ly^2/psc (representation noise of the stored
    # field), which exceeds the reference's eps_it=1e-3 at 255-class grids
    # even after the hydrostatic split — so a float32 run can never "exit
    # converged" like the reference's Float64 run does (gpu.jl:6,135).
    # The pair carries ~48 bits: lap(hi)+lap(lo) cancels the representation
    # noise and the loop genuinely reaches eps_it, at ~2x cost/iteration
    # (a converged solve uses ~10-25% of the iteration budget, so the step
    # is still far cheaper than burning the full budget at the floor).
    # None = auto: on when pressure_split is active and dtype is float32.
    extended_precision: Optional[bool] = None
    # Accuracy phase of the folded float32 Poisson solve:
    #   'extended' — the (hi, lo) pair iterate from the first sweep,
    #                then a defect-correction finisher: the residual r0
    #                is evaluated ONCE with compensated arithmetic and
    #                lap(delta) = -r0 is solved with the plain loop
    #                (models/chorin._poisson_solve_jnp_folded).
    #   'none'     — the plain iterate only.
    # None = auto: 'extended' when extended_precision is on, else 'none'.
    accuracy: Optional[str] = None
    # Poisson stall exit: stop iterating when the residual improved by
    # less than stall_ratio**stall_checks over the last `stall_checks`
    # residual checks — the iterate has converged to its noise floor and
    # further iterations are pure waste (the reference burns its full
    # niter budget instead, gpu.jl:126-137). Windowed (not per-chunk)
    # because floor noise fluctuates around 1.0 per chunk with dips to
    # ~0.8, while genuinely-slow asymptotic convergence holds a steady
    # 0.89-0.94/chunk: over a 5-check window the floor improves < 0.82
    # while slow convergence achieves <= 0.94**5 = 0.73. None = auto: on
    # when compat=False.
    stall_exit: Optional[bool] = None
    stall_ratio: float = 0.96
    stall_checks: int = 5
    # Explicit overrides for ny/nz (e.g. weak-scaling grids); None derives
    # them from the aspect ratio as the reference does.
    ny_override: Optional[int] = None
    nz_override: Optional[int] = None

    # Derived sizes follow ceil(nx * aspect) (NavierStokes3D_gpu.jl:45-46).
    def ny(self, phys: PhysicsConfig) -> int:
        if self.ny_override is not None:
            return self.ny_override
        return math.ceil(self.nx * phys.ly_lx)

    def nz(self, phys: PhysicsConfig) -> int:
        if self.nz_override is not None:
            return self.nz_override
        return math.ceil(self.nx * phys.lz_lx)

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class IOConfig:
    """Output cadence (NavierStokes3D_gpu.jl:50-52)."""

    do_vis: bool = False
    do_save: bool = False
    do_print: bool = False
    nvis: int = 10
    nsave: int = 10
    out_dir: str = "out_save"
    viz_dir: str = "viz3D_out"


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device mesh layout for spatial domain decomposition.

    The reference decomposes via ImplicitGlobalGrid/MPI
    (NavierStokes3D_multi_gpu.jl:325); here the analog is a
    jax.sharding.Mesh with axes ('x','y','z') and XLA collectives (NCCL
    on GPUs).
    """

    mesh_shape: Tuple[int, int, int] = (1, 1, 1)
    # Halo width for batched Poisson iterations between exchanges
    # (generalizes the reference's unused b_width, multi_gpu.jl:326).
    halo: int = 1


@dataclasses.dataclass(frozen=True)
class SimConfig:
    physics: PhysicsConfig = dataclasses.field(default_factory=PhysicsConfig)
    numerics: NumericsConfig = dataclasses.field(default_factory=NumericsConfig)
    io: IOConfig = dataclasses.field(default_factory=IOConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    variant: str = "multi"   # 'multi' | 'gpu' — which reference script's BCs/init
    # Replicate reference quirks (SURVEY.md §2.4) on a single-rank run.
    # Scope: with >1 mesh device the reference's multi script computes
    # damp = 2/nx from the LOCAL nx (multi_gpu.jl:340) — i.e. its damping
    # depends on the process count; this framework always uses the global
    # nx (grid.py), so multi-rank compat trajectories match the reference's
    # 1-rank run, not its n-rank runs.
    compat: bool = False

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def preset_multi(nx: int = 63, nt: int = 1, *, compat: bool = True,
                 dtype: str = "float64", **kw) -> SimConfig:
    """The multi-GPU script's configuration (NavierStokes3D_multi_gpu.jl:287-341).

    Defaults match the committed test invocation: nx=63, Fr=Inf (g=0),
    cylinder at ox=-0.4 lx.
    """
    return SimConfig(
        physics=PhysicsConfig(ox_lx=-0.4, fr=math.inf),
        numerics=NumericsConfig(nx=nx, nt=nt, dtype=dtype),
        variant="multi",
        compat=compat,
        **kw,
    )


def preset_gpu(nx: int = 255, nt: int = 10000, *, compat: bool = True,
               dtype: str = "float64", **kw) -> SimConfig:
    """The single-GPU script's configuration (NavierStokes3D_gpu.jl:13-61).

    g=9.81 with hydrostatic pressure BCs (+100 Pa inlet head drives the flow,
    NavierStokes3D_gpu.jl:257-260); cylinder at ox=-0.3 lx.
    """
    return SimConfig(
        physics=PhysicsConfig(ox_lx=-0.3, g_override=9.81),
        numerics=NumericsConfig(nx=nx, nt=nt, dtype=dtype),
        variant="gpu",
        compat=compat,
        **kw,
    )

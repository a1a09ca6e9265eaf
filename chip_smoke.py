"""Smoke test of the solver on NVIDIA GPUs, through the user entry points.

    python chip_smoke.py               # one GPU: phases (a)-(d)
    python chip_smoke.py --four-cards  # four GPUs: the --mesh phase only

Run it from the repository root. Phases, each printing its numbers on
its own line:

  (a) the device: JAX must report platform 'gpu'; its kind and count,
      and the card's name and power limit from nvidia-smi.
  (b) `python -m navierstokes3d_tpu.run` end to end (run.main) at the
      reference's sizes: gpu-255 with the `pt` solve, gpu-255 with
      `fdm`, and multi-63. Every step must converge (err < eps_it and
      iters < niter), every field must be finite, and the stored
      (hi, lo) pressure pair must meet eps_it (the reference's
      criterion on its stored field, gpu.jl:132-135).
  (c) comparison with the plain reference, the CPU float64 path in the
      same process (see TOLERANCES).
  (d) the tests marked `gpu` (tests/test_gpu.py), in this process.

--four-cards runs, in one process over four GPUs, `--mesh auto` at
gpu-255, which run.py must refuse (no axis of a four-device mesh
divides 255x153x153), then global-view SPMD on a grid that splits,
`--comm shard_map` and `--comm fullstep` on a 4x1x1 mesh, and `fdm`
on the SPMD path, each against the same
schedule on a 1x1x1 mesh (one card): equal iteration counts, and err
within max(1, err) * 1e-5 (__graft_entry__.py's standard). These runs
are float64: in float32 the reported err carries evaluation noise of
~1e-5 that differs with the decomposition, so only float64 can be
held to that standard.

The last line of stdout is {"ok": true, "device": {...}}. Any failed
phase raises, so the script exits non-zero and prints no such line.
Outputs (per-step logs, checkpoints) go to --out.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Phase (c) tolerances.
TOLERANCES = {
    # GPU float64 vs CPU float64, max|a - b| / max|b| per field: the
    # same program on two backends; only summation order and FMA
    # contraction differ. Two cases: two steps from one seeded
    # developed-like state (random_state), every field; and one step
    # from the preset's own start, velocities over vin outside the
    # cells where backtrack! may jump by a cell between the two runs
    # (jump_mask). From that start vy = vz = 0 exactly, which puts the
    # departure points of whole boundary planes on a jump; after a
    # second step the pressure would carry a jump everywhere.
    "f64": 1e-9,
    # GPU float32 vs CPU float64, one step of the gpu preset at nx=63,
    # max|a - b| / vin over the velocities outside the jump cells (as
    # above; in float32 every tiny positive velocity makes one). On the
    # CPU its own float32 step differs from its float64 step there by at
    # most 3.4e-7 vin (pt) and 5.5e-7 vin (fdm), float32 round-off;
    # inside the jump cells by up to 4.9e-3 vin. The bound leaves 20x.
    # A wrong region, BC or sign gives O(1) differences in many cells.
    "f32_velocity_max": 1e-5,
    # advection backends at 255 in float32 against the CPU gather,
    # max|a - b| / max|b|: float32 rounding of an 8-corner lerp vs a
    # (2k+2)^3-term sum.
    "advect_f32": 1e-5,
}


def log(**kw):
    print(json.dumps(kw), flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phase")
    ap.add_argument("--out", default=os.path.join(HERE, ".cache",
                                                  "chip_smoke"),
                    help="directory for step logs and checkpoints")
    return ap.parse_args(argv)


def require_gpu(n):
    """Phase (a). Raises SystemExit unless JAX's default backend is the
    GPU with at least n devices; returns the device summary."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{devs[0].platform!r}); nothing was run")
    if len(devs) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPUs, JAX found "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for line in smi[:n]:
        print(line, flush=True)
    dev = dict(platform=devs[0].platform, kind=devs[0].device_kind,
               count=n)
    log(phase="a", device=dev, nvidia_smi=smi[:n])
    return dev


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_cli(name, argv, out, nt, checkpoint=False):
    """One run.main invocation with a per-step log (and, with checkpoint,
    a checkpoint one step before the end, nt >= 3). Returns (final
    state, per-step records, wall seconds)."""
    from navierstokes3d_tpu.run import main
    d = os.path.join(out, name)
    os.makedirs(d, exist_ok=True)
    logf = os.path.join(d, "steps.jsonl")
    if os.path.exists(logf):
        os.remove(logf)
    t0 = time.perf_counter()
    if checkpoint:
        argv = argv + ["--checkpoint-every", str(nt - 1),
                       "--ckpt-dir", os.path.join(d, "ckpt")]
    state = main(argv + ["--nt", str(nt), "--quiet", "--log-jsonl", logf])
    return state, read_log(logf), time.perf_counter() - t0


def check_run(name, solver, state, recs, wall, ckpt_dir):
    """Convergence, finiteness and the stored-state criterion."""
    import jax
    import numpy as np
    from navierstokes3d_tpu.io import checkpoint
    eps, niter = solver.cfg.numerics.eps_it, solver.grid.niter
    for r in recs:
        if not (r["err"] < eps and r["iters"] < niter):
            raise AssertionError(f"{name}: step {r['it']} did not converge:"
                                 f" {r}")
    for f in ("pr", "vx", "vy", "vz", "c", "dprdtau"):
        if not np.isfinite(np.asarray(getattr(state, f))).all():
            raise AssertionError(f"{name}: non-finite {f}")
    stored = None
    if state.pr_lo is not None:
        before, _ = checkpoint.load_checkpoint(
            checkpoint.latest_checkpoint(ckpt_dir),
            dtype=solver.cfg.numerics.jnp_dtype,
            expect_pressure_split=solver.pressure_split)
        divv = jax.jit(solver.predictor_divv)(before)
        stored = float(jax.jit(solver.stored_residual_err)(state, divv=divv))
        if not stored < eps:
            raise AssertionError(f"{name}: stored pair err {stored} >= "
                                 f"{eps}")
    walls = [r["wall_s"] for r in recs]
    steady = float(np.median(walls[2:])) if len(walls) > 2 else walls[-1]
    log(phase="b", run=name, iters=[r["iters"] for r in recs],
        err=[r["err"] for r in recs], stored_state_err=stored,
        step_wall_s=walls, steady_s_per_step=steady,
        compile_s_estimate=walls[0] + walls[1] - 2 * steady,
        total_wall_s=wall)


def phase_b(out):
    import dataclasses
    import navierstokes3d_tpu as ns
    runs = [  # (name, preset, nx, poisson backend, steps)
        ("gpu255_pt", "gpu", 255, "pt", 5),
        ("gpu255_fdm", "gpu", 255, "fdm", 4),
        ("multi63_pt", "multi", 63, "pt", 5),
    ]
    for name, preset, nx, backend, nt in runs:
        state, recs, wall = run_cli(
            name, ["--preset", preset, "--nx", str(nx), "--dtype",
                   "float32", "--poisson-backend", backend], out, nt,
            checkpoint=True)
        make = ns.preset_gpu if preset == "gpu" else ns.preset_multi
        cfg = make(nx=nx, compat=False, dtype="float32")
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend=backend))
        check_run(name, ns.ChorinSolver(cfg), state, recs, wall,
                  os.path.join(out, name, "ckpt"))


def finite(what, *arrays):
    """Raises unless every array is finite (a NaN would pass any `>`
    tolerance test)."""
    import numpy as np
    for a in arrays:
        if not np.isfinite(np.asarray(a)).all():
            raise AssertionError(f"{what}: non-finite values")


def rel(a, b, floor=1e-300):
    """max|a - b| / max(max|b|, floor); raises on non-finite operands."""
    import numpy as np
    finite("rel", a, b)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def departure_points(vx, vy, vz, dt, dx, dy, dz):
    """backtrack!'s displacements, in float64, for each field advect()
    writes (compat=False), over the cells it writes: per axis the 1-based
    index i and the displacement dl = dt * v / h (the departure point is
    i - dl), with the velocities averaged to the field's points as in
    ops/advect.py. Returns {field: ((ix, dlx), (iy, dly), (iz, dlz))}."""
    import numpy as np
    vx, vy, vz = (np.asarray(v, np.float64) for v in (vx, vy, vz))

    def avg(*a):
        return sum(a) / len(a)

    def pts(vxc, vyc, vzc, starts):
        shape = np.broadcast_shapes(vxc.shape, vyc.shape, vzc.shape)
        idx = np.meshgrid(*(np.arange(s, s + n, dtype=np.float64)
                            for s, n in zip(starts, shape)), indexing="ij")
        return tuple((i, np.broadcast_to(dt * v / h, shape)) for i, v, h in
                     zip(idx, (vxc, vyc, vzc), (dx, dy, dz)))

    return {
        "vx": pts(vx[1:-1],
                  avg(vy[:-1, :-1], vy[:-1, 1:], vy[1:, :-1], vy[1:, 1:]),
                  avg(vz[:-1, :, :-1], vz[:-1, :, 1:], vz[1:, :, :-1],
                      vz[1:, :, 1:]), (2, 1, 1)),
        "vy": pts(avg(vx[:-1, :-1], vx[1:, :-1], vx[:-1, 1:], vx[1:, 1:]),
                  vy[:, 1:-1],
                  avg(vz[:, :-1, :-1], vz[:, :-1, 1:], vz[:, 1:, :-1],
                      vz[:, 1:, 1:]), (1, 2, 1)),
        "vz": pts(avg(vx[:-1, :, :-1], vx[1:, :, :-1], vx[:-1, :, 1:],
                      vx[1:, :, 1:]),
                  avg(vy[:, :-1, :-1], vy[:, 1:, :-1], vy[:, :-1, 1:],
                      vy[:, 1:, 1:]),
                  vz[:, :, 1:-1], (1, 1, 2)),
        "c": pts(avg(vx[:-1], vx[1:]), avg(vy[:, :-1], vy[:, 1:]),
                 avg(vz[:, :, :-1], vz[:, :, 1:]), (1, 1, 1)),
    }


# the cells each field's advection writes (ops/advect.py)
ADVECT_REGION = {"vx": (slice(1, -1),), "vy": (slice(None), slice(1, -1)),
                 "vz": (slice(None), slice(None), slice(1, -1)),
                 "c": ()}


def jump_mask(field, shape, da, db, eps_a, eps_b, eta=1e-6):
    """Cells of `field` (full shape `shape`) where backtrack! may jump by
    a whole cell between two runs, whose displacements da and db come
    from departure_points and whose dtypes have machine epsilons eps_a
    and eps_b. backtrack! takes ix1 = floor(i - dl) and the weight
    t = (dl > 0) - (dl % 1) apart (gpu.jl:290-294), so it is
    discontinuous in two places, and a cell is marked when on some axis
      (clamp) the departure points p = i - dl of the two runs, widened
        by eta, lie on two sides of an integer m <= 1: below the first
        cell floor() is clamped up and t is not; or
      (rounding) in either run dl > 0 lies within a few ulps above an
        integer: i - dl then rounds onto that integer in the run's
        dtype while t stays near 1, and the interpolant samples one
        cell too far. In float32 this is every tiny positive velocity.
    """
    import numpy as np
    jump = np.zeros(da[0][1].shape, bool)
    for (i, a), (_, b) in zip(da, db):
        pa, pb = i - a, i - b
        lo = np.minimum(pa, pb) - eta
        hi = np.minimum(np.maximum(pa, pb) + eta, 1.0)
        jump |= np.floor(hi) >= lo
        for dl, p, eps in ((a, pa, eps_a), (b, pb, eps_b)):
            jump |= (dl > 0) & (dl - np.floor(dl)
                                <= 4 * eps * np.maximum(np.abs(p), 1.0))
    out = np.zeros(shape, bool)
    out[ADVECT_REGION[field]] = jump
    return out


def random_state(cfg, seed=0):
    """A developed-like state from a seed, as host arrays: O(1) random
    velocities keep semi-Lagrangian departure points off backtrack!'s
    floor() discontinuity, which sits at exactly zero velocity (the
    presets' initial vy = vz = 0; tests/test_precision.py uses the same
    construction)."""
    import numpy as np
    import navierstokes3d_tpu as ns
    g = ns.make_grid(cfg)
    rng = np.random.default_rng(seed)
    f = lambda shape, scale: rng.uniform(-scale, scale, shape)
    dpr = np.zeros(g.shape_c)
    dpr[1:-1, 1:-1, 1:-1] = f((g.nx - 2, g.ny - 2, g.nz - 2), 0.1)
    return dict(pr=f(g.shape_c, 50.0), vx=f(g.shape_vx, 0.7),
                vy=f(g.shape_vy, 0.7), vz=f(g.shape_vz, 0.7),
                c=f(g.shape_c, 1.0), dprdtau=dpr)


def steps_on(device, cfg, n, start=None):
    """n step_jit steps of a fresh solver on `device` from init_state()
    or from the host arrays `start`; returns host copies."""
    import jax
    import numpy as np
    import navierstokes3d_tpu as ns
    with jax.default_device(device):
        s = ns.ChorinSolver(cfg)
        if start is None:
            st = s.init_state()
        else:
            st = ns.FlowState(**{k: jax.device_put(
                np.asarray(v, cfg.numerics.dtype), device)
                for k, v in start.items()})
        stats = []
        for _ in range(n):
            st, sts = s.step_jit(st)
            stats.append((int(sts.iters), float(sts.err)))
        fields = {f: np.asarray(getattr(st, f))
                  for f in ("pr", "vx", "vy", "vz", "c")}
    return fields, stats


def pre_advect_on(device, cfg):
    """The first step from init_state() on `device`, split where
    advection starts: returns host arrays ((vx, vy, vz) just before
    advection, (vx, vy, vz) after it), both from one jitted program."""
    import jax
    import numpy as np
    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.ops.advect import advect
    with jax.default_device(device):
        s = ns.ChorinSolver(cfg)
        g = s.grid

        def split_step(st):
            c, vx, vy, vz, divv = s._predict(st)
            pr = s.poisson_solve(st.pr, st.dprdtau, divv)[0]
            c, vx, vy, vz = s._correct(c, vx, vy, vz, pr)
            post = advect(vx, vy, vz, c, g.dt, g.dx, g.dy, g.dz,
                          compat=cfg.compat, method=s.advect_method,
                          k=s.advect_k)
            return (vx, vy, vz), post[:3]

        pre, post = jax.jit(split_step)(s.init_state())
        return ([np.asarray(v) for v in pre], [np.asarray(v) for v in post])


def compare_step(cfg_a, dev_a, cfg_b, dev_b):
    """One step from init_state() of cfg_a on dev_a against cfg_b on
    dev_b. Velocities, |a - b| / vin: the maximum outside the cells
    where backtrack! jumps between the two runs (jump_mask; the
    departure points come from split_step, whose advected velocities
    are reported against step_jit's as prelude_vs_step), and, apart,
    inside them. Returns (report, the maximum outside)."""
    import numpy as np
    import navierstokes3d_tpu as ns
    g = ns.make_grid(cfg_b)
    fa, sa = steps_on(dev_a, cfg_a, 1)
    fb, sb = steps_on(dev_b, cfg_b, 1)
    (pre_a, post_a), (pre_b, _) = (pre_advect_on(dev_a, cfg_a),
                                   pre_advect_on(dev_b, cfg_b))
    pa = departure_points(*pre_a, g.dt, g.dx, g.dy, g.dz)
    pb = departure_points(*pre_b, g.dt, g.dx, g.dy, g.dz)
    eps_a, eps_b = (float(np.finfo(c.numerics.dtype).eps)
                    for c in (cfg_a, cfg_b))
    vin = cfg_b.physics.vin
    rep = dict(stats_a=sa, stats_b=sb, jump_cells={}, max_diff_over_vin={},
               max_diff_jump_cells_over_vin={}, prelude_vs_step={})
    for i, f in enumerate(("vx", "vy", "vz")):
        finite(f"step {f}", fa[f], fb[f], post_a[i])
        d = np.abs(fa[f].astype(np.float64) - fb[f]) / vin
        jump = jump_mask(f, d.shape, pa[f], pb[f], eps_a, eps_b)
        rep["jump_cells"][f] = int(jump.sum())
        rep["max_diff_over_vin"][f] = float(d[~jump].max())
        rep["max_diff_jump_cells_over_vin"][f] = (
            float(d[jump].max()) if jump.any() else 0.0)
        rep["prelude_vs_step"][f] = float(
            np.abs(post_a[i].astype(np.float64) - fa[f]).max() / vin)
    return rep, max(rep["max_diff_over_vin"].values())


def phase_c():
    import dataclasses
    import jax
    import numpy as np
    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.ops.advect import advect
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    jax.config.update("jax_enable_x64", True)
    # (c1) float64 on both backends from one seeded state. nx=30 makes
    # dy = dz = dx exactly; at nx=31 (dy < dx) the reference's dtau rule
    # puts the gpu preset's pseudo-transient iteration outside its
    # stability bound.
    for name, cfg in (("multi30", ns.preset_multi(nx=30, compat=False)),
                      ("gpu30", ns.preset_gpu(nx=30, compat=False))):
        start = random_state(cfg)
        fg, sg = steps_on(gpu, cfg, 2, start)
        fc, sc = steps_on(cpu, cfg, 2, start)
        diffs = {f: rel(fg[f], fc[f]) for f in fg}
        log(phase="c1", case=name, gpu_stats=sg, cpu_stats=sc,
            rel_diff=diffs, tol=TOLERANCES["f64"])
        if [i for i, _ in sg] != [i for i, _ in sc]:
            raise AssertionError(f"c1 {name}: iterations {sg} vs {sc}")
        if not max(diffs.values()) <= TOLERANCES["f64"]:
            raise AssertionError(f"c1 {name}: {diffs}")
        # one step from the preset's own start (vy = vz = 0), where
        # backtrack! jumps: round-off outside the jump cells
        rep, dmax = compare_step(cfg, gpu, cfg, cpu)
        log(phase="c1", case=name + "_preset_start", **rep,
            tol=TOLERANCES["f64"])
        if not dmax <= TOLERANCES["f64"]:
            raise AssertionError(f"c1 {name} preset start: {rep}")
    # (c2) float32 on the GPU vs float64 on the CPU, one step at nx=63
    for backend in ("pt", "fdm"):
        def cfg_of(dtype):
            c = ns.preset_gpu(nx=63, compat=False, dtype=dtype)
            return c.replace(numerics=dataclasses.replace(
                c.numerics, poisson_backend=backend))
        eps = cfg_of("float32").numerics.eps_it
        rep, dmax = compare_step(cfg_of("float32"), gpu,
                                 cfg_of("float64"), cpu)
        log(phase="c2", backend=backend, **rep,
            tol=TOLERANCES["f32_velocity_max"])
        (_, e32), = rep["stats_a"]
        (_, e64), = rep["stats_b"]
        if not (e32 < eps and e64 < eps):
            raise AssertionError(f"c2 {backend}: err {e32} / {e64}")
        if not dmax <= TOLERANCES["f32_velocity_max"]:
            raise AssertionError(f"c2 {backend}: {rep}")
    # (c3) both advection backends on the GPU against the CPU gather at
    # the showcase width, float32, displacements within the k=2 window
    cfg = ns.preset_gpu(nx=255, compat=False, dtype="float32")
    g = ns.make_grid(cfg)
    rng = np.random.default_rng(0)
    vmax = 1.9 * g.dx / g.dt
    host = [rng.uniform(-vmax, vmax, s).astype(np.float32)
            for s in (g.shape_vx, g.shape_vy, g.shape_vz)]
    host.append(rng.uniform(0, 1, g.shape_c).astype(np.float32))

    def run_advect(device, method):
        with jax.default_device(device):
            args = [jax.device_put(a, device) for a in host]
            out = jax.jit(lambda *a: advect(
                *a, g.dt, g.dx, g.dy, g.dz, compat=False, method=method,
                with_stats=True, k=2))(*args)
            return [np.asarray(o) for o in out]

    ref = run_advect(cpu, "gather")
    for method in ("gather", "selectshift"):
        got = run_advect(gpu, method)
        diffs = {f: rel(a, b) for f, a, b in
                 zip(("vx", "vy", "vz", "c"), got[:4], ref[:4])}
        log(phase="c3", method=method, clamped=int(got[4]), rel_diff=diffs,
            tol=TOLERANCES["advect_f32"])
        if int(got[4]) or not max(diffs.values()) <= TOLERANCES["advect_f32"]:
            raise AssertionError(f"c3 {method}: {diffs}")


def phase_d():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_gpu.py")])
    log(phase="d", pytest_exit=int(rc))
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {rc})")


def compare_paths(name, one, four, eps_it=1e-3):
    """Every step converged on both; per-step iteration equality and
    the graft err standard."""
    it1, it4 = [r["iters"] for r in one], [r["iters"] for r in four]
    e1, e4 = [r["err"] for r in one], [r["err"] for r in four]
    ok_err = all(abs(a - b) <= 1e-5 * max(1.0, a, b) for a, b in zip(e1, e4))
    log(phase="four", case=name, iters_1card=it1, iters_4card=it4,
        err_1card=e1, err_4card=e4,
        wall_1card=[r["wall_s"] for r in one],
        wall_4card=[r["wall_s"] for r in four])
    if not all(e < eps_it for e in e1 + e4):
        raise AssertionError(f"{name}: unconverged step: {e1} / {e4}")
    if it1 != it4 or not ok_err:
        raise AssertionError(f"{name}: 1-card {it1} {e1} vs 4-card "
                             f"{it4} {e4}")


def phase_four(out):
    # --mesh auto at the showcase grid: 255 and 153 are odd, so no axis
    # of a four-device mesh divides the grid and run.py refuses it
    try:
        run_cli("gpu255_auto", ["--preset", "gpu", "--nx", "255",
                                "--mesh", "auto"], out, 1)
    except SystemExit as e:
        log(phase="four", case="gpu255_auto", refused=str(e))
    else:
        raise AssertionError("gpu255_auto: a mesh that splits nothing "
                             "was accepted")
    cases = [  # (name, run.py arguments, mesh of the four-card run)
        # global-view SPMD on a grid that splits: 126x76x76 over 2x1x2
        ("gpu126_spmd", ["--preset", "gpu", "--nx", "126"], "2x1x2"),
        ("multi128_shard_map", ["--preset", "multi", "--nx", "128",
                                "--comm", "shard_map"], "4x1x1"),
        ("multi128_fullstep", ["--preset", "multi", "--nx", "128",
                               "--comm", "fullstep"], "4x1x1"),
        # fdm on the SPMD path: auto -> 4x1x1, 120 splits by 4
        ("multi120_fdm", ["--preset", "multi", "--nx", "120",
                          "--poisson-backend", "fdm"], "auto"),
    ]
    for name, argv, mesh4 in cases:
        argv = argv + ["--dtype", "float64"]
        _, one, _ = run_cli(name + "_1card", argv + ["--mesh", "1x1x1"],
                            out, 2)
        _, four, _ = run_cli(name + "_4card", argv + ["--mesh", mesh4],
                             out, 2)
        compare_paths(name, one, four)


def main(argv=None):
    args = parse_args(argv)
    sys.path.insert(0, HERE)
    import navierstokes3d_tpu  # noqa: F401  (fails outside a checkout)
    from navierstokes3d_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    n = 4 if args.four_cards else 1
    device = require_gpu(n)
    if args.four_cards:
        phase_four(args.out)
    else:
        phase_b(args.out)
        phase_c()
        phase_d()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()

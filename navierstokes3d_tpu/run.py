"""CLI driver: the equivalent of the reference's run loops
(runme, NavierStokes3D_gpu.jl:12-173 and run_navierstokes3D,
NavierStokes3D_multi_gpu.jl:287-536), unified over both presets.

Usage:
  python -m navierstokes3d_tpu.run --preset multi --nx 63 --nt 100 \\
      --save --vis --checkpoint-every 50 [--resume] [--dtype float32]

Adds over the reference: structured per-step logging (time/step, Poisson
iters, residual), checkpoint/resume, and a device-mesh option for sharded
execution.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=("multi", "gpu"), default="multi")
    ap.add_argument("--nx", type=int, default=63)
    ap.add_argument("--nt", type=int, default=10,
                    help="TOTAL number of time steps (the reference's "
                         "nt). With --resume, the run continues from "
                         "the checkpoint to this total — re-running an "
                         "interrupted command completes it.")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--compat", action="store_true",
                    help="replicate reference quirks (1-rank semantics; "
                         "multi-rank damp uses global nx, see config.py)")
    ap.add_argument("--vis", action="store_true")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--nvis", type=int, default=10)
    ap.add_argument("--nsave", type=int, default=10)
    ap.add_argument("--out-dir", default="out_save")
    ap.add_argument("--viz-dir", default="viz3D_out")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="device mesh PXxPYxPZ, e.g. 4x1x1, or 'auto' to "
                         "span all visible devices (prefers the x-only "
                         "shape when nx splits evenly; default: 1 "
                         "device)")
    ap.add_argument("--comm", choices=("auto", "shard_map", "fullstep"),
                    default="auto",
                    help="sharded communication backend: 'auto' lets the "
                         "XLA SPMD partitioner insert halo collectives; "
                         "'shard_map' uses the explicit ppermute halo "
                         "exchange Poisson loop (parallel/halo.py); "
                         "'fullstep' runs the ENTIRE step under shard_map "
                         "with owned-face staggered storage "
                         "(parallel/fullstep.py)")
    ap.add_argument("--halo-width", type=int, default=1,
                    help="Poisson iterations batched per halo exchange in "
                         "shard_map mode (temporal blocking)")
    ap.add_argument("--x64", action="store_true",
                    help="enable float64 (required for dtype=float64)")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu for a run "
                         "without the GPU); same as JAX_PLATFORMS")
    ap.add_argument("--distributed", action="store_true",
                    help="call jax.distributed.initialize() for multi-host "
                         "runs (every host runs this same command; the "
                         "cluster must be described by the environment)")
    ap.add_argument("--log-jsonl", default=None,
                    help="append one JSON record per step (it, iters, err, "
                         "wall) to this file")
    ap.add_argument("--on-clamp", choices=("warn", "abort", "gather"),
                    default="warn",
                    help="escalation when a step reports clamped advection "
                         "departure points (the select-shift window k was "
                         "exceeded; the step already computed "
                         "reference-divergent values there): 'warn' keeps "
                         "going, 'abort' exits non-zero, 'gather' switches "
                         "the advection backend to the exact global-clamp "
                         "gather for all subsequent steps")
    ap.add_argument("--abort-on-nan", action="store_true",
                    help="stop the run (after writing a nanstate_*.npz "
                         "snapshot of the offending state — named so "
                         "--resume still picks the last good checkpoint) "
                         "when a step's residual is non-finite; the "
                         "reference only breaks the Poisson loop and "
                         "keeps time-stepping (gpu.jl:135)")
    ap.add_argument("--stall-timeout", type=float, default=0,
                    help="seconds of no progress (no completed host "
                         "sync) before the run hard-exits with code 3 "
                         "(utils.timers.StallWatchdog). A wedged device "
                         "runtime blocks forever inside a device call; "
                         "with checkpoints enabled, a supervisor can "
                         "rerun the SAME command with --resume to "
                         "complete the run. Set well above the first "
                         "sync's JIT compile plus --sync-every steps of "
                         "compute. 0 = off.")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="pipeline N chained steps per host sync (stats "
                         "fetches and per-step policies are processed in "
                         "batches; benchmarks/dispatch_gap_probe.py "
                         "measures the per-sync cost). I/O cadences "
                         "force a sync regardless. NaN-abort/clamp "
                         "escalation react up to N-1 steps late.")
    ap.add_argument("--poisson-backend", choices=("pt", "fdm"),
                    default="pt",
                    help="'pt' is the reference's damped pseudo-transient "
                         "iteration (parity default); 'fdm' is the exact "
                         "fast-diagonalization direct solve + compensated "
                         "refinement (dense matmuls; beyond-reference — "
                         "ops/fdm_poisson.py). stats.iters then counts "
                         "refinement rounds, not PT iterations.")
    ap.add_argument("--animate", action="store_true",
                    help="after the run, assemble the saved viz frames "
                         "into per-field/plane GIFs (viz.make_animation) "
                         "— the reference README's showcase artifacts "
                         "(README.md:58-93). Implies nothing about --vis: "
                         "frames already in --viz-dir are included.")
    ap.add_argument("--quiet", action="store_true")
    return ap


def resolve_auto_comm(comm, mesh_size, mesh_shape, nx, poisson_backend,
                      halo_width, advect_k):
    """Resolve the --comm flag for a device mesh. THE routing rule —
    main() calls this, and tests/test_defaults.py imports it, so the
    tests exercise run.py itself rather than a hand-kept copy
    (VERDICT r4 weak #3).

    Raises SystemExit when --poisson-backend fdm is combined with an
    explicit shard_map/fullstep schedule on a >1-device mesh: those
    schedules build their own PT Poisson loop (explicit ppermute halos)
    and would silently ignore the direct-solve backend; only the
    global-view SPMD path routes through poisson_solve where 'fdm'
    dispatches.
    """
    if (mesh_size > 1 and poisson_backend == "fdm"
            and comm in ("shard_map", "fullstep")):
        raise SystemExit(f"--poisson-backend fdm requires the "
                         f"global-view SPMD path on a multi-device "
                         f"mesh (--comm auto or omit --comm); "
                         f"--comm {comm} runs its own pseudo-"
                         f"transient loop")
    if comm != "auto" or mesh_size <= 1:
        return comm
    if poisson_backend == "fdm":
        # global-view SPMD: the fdm direct solve is jnp einsums the
        # partitioner shards
        return "sharded"
    # On an x-only mesh that splits nx evenly, prefer the full-step
    # schedule (owned-face storage, explicit face-plane halos, ZERO
    # all-gathers — tests/test_defaults.py pins this) when the slabs are
    # thick enough for the advection halo, else the shard_map Poisson
    # loop (which also carries halo_width>1 batching). Non-x-only meshes
    # and uneven x splits stay on the global-view SPMD path, which
    # tolerates both. Which schedule is fastest on four cards is not
    # measured yet (ROADMAP design item 6).
    x_only = mesh_shape[1] == 1 and mesh_shape[2] == 1
    if x_only and nx % mesh_shape[0] == 0:
        bx = nx // mesh_shape[0]
        return ("fullstep" if halo_width == 1 and bx >= advect_k + 2
                else "shard_map")
    return "sharded"


def clamp_escalation(policy, solver, it, n_clamped, rebuild_step):
    """Apply the --on-clamp policy after a step reported clamped
    semi-Lagrangian departure points (ops/advect._backtrack_selectshift
    counts points whose displacement exceeded the window k — there the
    select-shift result differs from the reference's global-bound clamp,
    gpu.jl:290-293). Safety envelope: with the advective CFL constraint
    binding, displacement in cells = CFL_adv*|V|/vin, so k=2 covers
    |V| <= 2*vin/CFL_adv (docs/numerics.md).

    Returns a replacement step function when the policy swaps backends
    (else None); raises SystemExit for 'abort'."""
    if not n_clamped:
        return None
    msg = (f"step {it}: {n_clamped} advection departure points exceeded "
           f"the select-shift window k={solver.advect_k} (safe envelope "
           f"|V| <= {solver.advect_k}*vin/CFL_adv; values there differ "
           "from the reference's gather semantics)")
    if policy == "abort":
        raise SystemExit("ABORT: " + msg)
    print("WARNING: " + msg, file=sys.stderr)
    if policy == "gather" and solver.advect_method != "gather":
        print("on-clamp=gather: switching the advection backend to "
              "'gather' (exact global-clamp semantics) for subsequent "
              "steps", file=sys.stderr)
        solver.advect_method = "gather"
        return rebuild_step()
    return None


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import jax
    from navierstokes3d_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.x64 or args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    if args.distributed:
        jax.distributed.initialize()

    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.io import binio, checkpoint, matio
    if args.vis or args.animate:
        # matplotlib and PIL are needed only for frames and GIFs
        from navierstokes3d_tpu.io import viz
    from navierstokes3d_tpu.utils.timers import RunTimer

    preset = ns.preset_multi if args.preset == "multi" else ns.preset_gpu
    cfg = preset(nx=args.nx, nt=args.nt, compat=args.compat,
                 dtype=args.dtype)
    if args.poisson_backend != "pt":
        import dataclasses
        if args.compat:
            raise SystemExit("--poisson-backend fdm changes the solver "
                             "and cannot compose with --compat")
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend=args.poisson_backend))
    solver = ns.ChorinSolver(cfg)
    g = solver.grid

    mesh = None
    fullstep = False
    comm = args.comm
    if args.mesh:
        from navierstokes3d_tpu.parallel import (choose_mesh_shape,
                                                 make_mesh, shard_state)
        if args.mesh.lower() == "auto":
            shape = choose_mesh_shape(len(jax.devices()), nx=cfg.numerics.nx)
        else:
            shape = tuple(int(p) for p in args.mesh.lower().split("x"))
        # a mesh may use the first prod(shape) of the visible devices
        mesh = make_mesh(shape=shape,
                         devices=jax.devices()[:int(np.prod(shape))])
        from navierstokes3d_tpu.parallel.mesh import AXES, unsharded_axes
        odd = unsharded_axes(mesh, g.shape_c)
        split = [a for a, p in zip(AXES, shape) if p > 1]
        if split and set(split) <= set(odd):
            raise SystemExit(
                f"--mesh {args.mesh}: grid {g.nx}x{g.ny}x{g.nz} splits "
                f"evenly along no axis of mesh {'x'.join(map(str, shape))}"
                f", so every field would be replicated on all {mesh.size}"
                " devices; choose a mesh whose axes divide the grid (or "
                "a grid they divide)")
        if odd and not args.quiet:
            print(f"mesh {'x'.join(map(str, shape))}: grid "
                  f"{g.nx}x{g.ny}x{g.nz} does not split evenly along "
                  f"{', '.join(odd)}; fields stay replicated there",
                  file=sys.stderr)
        was_auto = comm == "auto"
        comm = resolve_auto_comm(
            comm, mesh.size, shape, cfg.numerics.nx,
            cfg.numerics.poisson_backend, args.halo_width,
            solver.advect_k)
        if was_auto and comm != "auto" and not args.quiet:
            if comm == "sharded" and cfg.numerics.poisson_backend == "fdm":
                print("--comm auto -> sharded (global-view SPMD; the "
                      "fdm direct solve is jnp einsums the partitioner "
                      "shards)", file=sys.stderr)
            else:
                print(f"--comm auto -> {comm} on mesh "
                      f"{'x'.join(map(str, shape))}", file=sys.stderr)
        if comm in ("shard_map", "fullstep"):
            from navierstokes3d_tpu.config import ParallelConfig
            solver = ns.ChorinSolver(cfg.replace(parallel=ParallelConfig(
                mesh_shape=shape, halo=args.halo_width)))
            if comm == "fullstep":
                from navierstokes3d_tpu.parallel import fullstep as fsmod
                fullstep = True
        if (mesh is not None and mesh.size > 1
                and args.dtype == "float32" and not args.compat
                and comm == "shard_map" and args.halo_width > 1):
            # the shard_map loop runs plain f32 without the (hi,lo)
            # pair — which the no-split multi variant needs to keep
            # converging once the flow develops (stalls ~1.8e-3 vs eps
            # 1e-3 at nx=63, docs/numerics.md). Surface it rather than
            # burn the budget.
            import warnings as _w
            _w.warn(
                "--comm shard_map with --halo-width > 1 runs the plain "
                "f32 distributed loop (no stored pair); developed-flow "
                "f32 runs may stall above eps_it. Use --comm auto on a "
                "non-x-only mesh (global-view, pair-capable) or "
                "--dtype float64.",
                RuntimeWarning)

    def build_step():
        if mesh is None:
            # jit a fresh closure, not the bound method: equal bound
            # methods share jax's trace cache, so a rebuild after
            # solver.advect_method changed would reuse the stale trace
            return jax.jit(lambda st: solver.step(st), donate_argnums=0)
        if comm == "fullstep":
            return solver.step_fullstep_jit(mesh)
        if comm == "shard_map":
            return solver.step_shard_map_jit(mesh)
        return solver.step_sharded_jit(mesh)

    step = build_step()

    it0 = 0
    if args.resume:
        ck = checkpoint.latest_checkpoint(args.ckpt_dir)
        if ck is not None:
            state, it0 = checkpoint.load_checkpoint(
                ck, dtype=cfg.numerics.jnp_dtype,
                expect_pressure_split=solver.pressure_split)
            if not args.quiet:
                print(f"resumed from {ck} at step {it0}", file=sys.stderr)
        else:
            state = solver.init_state()
    else:
        state = solver.init_state()
    if fullstep:
        state = fsmod.to_dist(state, mesh)
        to_flow = fsmod.from_dist  # gathers for I/O boundaries
    else:
        if mesh is not None:
            state = shard_state(state, mesh)
        to_flow = lambda st: st

    # vis and save run on independent cadences (reference checks %nvis and
    # %nsave separately, gpu.jl:143,168); .bin dumps are frame-indexed while
    # .mat snapshots are keyed by the step number with full-shape fields,
    # exactly as the reference's save_array / matwrite calls do
    # (multi_gpu.jl:515-523; gpu.jl:169). Frame indices derive from the
    # STEP (it // cadence), not a process-local counter: a resumed run
    # continues the original numbering instead of restarting at 0 and
    # overwriting the earlier frames (a counter restart destroyed the
    # steps-0..5000 frames of the round-5 long run on resume).

    def dump_save(it, dstate):
        state = to_flow(dstate)
        c, pr, vx, vy, vz = solver.gather_inner(state)
        binio.save_fields(args.out_dir,
                          it // args.nsave,
                          {"C": c, "Pr": pr, "Vx": vx,
                           "Vy": vy, "Vz": vz})
        matio.save_step_mat(args.out_dir, it,
                            np.asarray(solver.full_pressure(state.pr)),
                            np.asarray(state.vx), np.asarray(state.vy),
                            np.asarray(state.vz), np.asarray(state.c),
                            g.dx, g.dy, g.dz)

    def dump_vis(it, dstate, stats=None):
        ivis = it // args.nvis
        c, pr, vx, vy, vz = solver.gather_inner(to_flow(dstate))
        fields = {"C": c, "Pr": pr, "Vx": vx, "Vy": vy, "Vz": vz}
        viz.save_frame(args.viz_dir, ivis, g, fields, t=it * g.dt)
        if stats is not None:
            hist = np.asarray(stats.err_hist)
            valid = ~np.isnan(hist)
            if valid.any():
                iters_axis = (np.arange(len(hist))[valid] + 1) * g.nchk / g.ny
                viz.save_convergence(args.viz_dir, ivis,
                                     iters_axis, hist[valid])

    if args.save:
        dump_save(it0, state)
    if args.vis:
        dump_vis(it0, state)

    from navierstokes3d_tpu.utils.timers import StepRecord
    timer = RunTimer()
    sync_every = max(1, args.sync_every)
    pending = []  # (it, stats) not yet processed on the host
    # nt is the TOTAL horizon, matching the reference's nt
    # (gpu.jl:44-51): re-running an interrupted command with --resume
    # completes the original run instead of running nt further steps.
    # To extend a finished run, raise --nt past the checkpoint step.
    it_last = args.nt
    if args.resume and it0 >= it_last:
        print(f"checkpoint step {it0} already >= --nt {it_last}; "
              "nothing to do (raise --nt to extend the run)",
              file=sys.stderr)
        return
    watchdog = None
    if args.stall_timeout > 0:
        from navierstokes3d_tpu.utils.timers import StallWatchdog
        watchdog = StallWatchdog(
            args.stall_timeout,
            message=(f"Re-run with --resume to continue from the last "
                     f"checkpoint in {args.ckpt_dir}."
                     if args.checkpoint_every else
                     "No --checkpoint-every was set; progress is lost.")
        ).start()
    t_block = time.time()
    for it in range(it0 + 1, it_last + 1):
        state, stats = step(state)
        # start the scalar D2H fetches before blocking: async copies
        # complete while we wait on the state, so the int()/float()
        # reads below cost no extra round trip
        for a in (stats.iters, stats.err, stats.advect_clamped):
            if a is not None:
                try:
                    a.copy_to_host_async()
                except AttributeError:
                    pass
        pending.append((it, stats))
        # --sync-every N pipelines N chained steps per host round trip;
        # any step with an I/O cadence due syncs regardless.
        # The first step always syncs so its JIT compile time lands in
        # record 1 alone, which summary(skip_first=1) drops — smearing
        # it across a batch would inflate time_per_step_s.
        need_sync = (len(pending) >= sync_every or it == it_last
                     or it == it0 + 1
                     or (args.save and it % args.nsave == 0)
                     or (args.vis and it % args.nvis == 0)
                     or (args.checkpoint_every
                         and it % args.checkpoint_every == 0))
        if not need_sync:
            continue
        jax.block_until_ready(state.pr)
        per_step = (time.time() - t_block) / len(pending)
        for itp, stp in pending:
            rec = StepRecord(it=itp, wall_s=per_step,
                             poisson_iters=int(stp.iters),
                             err=float(stp.err))
            timer.records.append(rec)
            n_clamped = (int(stp.advect_clamped)
                         if stp.advect_clamped is not None else 0)
            if args.log_jsonl:
                with open(args.log_jsonl, "a") as f:
                    f.write(json.dumps(dict(
                        it=itp, iters=rec.poisson_iters, err=rec.err,
                        advect_clamped=n_clamped,
                        wall_s=round(rec.wall_s, 4))) + "\n")
            if not args.quiet:
                print(f"#it = {itp}  iters = {rec.poisson_iters}  "
                      f"err = {rec.err:.3e}  wall = {rec.wall_s:.3f}s",
                      file=sys.stderr)
            if args.abort_on_nan and not np.isfinite(rec.err):
                # The reference only BREAKS the Poisson loop on a
                # non-finite residual and keeps time-stepping into
                # garbage (gpu.jl:135); this stops the run with the
                # state still on disk-able footing (checkpoint below
                # won't run — write one now so the blow-up step is
                # inspectable; with --sync-every > 1 the snapshot is the
                # newest state, up to N-1 steps past the offender). The
                # snapshot name deliberately does NOT match the
                # ckpt_*.npz pattern: latest_checkpoint() must keep
                # resuming from the last GOOD checkpoint, never the
                # poisoned state.
                checkpoint.save_checkpoint(
                    os.path.join(args.ckpt_dir, f"nanstate_{it:07d}.npz"),
                    to_flow(state), it,
                    pressure_split=solver.pressure_split)
                raise SystemExit(
                    f"non-finite residual at step {itp} "
                    f"(err={rec.err!r}); state snapshot written to "
                    f"{args.ckpt_dir}/nanstate_{it:07d}.npz")
            new_step = clamp_escalation(args.on_clamp, solver, itp,
                                        n_clamped, build_step)
            if new_step is not None:
                step = new_step
        pending.clear()
        if args.save and it % args.nsave == 0:
            dump_save(it, state)
        if args.vis and it % args.nvis == 0:
            dump_vis(it, state, stats)
        if args.checkpoint_every and it % args.checkpoint_every == 0:
            checkpoint.save_checkpoint(
                os.path.join(args.ckpt_dir, f"ckpt_{it:07d}.npz"),
                to_flow(state), it, pressure_split=solver.pressure_split)
        if watchdog is not None:
            watchdog.beat()
        t_block = time.time()

    if watchdog is not None:
        watchdog.stop()
    if args.animate:
        import glob
        for field in ("Pr", "C", "Vx", "Vy", "Vz"):
            for plane in ("xy", "xz"):
                if glob.glob(os.path.join(
                        args.viz_dir,
                        f"3D_NavierStokes_{plane}_{field}_*.png")):
                    p = viz.make_animation(args.viz_dir, field, plane)
                    if not args.quiet:
                        print(f"animation: {p}", file=sys.stderr)

    summary = timer.summary()
    print(json.dumps(summary))
    return state


if __name__ == "__main__":
    main()

"""Benchmark: the reference's showcase config (255x153x153 cylinder flow,
NavierStokes3D_gpu.jl:44 / README.md:59) on one GPU.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The reference publishes no performance numbers (BASELINE.md), so
vs_baseline is measured against the HBM roofline of the Poisson hot loop
— the fraction of speed-of-light achieved for the sweeps actually run
(utils/peaks.pt_sweep_bytes: 5 fields per plain sweep, 7 per (hi, lo)
pair sweep; the BC planes and residual checks are amortized).
Diagnostics go to stderr. Exits non-zero when JAX finds no GPU, and
raises when the GPU's kind has no published peak.
"""

import argparse
import json
import sys
import time

import jax
import numpy as np

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.utils.cache import enable_compile_cache
from navierstokes3d_tpu.utils.peaks import peak_hbm_gbps, pt_sweep_bytes


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("gpu", "multi"), default="gpu",
                    help="config preset: 'gpu' is the showcase cylinder "
                         "flow (the headline bench); 'multi' is the "
                         "multi-script's setup (reference nx=63 default)")
    ap.add_argument("--nx", type=int, default=None,
                    help="default: 255 (gpu preset) / 63 (multi)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--backend", choices=("pt", "fdm"), default="pt",
                    help="'pt' (default) benches the reference-parity "
                         "pseudo-transient solve — the headline metric. "
                         "'fdm' benches the beyond-reference direct-"
                         "solve+refinement backend and reports s/step "
                         "with vs_baseline = speedup over a PT run "
                         "timed in the SAME process.")
    args = ap.parse_args()
    enable_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found "
                 f"{jax.default_backend()!r}")
    hbm_gbps = peak_hbm_gbps()  # unknown GPU kind: KeyError, no default

    if args.nx is None:
        args.nx = 255 if args.preset == "gpu" else 63
    make = ns.preset_gpu if args.preset == "gpu" else ns.preset_multi
    cfg = make(nx=args.nx, nt=args.steps, compat=False,
               dtype=args.dtype)
    if args.backend == "fdm":
        import dataclasses
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, poisson_backend="fdm"))
    solver = ns.ChorinSolver(cfg)
    g = solver.grid
    log(f"grid {g.nx}x{g.ny}x{g.nz} dtype={args.dtype} "
        f"device={jax.devices()[0].device_kind} niter={g.niter} nchk={g.nchk}")

    state = solver.init_state()
    t0 = time.time()
    state, stats = solver.step_jit(state)
    jax.block_until_ready(state.pr)
    log(f"warmup step 1 (incl. compile): {time.time()-t0:.1f}s "
        f"iters={int(stats.iters)}")
    # step 2 compiles the steady-state structure: the stored-pressure
    # pair (FlowState.pr_lo) appears after the first step
    t0 = time.time()
    state, stats = solver.step_jit(state)
    jax.block_until_ready(state.pr)
    log(f"warmup step 2 (steady structure): {time.time()-t0:.1f}s "
        f"iters={int(stats.iters)}")

    eps_it = cfg.numerics.eps_it
    total_iters, total_ext, t0 = 0, 0, time.time()
    all_converged = True
    divv_pre = None
    step_stats = []
    for i in range(args.steps):
        if i == args.steps - 1:
            # snapshot the final step's Poisson RHS before the donating
            # step deletes its input: the stored-state criterion below
            # re-evaluates the returned pressure pair against it. Drain
            # the queued steps first (that wait is real step compute and
            # stays in the timed wall); only the snapshot itself is
            # excluded (t0 shifted by its duration).
            jax.block_until_ready(state.pr)
            ts = time.time()
            divv_pre = jax.jit(solver.predictor_divv)(state)
            jax.block_until_ready(divv_pre)
            t0 += time.time() - ts
        state, stats = solver.step_jit(state)
        # Host costs move OUT of the timed window (eager per-step stats
        # reads and a per-step block_until_ready each cost a host round
        # trip, benchmarks/dispatch_gap_probe.py). The steps are CHAINED
        # (each consumes its predecessor's donated state), so
        # free-running them measures exactly the production throughput
        # of `run.py --sync-every N`; the async stat copies overlap
        # compute, and the per-step convergence asserts below run after
        # the window on the same values.
        for a in (stats.iters, stats.iters_ext, stats.err):
            if a is not None:
                a.copy_to_host_async()
        step_stats.append(stats)
    jax.block_until_ready(state.pr)
    wall = time.time() - t0
    for i, stats in enumerate(step_stats):
        total_iters += int(stats.iters)
        it_ext = int(stats.iters_ext) if stats.iters_ext is not None else 0
        total_ext += it_ext
        step_conv = (float(stats.err) < eps_it) and (int(stats.iters) < g.niter)
        all_converged &= step_conv
        log(f"step {i}: iters={int(stats.iters)} (ext={it_ext}) "
            f"err={float(stats.err):.3e} "
            f"{'converged' if step_conv else 'UNCONVERGED'}")
    if np.isnan(np.asarray(state.pr)).any():
        log("ERROR: NaNs in pressure field")
        all_converged = False

    # Stored-state criterion: the reference evaluates convergence on its
    # STORED (Float64) pressure field (gpu.jl:132-135). Re-evaluate the
    # returned (pr, pr_lo) pair against the final step's RHS with the
    # compensated f32 evaluation (f64-grade in pure f32): the STORED
    # state — not just the in-solve iterate — must meet eps_it.
    stored_err = None
    if divv_pre is not None and state.pr_lo is not None:
        stored_err = float(jax.jit(solver.stored_residual_err)(
            state, divv=divv_pre))
        stored_ok = stored_err < eps_it
        log(f"stored-state criterion: err={stored_err:.3e} "
            f"({'meets' if stored_ok else 'FAILS'} eps_it={eps_it})")
        all_converged &= stored_ok
    iters_per_sec = total_iters / wall
    time_per_step = wall / args.steps

    if args.backend == "fdm":
        # vs_baseline for the direct-solve backend is the measured
        # speedup over the reference-parity PT solve, timed in the SAME
        # process right after (in-process A/B on one card). stats.iters
        # counted refinement rounds above, so the headline iters/s
        # metric does not apply here.
        pt_solver = ns.ChorinSolver(make(nx=args.nx, nt=args.steps,
                                         compat=False, dtype=args.dtype))
        pt_state = pt_solver.init_state()
        for k in range(2):
            t0 = time.time()
            pt_state, pt_stats = pt_solver.step_jit(pt_state)
            jax.block_until_ready(pt_state.pr)
            log(f"pt comparator warmup {k}: {time.time()-t0:.1f}s")
        n_pt = max(3, args.steps // 2)
        t0 = time.time()
        for _ in range(n_pt):
            pt_state, pt_stats = pt_solver.step_jit(pt_state)
            for a in (pt_stats.iters, pt_stats.err):
                a.copy_to_host_async()
        jax.block_until_ready(pt_state.pr)
        pt_step = (time.time() - t0) / n_pt
        log(f"pt comparator: {pt_step:.3f}s/step over {n_pt} chained "
            f"steps (converged={float(pt_stats.err) < eps_it})")
        suffix = "_fdm"
        if not all_converged:
            suffix += "_UNCONVERGED"
            log("ERROR: at least one fdm step did not converge")
        print(json.dumps({
            "metric": (f"seconds_per_step_{g.nx}x{g.ny}x{g.nz}_"
                       f"{args.dtype}{suffix}"),
            "value": round(time_per_step, 4),
            "unit": "s/step",
            # measured same-process speedup over the PT parity solve
            "vs_baseline": round(pt_step / time_per_step, 4),
            "pt_seconds_per_step": round(pt_step, 4),
            "all_steps_converged": all_converged,
            "stored_state_err": (None if stored_err is None
                                 else round(stored_err, 9)),
            "device": jax.devices()[0].device_kind,
        }))
        return

    # HBM roofline for the executed sweep mix: with the (hi, lo) pair on
    # (solver.accuracy == 'extended'), iters - iters_ext sweeps ran the
    # pair (7 fields) and iters_ext ran the plain defect-correction
    # finisher (5 fields); without it every sweep is plain.
    itemsize = np.dtype(args.dtype).itemsize
    cells = g.nx * g.ny * g.nz
    total_pair = (total_iters - total_ext
                  if solver.accuracy == "extended" else 0)
    total_plain = total_iters - total_pair
    roofline_wall = (total_pair * pt_sweep_bytes(cells, itemsize, True)
                     + total_plain * pt_sweep_bytes(cells, itemsize, False)
                     ) / (hbm_gbps * 1e9)
    frac = roofline_wall / wall
    log(f"time/step={time_per_step:.3f}s iters/s={iters_per_sec:.0f} "
        f"(pair {total_pair}, plain {total_plain}); "
        f"roofline wall={roofline_wall:.3f}s "
        f"({100*frac:.1f}% of speed-of-light for the executed mix)")

    suffix = ""
    if not all_converged:
        # Fail loudly in the record: an unconverged run must never be
        # mistaken for the headline number (reference criterion:
        # every step exits with err < 1e-3, gpu.jl:132-135).
        suffix += "_UNCONVERGED"
        log("ERROR: at least one step did not converge below eps_it "
            f"({eps_it}) within niter={g.niter}")
    print(json.dumps({
        "metric": (f"poisson_iters_per_sec_{g.nx}x{g.ny}x{g.nz}_"
                   f"{args.dtype}{suffix}"),
        "value": round(iters_per_sec, 1),
        "unit": "iter/s",
        # fraction of HBM speed-of-light for the executed sweep mix
        "vs_baseline": round(frac, 4),
        "time_per_step_s": round(time_per_step, 4),
        "all_steps_converged": all_converged,
        # compensated residual of the returned STORED pressure pair
        # (None when the run's config carries no pair, e.g. f64)
        "stored_state_err": (None if stored_err is None
                             else round(stored_err, 6)),
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
